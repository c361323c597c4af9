"""The study kernels' route and token copy, without a device.

``csrc/prefix_beam_study.cu`` runs K13 (``prefix_beam_fused``) and K12
(``prefix_beam_lanes_stepwise``) with their working set in a block's shared
memory where it fits, else in the block's slice of a device scratch (the
``_wide`` forms).  Here: the rule ``ops/beam_cuda.py::study_fits`` and its
byte counts against the C source's own functions (read as text), and K13's
token copy (each new beam copies its parent's first plen tokens, in 16-byte
vectors, then writes its appended char at plen) emulated in numpy over the
plain frames' pointers at the benchmark scripts' shape, where beams fill L:
it must give the plain search's tokens, with no entry past a beam's length
ever read.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.ops import beam_cuda, build
from pytorch_asr_tpu_torch.scripts import _timing

CHARS = 31


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _c_formulas() -> dict:
    """The C source's byte counts as Python: each `return <expr>;` with the
    casts dropped and / as floor division (every operand is a size)."""
    text = (build.CSRC / "prefix_beam_study.cu").read_text()
    env = {}
    for name in ("frame_bytes", "fused_bytes", "step_bytes"):
        m = re.search(r"inline size_t " + name + r"\(([^)]*)\) \{\s*return (.*?);\s*\}", text,
                      re.S)
        params = [p.split()[-1] for p in m.group(1).split(",")]
        expr = re.sub(r"\(size_t\)", "", m.group(2)).replace("/", "//")
        exec(f"def {name}({', '.join(params)}):\n    return ({expr})\n", env)
    return env


def test_byte_counts_are_the_c_sources():
    c = _c_formulas()
    for K, V, L in [(16, 31, 256), (16, 32, 256), (32, 31, 1024), (32, 1024, 256), (1, 2, 0),
                    (7, 5, 3), (1100, 4, 12), (400, 31, 24)]:
        assert c["frame_bytes"](K, V) == beam_cuda.frame_bytes(K, V)
        assert c["fused_bytes"](K, V, L) == beam_cuda.fused_bytes(K, V, L)
        assert c["step_bytes"](K, V) == beam_cuda.step_bytes(K, V)
        assert beam_cuda.fused_bytes(K, V, L) % 16 == 0 and beam_cuda.step_bytes(K, V) % 16 == 0


@pytest.mark.parametrize("K,V,L,want", [
    (16, CHARS, 256, True),      # K13 at K7's row shape: 40,480 bytes
    (16, 32, 256, True),         # the benchmark scripts' shape
    (32, CHARS, 256, True),
    (32, CHARS, 1024, False),    # token buffers (2, 32, 1024) int32 alone are 256 KB
    (16, CHARS, 1755, True),     # 232,352 bytes: the longest max_len a K13 block takes at K 16
    (16, CHARS, 1756, False),
    (1024, 2, 0, True),          # the most beams a shared form takes
    (1025, 2, 0, False),         # past it the beams loop in a scratch
])
def test_fused_route(K, V, L, want):
    assert beam_cuda.study_fits(K, V, L) is want
    assert (beam_cuda.fused_bytes(K, V, L) <= beam_cuda.MAX_SMEM and K <= 1024) is want


@pytest.mark.parametrize("K,V,want", [
    (16, CHARS, True),           # K12 at K7's row shape: 7,200 bytes
    (16, 32, True),
    (32, 1024, False),           # frame arrays of 431,072 bytes
    (16, 1093, True),            # 232,352 bytes: the widest vocabulary a K12 block takes at K 16
    (16, 1094, False),
    (400, CHARS, True),
    (1025, 2, False),
])
def test_step_route(K, V, want):
    assert beam_cuda.study_fits(K, V) is want
    assert (beam_cuda.step_bytes(K, V) <= beam_cuda.MAX_SMEM and K <= 1024) is want


def test_route_agrees_with_the_bytes_at_every_beam():
    for K in range(1, 1100, 13):
        for V, L in ((CHARS, 256), (32, 1024), (1024, 256)):
            assert beam_cuda.study_fits(K, V, L) == (
                K <= beam_cuda.MAX_BEAM and beam_cuda.fused_bytes(K, V, L) <= beam_cuda.MAX_SMEM)
            assert beam_cuda.study_fits(K, V) == (
                K <= beam_cuda.MAX_BEAM and beam_cuda.step_bytes(K, V) <= beam_cuda.MAX_SMEM)


def _copy_tokens(src: np.ndarray, dst: np.ndarray, par, app, plen, L: int) -> None:
    """csrc/prefix_beam_study.cu::copy_tokens for one utterance, as the
    16-byte form runs it (L a multiple of 4): row r's vectors q with 4 q <
    min(plen + appended, L) come from its parent's row, the appended char
    replacing entry plen; every other entry of dst keeps what it held."""
    for r in range(len(par)):
        n = min(plen[r] + (app[r] >= 0), L)
        m = -(-n // 4) * 4
        dst[r, :m] = src[par[r], :m]
        if app[r] >= 0 and plen[r] < L:
            dst[r, plen[r]] = app[r]


def test_token_copy_to_the_parents_length_gives_the_plain_tokens():
    """K13's copy over the plain frames' pointers at the scripts' shape
    (B 16, T 1000, V 32, K 16, L 256, every best beam full): buffers start
    as garbage (-7, never a token), only the first plen entries of a parent
    (to the 16-byte vector) are copied, and the best row read to its length
    then zeros equals the plain search's tokens."""
    B, T, V, K, L = 16, 1000, 32, 16, 256
    _, logits, lens = _timing.random_logits(B, T, V, torch.device("cpu"))
    logp = torch.log_softmax(logits, -1)
    steps = pb.prefix_beam_stepwise_plain(logp, lens, K, L)
    want = pb.beam_scan_plain(logp, lens, K, L)
    assert int((want[1] == L).sum()) == B
    parents, appends = steps["parent"].numpy(), steps["append"].numpy()
    got = np.zeros((B, L), np.int64)
    for b in range(B):
        tok = np.full((2, K, L), -7, np.int64)
        length = np.zeros(K, np.int64)
        cur = 0
        for t in range(int(lens[b])):
            par, app = parents[b, t], appends[b, t]
            plen = length[par]
            _copy_tokens(tok[cur], tok[cur ^ 1], par, app, plen, L)
            length = plen + (app >= 0)
            cur ^= 1
        best = int(torch.argmax(pb._lse(steps["pb"][b], steps["pnb"][b])))
        assert length[best] == steps["length"][b, best]
        n = min(int(length[best]), L)
        row = tok[cur, best, :n]
        assert (row >= 1).all(), "an entry past a beam's length was read"
        got[b, :n] = row
    np.testing.assert_array_equal(got, want[0].numpy())
