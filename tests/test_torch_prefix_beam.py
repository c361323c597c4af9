"""The port's plain prefix beam search against the JAX package's: its
``lax.scan`` (``prefix_beam_search(use_fused=False)``) and its lane kernels
K7 ``prefix_beam_fused_lanes`` and K8 ``prefix_beam_fused_lanes_topa`` in
interpret mode, on the same numpy-seeded logits and tables.

Tokens and lengths must be equal, scores within SCORE_RTOL.  On the CPU the
port takes its plain search; the card's kernel is held to the same plain
search in ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.decoding.prefix_beam import prefix_beam_search as jax_search
from pytorch_asr_tpu.ops import runtime as jax_runtime
from pytorch_asr_tpu.ops.beam_pallas import (prefix_beam_fused_lanes,
                                             prefix_beam_fused_lanes_topa)
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.decoding.prefix_beam_ref import prefix_beam_search_ref
from pytorch_asr_tpu_torch.ops import beam_cuda, build

# float32 log-space sums: XLA's and torch's exp/log1p round apart (a few
# ulp), and the JAX restricted scan associates the fusion term differently.
SCORE_RTOL = 1e-5
B, T, V, K, L = 3, 14, 7, 4, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, n_ctx=0, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T, V)) * scale).astype(np.float32)
    lens = np.array([T, T - 5, T // 2], np.int32)
    tab = None
    if n_ctx:
        t = rng.standard_normal((n_ctx, V)).astype(np.float32)
        tab = t - np.log(np.exp(t).sum(1, keepdims=True))
    return logits, lens, tab


def _kw(tab, A=0, K=K, L=L):
    lm = tab is not None
    return dict(beam_size=K, max_len=L, ext_top_a=A, lm_alpha=0.5 if lm else 0.0,
                lm_beta=1.0 if lm else 0.0)


def _port(logits, lens, tab=None, **kw):
    out = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                lm_table=None if tab is None else torch.from_numpy(tab), **kw)
    return [o.numpy() for o in out]


def _jax_scan(logits, lens, tab=None, **kw):
    return jax_search(jnp.asarray(logits), jnp.asarray(lens), use_fused=False,
                      lm_table=None if tab is None else jnp.asarray(tab), **kw)


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    np.testing.assert_allclose(ours[2], np.asarray(ref[2]), rtol=SCORE_RTOL)


@pytest.fixture
def interpret():
    jax_runtime.force_interpret(True)
    yield
    jax_runtime.force_interpret(None)


# (ext_top_a, table contexts as a power of V): no LM, dense at n_ctx V and
# V^2, top-A 2 and 4 with and without a table.
CASES = [(0, 0), (0, 1), (0, 2), (2, 0), (4, 0), (2, 1), (4, 2)]
# The interpreter runs the lane kernels op by op in Python (6-8 s a call):
# two rows of 10 frames (two of their 8-frame chunks), four of the cases.
KERNEL_CASES = [(0, 0), (0, 2), (2, 0), (4, 1)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("A,ctx_pow", CASES)
def test_plain_matches_jax_scan(seed, A, ctx_pow):
    logits, lens, tab = _case(seed, V ** ctx_pow if ctx_pow else 0)
    kw = _kw(tab, A)
    _assert_same(_port(logits, lens, tab, **kw), _jax_scan(logits, lens, tab, **kw))


@pytest.mark.parametrize("A,ctx_pow", KERNEL_CASES)
def test_plain_matches_jax_lane_kernels(interpret, A, ctx_pow):
    logits, lens, tab = _case(5, V ** ctx_pow if ctx_pow else 0)
    logits, lens = logits[:2, :10], np.array([10, 7], np.int32)
    kw = _kw(tab, A)
    lm = dict(lm_table=None if tab is None else jnp.asarray(tab), lm_alpha=kw["lm_alpha"],
              lm_beta=kw["lm_beta"])
    if A:
        ref = prefix_beam_fused_lanes_topa(jnp.asarray(logits), jnp.asarray(lens),
                                           beam_size=K, max_len=L, top_a=A, **lm)
    else:
        ref = prefix_beam_fused_lanes(jnp.asarray(logits), jnp.asarray(lens), beam_size=K,
                                      max_len=L, **lm)
    _assert_same(_port(logits, lens, tab, **kw), ref)


@pytest.mark.parametrize("seed", [2, 3])
def test_plain_matches_host_oracle(seed):
    """Tokens against the slow-Python oracle (the port's copy of the JAX
    package's; no sentinels, no hashes: prefixes are tuples), one row at a
    time."""
    logits, lens, _ = _case(seed)
    toks, n, _ = _port(logits, lens, None, beam_size=8, max_len=T + 1)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    for b in range(B):
        assert list(toks[b, : n[b]]) == prefix_beam_search_ref(logp[b], int(lens[b]), 8)


@pytest.mark.parametrize("A", [V, V + 3])
def test_ext_top_a_at_least_vocab_is_the_unrestricted_search(A):
    logits, lens, tab = _case(4, V)
    ref = _port(logits, lens, tab, **_kw(tab))
    got = _port(logits, lens, tab, **_kw(tab, A))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_blank_dominated_gives_empty():
    logits = np.full((1, 12, V), -8.0, np.float32)
    logits[..., 0] = 6.0
    toks, n, score = _port(logits, np.array([12], np.int32), **_kw(None))
    assert n[0] == 0 and not toks.any() and np.isfinite(score[0])


@pytest.mark.parametrize("A", [0, 3])
def test_peaky_decodes_the_greedy_sequence(A):
    rng = np.random.default_rng(3)
    path = rng.integers(0, 5, T)
    logits = np.full((1, T, V), -10.0, np.float32)
    logits[0, np.arange(T), path] = 8.0
    lens = np.array([T], np.int32)
    toks, n, _ = _port(logits, lens, **_kw(None, A, L=T))
    ids, gn = greedy_ctc(torch.from_numpy(logits), torch.from_numpy(lens))
    assert n[0] == gn[0] > 0
    np.testing.assert_array_equal(toks[0, : n[0]], ids[0, : gn[0]].numpy())


@pytest.mark.parametrize("A,ctx_pow", [(0, 0), (0, 2), (3, 1)])
def test_zero_length_row_is_empty_with_score_zero(A, ctx_pow):
    logits, _, tab = _case(6, V ** ctx_pow if ctx_pow else 0)
    lens = np.array([T, 0, 3], np.int32)
    ours = _port(logits, lens, tab, **_kw(tab, A))
    assert ours[1][1] == 0 and not ours[0][1].any() and ours[2][1] == 0.0
    _assert_same(ours, _jax_scan(logits, lens, tab, **_kw(tab, A)))


@pytest.mark.parametrize("A", [0, 4])
def test_max_len_saturates(A):
    """Rows that would decode more than max_len chars stop at max_len."""
    rng = np.random.default_rng(8)
    logits = np.full((B, T, V), -6.0, np.float32)
    for b in range(B):
        logits[b, np.arange(T), rng.integers(1, V, T)] = 5.0
        logits[b, 1::2, 0] = 5.0                    # blanks between: every char counts
    lens = np.array([T, T, 5], np.int32)
    kw = _kw(None, A, L=3)
    ours = _port(logits, lens, **kw)
    assert ours[1].tolist() == [3, 3, 3]
    _assert_same(ours, _jax_scan(logits, lens, **kw))


@pytest.mark.parametrize("A", [0, 2])
def test_duplicate_prefixes_are_absorbed(A):
    """Two frames over (blank, a, b): the prefix "a" is reached by aa, a-, -a;
    the absorb merges the extension of "" by a into the stay of "a", so the
    best score is the log of all three paths' mass."""
    logp = np.log(np.array([[[0.3, 0.6, 0.1], [0.2, 0.7, 0.1]]], np.float64))
    toks, n, score = _port(logp.astype(np.float32), np.array([2], np.int32),
                           beam_size=4, max_len=4, ext_top_a=A)
    p = np.exp(logp[0])
    want = np.log(p[0, 1] * p[1, 1] + p[0, 1] * p[1, 0] + p[0, 0] * p[1, 1])
    assert n[0] == 1 and toks[0, 0] == 1
    np.testing.assert_allclose(score[0], want, rtol=1e-6)


@pytest.mark.parametrize("A,ctx_pow", [(0, 0), (3, 0), (0, 1)])
def test_ties_go_to_the_lower_index(A, ctx_pow):
    """Chars 2 and 5 tie at every frame, so every prefix ties exactly with
    its mirror (2 and 5 swapped: the same operations on the same values):
    the top-K, the top-A and the final argmax must take the lower index
    first, as lax.top_k and jnp.argmax do, so the best prefix starts with 2."""
    logits = np.zeros((2, 9, V), np.float32)
    logits[:, :, [2, 5]] = 3.0
    logits[:, 1::3, 0] = 3.5
    tab = np.full((V, V), -np.log(V), np.float32) if ctx_pow else None
    lens = np.array([9, 6], np.int32)
    kw = _kw(tab, A)
    ours = _port(logits, lens, tab, **kw)
    assert ours[1].min() > 0 and (ours[0][:, 0] == 2).all()
    _assert_same(ours, _jax_scan(logits, lens, tab, **kw))


def test_hashes_wrap_like_int32():
    h = np.array([2 ** 31 - 5, -(2 ** 31) + 3, -7, 123456789], np.int32)
    with np.errstate(over="ignore"):
        want = h * np.int32(pb.HASH_MULT) + np.int32(5)
    got = pb._wrap32(torch.from_numpy(h).long() * pb.HASH_MULT + 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_search_without_launches():
    logits, lens, tab = _case(7, V)
    build.reset_launches()
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    got = beam_cuda.prefix_beam(logp, torch.from_numpy(lens), K, L, torch.from_numpy(tab),
                                0.5, 1.0)
    want = pb.beam_scan_plain(logp, torch.from_numpy(lens), K, L, torch.from_numpy(tab),
                              0.5, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert build.LAUNCHES["prefix_beam"] == build.LAUNCHES["prefix_beam_topa"] == 0


@pytest.mark.parametrize("kwargs,err", [
    ({"hash_lm": object()}, TypeError),
    ({"rnn_lm": object(), "hash_lm": object(), "lm_top_k": 4}, ValueError),
    ({"hash_lm": object(), "lm_top_k": 4}, TypeError), ({"blank": 3}, ValueError)])
def test_sources_of_later_slices_raise(kwargs, err):
    """The hashed backend is ported (tests/test_torch_prefix_beam_hashed.py):
    what is not a ``HashedNgramLM`` is refused, with or without ``lm_top_k``,
    and so is a second fusion source beside it (``lm_top_k`` alone changes
    nothing: tests/test_torch_prefix_beam_sharded.py)."""
    logits, lens, _ = _case(0)
    with pytest.raises(err):
        pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens), **kwargs)


def test_top_a_breaks_ties_to_the_lower_id():
    logp = torch.tensor([[[0.0, -1.0, -1.0, -0.5, -1.0]]])
    vals, ids = pb.top_a(logp, 3)
    assert ids.tolist() == [[[0, 3, 1]]] and ids.dtype == torch.int32
    assert vals.tolist() == [[[0.0, -0.5, -1.0]]]
