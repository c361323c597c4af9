"""K9 on the co-resident grid, what a CPU can check: the launch rule
``ops/beam_cuda.py::rnn_grid_route`` (pure Python), its shared-memory
formula against the C source's, and the grid's LM step emulated in numpy
(each run's CTAs and their units, layer 0's embed table, the state slots
the beams point to, a search CTA's logits) over several frames against the
port's LM step (``models/lm_rnn.py::CharRNNLM.step``) and the plain
search's (``decoding/prefix_beam.py::_advance_lm``).  No device."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, LMState, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, build

SMEM = 232448
SMS = 132
V = 31
# float32 products summed in another order than torch.matmul's.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("A", [0, 8])
def test_route_takes_the_grid_at_config_2(A):
    """Config 2's RNN decode (B 16, K 16, the default LM E 128, H 256 x 2):
    two runs of 64 CTAs of 4 units, each run stepping half of a frame's
    appending beams (~60 a frame), every utterance's search on its own CTA;
    the rule tries two runs first, though one run of 128 CTAs of 2 units
    would fit too."""
    C = A or V
    grid = beam_cuda.rnn_grid_route(16, 16, C, V, 2, 128, 256, SMS)
    assert (grid.ctas, grid.units, grid.per_cta, grid.reps) == (128, 4, 1, 2)
    assert beam_cuda.rnn_grid_smem_bytes(16, 16, C, V, 2, 256, 2, 16, 1) <= SMEM
    assert grid.smem == beam_cuda.rnn_grid_smem_bytes(16, 16, C, V, 2, 256, 4, grid.rows, 1)
    per_row = 4 * 512 + 16 + 4 * grid.units
    assert grid.smem <= SMEM < grid.smem + per_row + 16
    assert 50 <= grid.rows < 16 * 16


@pytest.mark.parametrize("K", [16, 64])
def test_route_leaves_an_lm_of_h512_to_the_block_kernel(K):
    """An LM of H 512 (4 units a CTA in one run: 96 KB of columns, w_out 62
    KB) leaves fewer than K rows of staging: the block kernel runs it (the
    wide phase's beam 64, and beam 16)."""
    assert beam_cuda.rnn_grid_route(16, K, V, V, 2, 128, 512, SMS) is None
    assert beam_cuda.rnn_grid_smem_bytes(16, K, V, V, 2, 512, 4, K, 1) > SMEM


@pytest.mark.parametrize("B,per_cta", [(128, 1), (129, 2), (256, 2), (1000, 8)])
def test_route_past_the_grid_gives_a_cta_more_searches(B, per_cta):
    grid = beam_cuda.rnn_grid_route(B, 16, V, V, 2, 128, 256, SMS)
    assert grid.ctas == 128 and grid.per_cta == per_cta
    assert grid.ctas * grid.per_cta >= B > grid.ctas * (grid.per_cta - 1)
    assert 16 <= grid.rows <= B * 16 and grid.smem <= SMEM


def test_route_refuses_what_no_cta_holds():
    # 2000 utterances: 16 searches a CTA pass its shared memory.
    assert beam_cuda.rnn_grid_route(2000, 16, V, V, 2, 128, 256, SMS) is None
    # Any number of layers by the same fit rule: 9 of H 256 fit one run of
    # 2 units a CTA, 10 pass a CTA (the block kernel takes them); none is no LM.
    grid = beam_cuda.rnn_grid_route(16, 16, V, V, 9, 128, 256, SMS)
    assert (grid.reps, grid.units, grid.ctas) == (1, 2, 128) and grid.smem <= SMEM
    assert beam_cuda.rnn_grid_route(16, 16, V, V, 10, 128, 256, SMS) is None
    assert beam_cuda.rnn_grid_route(16, 16, V, V, 0, 128, 256, SMS) is None


@pytest.mark.parametrize("sms,reps,units,ctas", [(66, 2, 8, 64), (100, 2, 6, 86),
                                                 (40, 1, 7, 37), (16, 1, 16, 16)])
def test_route_with_fewer_sms(sms, reps, units, ctas):
    """Fewer SMs give each CTA more units: at 66 SMs two runs of 32 CTAs of
    8 units, at 100 two of 43 of 6; at 40 two runs' 13 units a CTA leave
    too few rows, and one run of 37 CTAs of 7 units runs; at 16 SMs 16
    units' columns (192 KB) leave too few rows, and the block kernel runs."""
    grid = beam_cuda.rnn_grid_route(16, 16, V, V, 2, 128, 256, sms)
    if sms == 16:
        assert grid is None
        return
    assert (grid.units, grid.ctas, grid.reps) == (units, ctas, reps) and grid.ctas <= sms
    cpr = ctas // reps
    owned = [range(j * units, min((j + 1) * units, 256)) for j in range(cpr)]
    assert sorted(k for us in owned for k in us) == list(range(256))


@pytest.mark.parametrize("H,nl", [(32, 1), (256, 2), (384, 3), (640, 2)])
def test_route_is_the_grid_exactly_where_it_fits(H, nl):
    """Across beams, batches and lanes the route is the first number of runs
    (2, then 1) whose CTA with K staged rows fits, with as many rows as fit;
    None where neither does."""
    for K in (1, 4, 16, 32, 64, 128):
        for B in (1, 16, 200):
            for C in (4, V):
                grid = beam_cuda.rnn_grid_route(B, K, C, V, nl, 128, H, SMS)
                want = None
                for R in (2, 1):
                    units = -(-H // (SMS // R))
                    per_cta = -(-B // (R * -(-H // units)))
                    if beam_cuda.rnn_grid_smem_bytes(B, K, C, V, nl, H, units, K,
                                                     per_cta) <= SMEM:
                        want = (R, units, per_cta)
                        break
                assert (grid and (grid.reps, grid.units, grid.per_cta)) == want, (K, B, C)
                if grid is not None:
                    assert grid.rows == B * K or beam_cuda.rnn_grid_smem_bytes(
                        B, K, C, V, nl, H, grid.units, grid.rows + 1, grid.per_cta) > SMEM


def _c_formulas() -> dict:
    """The C source's shared-memory functions of the grid, as Python: each
    `return <expr>;` with the casts dropped and / as floor division (every
    operand is a non-negative size)."""
    text = (build.CSRC / "prefix_beam.cu").read_text()
    env = {}
    for name in ("search_smem_bytes", "lm_smem_offset", "grid_row_floats", "grid_fixed_floats",
                 "grid_utt_bytes", "grid_shared_bytes", "rnn_grid_smem_bytes"):
        m = re.search(r"inline size_t " + name + r"\(([^)]*)\) \{\s*return (.*?);\s*\}", text,
                      re.S)
        params = [p.split()[-1] for p in m.group(1).split(",")]
        expr = re.sub(r"\(size_t\)", "", m.group(2)).replace("/", "//")
        exec(f"def {name}({', '.join(params)}):\n    return ({expr})\n", env)
    return env


def test_smem_formula_is_the_c_sources():
    c = _c_formulas()
    for B, K, C, nl, H, units, rows, per_cta in [
            (16, 16, 31, 2, 256, 2, 73, 1), (129, 16, 8, 2, 256, 2, 66, 2),
            (3, 8, 31, 1, 32, 1, 24, 1), (5, 7, 5, 3, 30, 3, 9, 2), (1, 1, 1, 1, 1, 1, 1, 1),
            (16, 64, 31, 2, 512, 4, 64, 1), (2000, 16, 31, 8, 1000, 8, 16, 16)]:
        assert c["rnn_grid_smem_bytes"](B, K, C, V, nl, H, units, rows, per_cta) == \
            beam_cuda.rnn_grid_smem_bytes(B, K, C, V, nl, H, units, rows, per_cta)
        assert c["search_smem_bytes"](K, C, V) == beam_cuda.smem_bytes(K, C, V)


# ------------------------------------------------ the grid's LM step, in numpy


def _lm(nl: int, E: int = 12, H: int = 20, seed: int = 3) -> CharRNNLM:
    lm = CharRNNLM(RNNLMConfig(embed_dim=E, hidden_dim=H, num_layers=nl), V, seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lm.parameters():
            p.mul_(2.0).add_(0.2 * torch.randn(p.shape, generator=g))
    return lm.eval()


def _sig(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def grid_frame(lm: CharRNNLM, hs, cs, lmps, sid, parent, append, active, sms: int):
    """One frame's LM step as the grid computes it, in float32 numpy, on the
    state slots: hs, cs (nl, B, 2K, H) and lmps (B, 2K, V) are every slot's
    state and log-prob row, sid (B, K) each beam's slot.  A beam that did
    not append takes its parent's slot; each appending beam, in order, the
    next slot that no beam of the frame before holds.  The rows are split
    between ``rnn_grid_route``'s runs as the kernel splits them; CTA j of a
    run owns units [j units, (j + 1) units), layer 0's input part of its
    gate columns a row of its (V, 4 units) table embed wx0.  The new state
    and log-probs are written into the new slots in place, reading the
    parents' slots, as the kernel does.  parent/append (B, K), active (B,)
    -> the new sid (the old one on a row past its length)."""
    nl, B, S2, H = hs.shape
    K = S2 // 2
    w = {n: p.detach().numpy().astype(np.float32) for n, p in lm.named_parameters()}
    grid = beam_cuda.rnn_grid_route(B, K, V, V, nl, lm.cfg.embed_dim, H, sms)
    units, cpr = grid.units, grid.ctas // grid.reps   # every run splits H alike
    new_sid = sid.copy()
    rows = []
    for b in range(B):
        if not active[b]:
            continue
        free = [sl for sl in range(S2) if sl not in set(sid[b].tolist())]
        for r in range(K):
            if append[b, r] < 0:
                new_sid[b, r] = sid[b, parent[b, r]]
            else:
                new_sid[b, r] = free.pop(0)
                rows.append((b, new_sid[b, r], sid[b, parent[b, r]], append[b, r]))
    shares = [rows[len(rows) * q // grid.reps: len(rows) * (q + 1) // grid.reps]
              for q in range(grid.reps)]
    for l in range(nl):
        for share in shares:
            for j in range(cpr):
                ks = np.arange(j * units, min((j + 1) * units, H))
                cols = np.concatenate([g * H + ks for g in range(4)])
                wx, wh = w[f"lstm{l}_wx"][:, cols], w[f"lstm{l}_wh"][:, cols]
                bias = w[f"lstm{l}_b"][cols]
                ex = w["embed"] @ wx if l == 0 else None     # the CTA's (V, 4 units) table
                for b, new, par, ch in share:
                    if l == 0:
                        gates = ex[ch] + hs[0, b, par] @ wh
                    else:
                        x = np.concatenate([hs[l - 1, b, new], hs[l, b, par]])
                        gates = x @ np.concatenate([wx, wh])
                    gi, gf, gg, go = np.split(gates + bias, 4)
                    c_new = (_sig(gf + np.float32(1)) * cs[l, b, par, ks]
                             + _sig(gi) * np.tanh(gg))
                    cs[l, b, new, ks] = c_new
                    hs[l, b, new, ks] = _sig(go) * np.tanh(c_new)
    for b, new, _, _ in rows:
        logits = hs[nl - 1, b, new] @ w["w_out"] + w["b_out"]
        lmps[b, new] = logits - (logits.max() + np.log(np.exp(logits - logits.max()).sum()))
    return new_sid


def _beams(hs, cs, lmps, sid):
    """Each beam's (h, c (nl, B, K, H), logp (B, K, V)) through its slot."""
    b = np.arange(sid.shape[0])[:, None]
    return hs[:, b, sid], cs[:, b, sid], lmps[b, sid]


def _slots(nl: int, B: int, K: int, H: int, seed: int):
    """Random states in 2K slots, the beams on K of them, some shared."""
    rng = np.random.default_rng(seed)
    hs = np.tanh(rng.standard_normal((nl, B, 2 * K, H))).astype(np.float32)
    cs = rng.standard_normal((nl, B, 2 * K, H)).astype(np.float32)
    logits = rng.standard_normal((B, 2 * K, V)).astype(np.float32)
    lmps = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    sid = rng.integers(0, 2 * K, size=(B, K))
    return hs, cs, lmps, sid, rng


def _picks(rng, B: int, K: int):
    parent = rng.integers(0, K, size=(B, K)).astype(np.int64)
    append = np.where(rng.random((B, K)) < 0.4, rng.integers(1, V, size=(B, K)), -1)
    return parent, append


@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("sms", [SMS, 6])
def test_grid_step_equals_the_plain_searchs(nl, sms):
    """Six frames of the grid's step on its slots (one unit a CTA in each of
    two runs at 132 SMs; at 6 SMs runs of 3 SMs of 7 units a CTA, the last
    CTA 6 of them) held against ``_advance_lm`` on every beam's own copy:
    every beam of an active row, appending or not, frame after frame, so a
    slot reused while a beam still held it would show; a row past its
    length keeps its state."""
    B, K, H = 3, 6, 20
    lm = _lm(nl, H=H)
    hs, cs, lmps, sid, rng = _slots(nl, B, K, H, seed=nl + sms)
    carry = pb.LMCarry(*(torch.from_numpy(x.copy()) for x in _beams(hs, cs, lmps, sid)))
    n_t = np.array([6, 3, 0])
    for t in range(6):
        parent, append = _picks(rng, B, K)
        active = t < n_t
        sid = grid_frame(lm, hs, cs, lmps, sid, parent, append, active, sms)
        with torch.no_grad():
            carry = pb._advance_lm(lm, carry, torch.from_numpy(parent),
                                   torch.from_numpy(append), torch.from_numpy(active))
        for g, w_ in zip(_beams(hs, cs, lmps, sid), carry):
            np.testing.assert_allclose(g, w_.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("nl", [1, 2, 3])
def test_grid_step_rows_equal_charrnnlm_step(nl):
    """Each appending row's new state and log-probs are ``CharRNNLM.step``
    from its parent's state with its char, in a slot no beam of the frame
    before held."""
    B, K, H = 2, 5, 20
    lm = _lm(nl, H=H)
    hs, cs, lmps, sid, rng = _slots(nl, B, K, H, seed=10 + nl)
    parent, append = _picks(rng, B, K)
    h, c, _ = (x.copy() for x in _beams(hs, cs, lmps, sid))
    new_sid = grid_frame(lm, hs, cs, lmps, sid, parent, append, np.ones(B, bool), 7)
    nh, nc, nlogp = _beams(hs, cs, lmps, new_sid)
    for b in range(B):
        for r in range(K):
            if append[b, r] < 0:
                assert new_sid[b, r] == sid[b, parent[b, r]]
                continue
            assert new_sid[b, r] not in sid[b] and (new_sid[b] == new_sid[b, r]).sum() == 1
            p = parent[b, r]
            state = LMState(torch.from_numpy(h[:, b, p][:, None].copy()),
                            torch.from_numpy(c[:, b, p][:, None].copy()))
            with torch.no_grad():
                logits, st = lm.step(torch.tensor([append[b, r]]), state)
            np.testing.assert_allclose(nh[:, b, r], st.h[:, 0].numpy(), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
            np.testing.assert_allclose(nc[:, b, r], st.c[:, 0].numpy(), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
            np.testing.assert_allclose(nlogp[b, r], torch.log_softmax(logits[0], -1).numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
