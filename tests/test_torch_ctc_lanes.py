"""K4's routes (``ops/ctc_cuda.py::lane_plan``) and its kernels' frames
(``csrc/ctc_alpha_beta.cu``) emulated in numpy, lane for lane: which thread
holds which lattice state, one frame's exchange (in-lane registers, the
shuffle from lane l-1 or l+1, the warps' edge slots), and the recursions
built from it, held to ``ops/ctc.py``'s plain recursions and, past the
register form, to the JAX package's scan.  No device: the index arithmetic
that no CPU run of the kernels can check."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from pytorch_asr_tpu_torch.ops import ctc, ctc_cuda
from pytorch_asr_tpu_torch.scripts.bench_kernel_turns import ctc_case

NEG = np.float32(ctc.NEG_INF)
# The emulation's float32 exp and log against torch's: a few ulps a frame,
# held as the kernels are (tests/test_torch_kernels_cuda.py).
CTC_RTOL, CTC_ALPHA_ATOL = 1e-5, 1e-4
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plans(S: int) -> list:
    """The register layouts that hold S with the fewest warps, one for each
    states a lane that the C source instantiates (1, 2, 4; at most 32
    warps): the route takes each at some S."""
    out = []
    for k in (1, 2, 4):
        warps = -(-S // (32 * k))
        if warps <= 32:
            out.append(ctc_cuda.LanePlan("lanes", warps, k))
    return out


@pytest.mark.parametrize("S", [1, 2, 3, 31, 33, 481, 4095, 4097, 20001])
def test_the_route_holds_every_state_once(S):
    plan = ctc_cuda.lane_plan(S)
    assert (plan.form == "lanes") == (S <= ctc_cuda.MAX_LANE_STATES)
    for p in [plan, ctc_cuda.wide_plan(S), *_plans(S)]:
        states = ctc_cuda.plan_states(p, S)
        assert states.shape == (32 * p.warps, p.k)
        held = np.sort(states[states >= 0])
        assert np.array_equal(held, np.arange(S)), p
        if p.form == "lanes":
            assert p.k in (1, 2, 4) and 1 <= p.warps <= 32
    if plan.form == "lanes":  # the fewest states a lane, then as few warps as S needs
        assert plan.k == 1 or 32 * 32 * (plan.k // 2) < S
        assert 32 * (plan.warps - 1) * plan.k < S


def test_wide_forces_the_wide_form_which_takes_no_trace():
    assert ctc_cuda.route("ctc_alpha", 481, False, None) == ctc_cuda.lane_plan(481)
    assert ctc_cuda.route("ctc_beta", 481, True, None) == ctc_cuda.wide_plan(481)
    assert ctc_cuda.route("ctc_alpha", 4097, False, None) == ctc_cuda.wide_plan(4097)
    with pytest.raises(ValueError, match="trace"):
        ctc_cuda.route("ctc_beta", 9, True, object())
    with pytest.raises(ValueError, match="trace"):
        ctc_cuda.route("ctc_alpha", 4097, False, object())


# ---------------------------------------------------------------- one frame's exchange

def _regs(row: np.ndarray, plan, S: int, fill=NEG) -> np.ndarray:
    """A lattice row (S,) as the threads' registers (threads, k)."""
    states = ctc_cuda.plan_states(plan, S)
    return np.where(states >= 0, row[np.maximum(states, 0)], fill)


def _row(regs: np.ndarray, plan, S: int) -> np.ndarray:
    states = ctc_cuda.plan_states(plan, S)
    out = np.empty(S, regs.dtype)
    out[states[states >= 0]] = regs[states >= 0]
    return out


def _shfl(v: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_up_sync`` (d > 0) or ``__shfl_down_sync`` (d < 0) by |d| in
    each warp: lane l gets lane l - d; a lane whose source is outside the
    warp keeps its own value."""
    w = v.reshape(-1, 32)
    out = w.copy()
    if d > 0:
        out[:, d:] = w[:, :-d]
    else:
        out[:, :d] = w[:, -d:]
    return out.reshape(-1)


def _edges(regs: np.ndarray, plan, last: bool) -> tuple[np.ndarray, np.ndarray]:
    """Each warp's two edge states as its edge slot holds them: the last
    lane's last two (lanes 31 and 30 at k 1) for the alpha (``last``), the
    first lane's first two (lanes 0 and 1 at k 1) for the beta."""
    lanes = regs.reshape(plan.warps, 32, plan.k)
    if last:
        second = lanes[:, 31, plan.k - 2] if plan.k >= 2 else lanes[:, 30, 0]
        return lanes[:, 31, plan.k - 1], second
    second = lanes[:, 0, 1] if plan.k >= 2 else lanes[:, 1, 0]
    return lanes[:, 0, 0], second


def _at_lane(v: np.ndarray, lane: int, x: np.ndarray) -> np.ndarray:
    """``v`` with each warp's ``lane`` replaced by ``x`` (one a warp)."""
    v = v.reshape(-1, 32).copy()
    v[:, lane] = x
    return v.reshape(-1)


def alpha_exchange(a: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """Each register's s-1 and s-2 as ``ctc_alpha_lanes_kernel`` forms
    them, before the masks: the lane's own registers; lane l-1's by shuffle;
    at a warp's lane 0 the left warp's edge slot (x0, x1), which its lanes
    31 (and 30) wrote and lane 0 alone reads (NEG_INF at warp 0); at k 1
    the s-2 of every lane is lane l-1's s-1, by a second shuffle."""
    k = plan.k
    e0, e1 = _edges(a, plan, last=True)
    x0 = np.concatenate([[NEG], e0[:-1]]).astype(a.dtype)
    x1 = np.concatenate([[NEG], e1[:-1]]).astype(a.dtype)
    up1 = _at_lane(_shfl(a[:, k - 1], 1), 0, x0)
    up2 = _at_lane(_shfl(a[:, k - 2] if k >= 2 else up1, 1), 0, x1)
    s1, s2 = np.empty_like(a), np.empty_like(a)
    s1[:, 0], s1[:, 1:] = up1, a[:, :-1]
    s2[:, 0] = up2
    if k >= 2:
        s2[:, 1], s2[:, 2:] = up1, a[:, :-2]
    return s1, s2


def beta_exchange(term: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """Each register's s+1 and s+2 as ``ctc_beta_lanes_kernel`` forms them:
    the mirror of ``alpha_exchange``, from lane l+1 and, at a warp's lane
    31, the right warp's edge slot (its lanes 0 and 1 wrote it)."""
    k = plan.k
    e0, e1 = _edges(term, plan, last=False)
    x0 = np.concatenate([e0[1:], [NEG]]).astype(term.dtype)
    x1 = np.concatenate([e1[1:], [NEG]]).astype(term.dtype)
    dn1 = _at_lane(_shfl(term[:, 0], -1), 31, x0)
    dn2 = _at_lane(_shfl(term[:, 1] if k >= 2 else dn1, -1), 31, x1)
    s1, s2 = np.empty_like(term), np.empty_like(term)
    s1[:, -1], s1[:, :-1] = dn1, term[:, 1:]
    s2[:, -1] = dn2
    if k >= 2:
        s2[:, -2], s2[:, :-2] = dn1, term[:, 2:]
    return s1, s2


@pytest.mark.parametrize("S", [3, 31, 33, 61, 481, 1041, 4095])
def test_the_exchange_gives_the_shifted_rows(S):
    """A frame's exchange under every plan gives each state the row's
    values at s-1 and s-2 (s+1 and s+2), as ``shift_right``/``shift_left``
    do, wherever the kernel reads them (s-1 >= 0, s-2 >= 0; s+1 < S, s+2 < S)."""
    x = np.random.default_rng(S).standard_normal(S).astype(np.float32)
    xt = torch.from_numpy(x)[None]
    s = np.arange(S)
    for plan in _plans(S):
        states = ctc_cuda.plan_states(plan, S)
        got = [_row(np.where(states >= 0, v, 0), plan, S)
               for v in (*alpha_exchange(_regs(x, plan, S), plan),
                         *beta_exchange(_regs(x, plan, S), plan))]
        for g, want, where in ((got[0], ctc.shift_right(xt, 1), s >= 1),
                               (got[1], ctc.shift_right(xt, 2), s >= 2),
                               (got[2], ctc.shift_left(xt, 1), s + 1 < S),
                               (got[3], ctc.shift_left(xt, 2), s + 2 < S)):
            assert np.array_equal(g[where], want[0].numpy()[where]), plan


# ---------------------------------------------------------------- recursions built from it

def _lse3(a, b, c):
    m = np.maximum(np.maximum(np.maximum(a, b), c), NEG)
    tot = m + np.log(np.exp(a - m) + np.exp(b - m) + np.exp(c - m))
    return np.maximum(tot, NEG).astype(np.float32)


def emulated_alphas(lp: np.ndarray, skip: np.ndarray, length: int, plan) -> np.ndarray:
    """One row's alphas (T, S), the frames in the plan's registers (the
    wide form's rows read back from memory)."""
    T, S = lp.shape
    states = ctc_cuda.plan_states(plan, S)
    sk = _regs(skip & (np.arange(S) >= 2), plan, S, False)
    a = _regs(np.where(np.arange(S) < 2, lp[0], NEG).astype(np.float32), plan, S)
    rows = [_row(a, plan, S)]
    for t in range(1, T):
        if t < length:
            if plan.form == "lanes":
                s1, s2 = alpha_exchange(a, plan)
            else:
                prev = rows[-1]
                s1, s2 = _regs(np.roll(prev, 1), plan, S), _regs(np.roll(prev, 2), plan, S)
            s1 = np.where(states >= 1, s1, NEG)
            s2 = np.where(sk, s2, NEG)
            a = (_lse3(a, s1, s2) + _regs(lp[t], plan, S)).astype(np.float32)
        rows.append(_row(a, plan, S))
    return np.stack(rows)


def emulated_posteriors(lp, alphas, skip_from, beta_T, length, logz, plan) -> np.ndarray:
    """One row's posteriors (T, S): beta_T installed at length - 1, then
    the beta's frames down to 0 from the plan's exchange."""
    T, S = lp.shape
    w = np.zeros((T, S), np.float32)
    if length <= 0:
        return w
    states = ctc_cuda.plan_states(plan, S)
    sk = _regs(skip_from & (np.arange(S) + 2 < S), plan, S, False)
    beta = _regs(beta_T, plan, S)
    for t in range(length - 1, -1, -1):
        if t < length - 1:
            term = (beta + _regs(lp[t + 1], plan, S)).astype(np.float32)
            if plan.form == "lanes":
                s1, s2 = beta_exchange(term, plan)
            else:
                row = _row(term, plan, S)
                s1, s2 = _regs(np.roll(row, -1), plan, S), _regs(np.roll(row, -2), plan, S)
            s1 = np.where((states >= 0) & (states + 1 < S), s1, NEG)
            s2 = np.where(sk, s2, NEG)
            beta = _lse3(term, s1, s2)
        gamma = (_regs(alphas[t], plan, S) + beta - np.float32(logz)).astype(np.float32)
        w[t] = _row(np.exp(np.maximum(gamma, NEG)).astype(np.float32), plan, S)
    return w


def _lattice(case):
    logits, logit_len, labels, label_len = case
    _, lp, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    alphas, final = ctc.alphas_plain(lp, skip, logit_len)
    logz = ctc.terminal_logz(final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (logit_len > 0)
    bargs = (lp, alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, lp.shape[2]),
             torch.where(feasible, logit_len, 0).to(torch.int32), torch.where(feasible, logz, 0.0))
    return lp, skip, logit_len, alphas, bargs


@pytest.mark.parametrize("shape", [(3, 40, 9, 30), (3, 24, 12, 240)])
def test_emulated_frames_give_the_plain_recursions(shape):
    """The recursions built from every plan's exchange, and the wide form's,
    against ``alphas_plain`` and ``posteriors_plain``: an infeasible row, a
    row of no frames, repeats, S 61 and 481 over 1-16 warps."""
    lp, skip, lens, alphas, bargs = _lattice(ctc_case("cpu", *shape))
    w = ctc.posteriors_plain(*bargs)
    T, B, S = lp.shape
    lp_n, skip_n, alphas_n = lp.numpy(), skip.numpy(), alphas.numpy()
    skip_from, beta_T, flens, logz = (a.numpy() for a in bargs[2:])
    for plan in [*_plans(S), ctc_cuda.wide_plan(S)]:
        for b in range(B):
            got = emulated_alphas(lp_n[:, b], skip_n[b], int(lens[b]), plan)
            np.testing.assert_allclose(got, alphas_n[:, b], rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
            got_w = emulated_posteriors(lp_n[:, b], alphas_n[:, b], skip_from[b], beta_T[b],
                                        int(flens[b]), logz[b], plan)
            np.testing.assert_allclose(got_w, w[:, b].numpy(), rtol=CTC_GRAD_RTOL,
                                       atol=CTC_GRAD_ATOL)


def test_the_wide_form_past_the_registers_gives_jaxs_loss():
    """S 4101, past the register form: the route's wide form, emulated,
    gives the JAX scan's loss, and the plain posteriors."""
    case = ctc_case("cpu", 1, 2200, 30, 2050, seed=3)
    lp, skip, lens, alphas, bargs = _lattice(case)
    label_len = case[3]
    S = lp.shape[2]
    plan = ctc_cuda.lane_plan(S)
    assert plan.form == "wide" and S > ctc_cuda.MAX_LANE_STATES
    got = emulated_alphas(lp[:, 0].numpy(), skip[0].numpy(), int(lens[0]), plan)
    logz = ctc.terminal_logz(torch.from_numpy(got[-1])[None], label_len)
    want = np.asarray(jax_ctc_loss(*(jnp.asarray(a.numpy()) for a in case)))
    assert want[0] > 0
    np.testing.assert_allclose(-logz.numpy(), want, rtol=CTC_RTOL)
    got_w = emulated_posteriors(lp[:, 0].numpy(), got, bargs[2][0].numpy(), bargs[3][0].numpy(),
                                int(bargs[4][0]), float(bargs[5][0]), plan)
    np.testing.assert_allclose(got_w, ctc.posteriors_plain(*bargs)[:, 0].numpy(),
                               rtol=CTC_GRAD_RTOL, atol=CTC_GRAD_ATOL)


# ---------------------------------------------------------------- the paired alpha's pair

def _blocks(a: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """Each warp's block of a step as ``ctc_alpha_paired_lanes_kernel``
    fills it: words 0-3 the left warp's last four states, which the lanes
    holding them (``lane k >= 32 k - 4``) write as word ``lane k + i - (32 k
    - 4)``; words 4 .. 7 - k the warp's own first 4 - k states, which the
    lanes holding them write as word ``4 + lane k + i``.  Returns (blocks
    (warps, 8), NaN where no lane writes, and how often each word is
    written)."""
    k, tid = plan.k, np.arange(32 * plan.warps)
    lane, warp = tid % 32, tid // 32
    blocks = np.full((plan.warps, 8), np.nan, a.dtype)
    writes = np.zeros((plan.warps, 8), int)
    for i in range(k):
        pub = (lane * k + i >= 32 * k - 4) & (warp + 1 < plan.warps)
        j = lane * k + i - (32 * k - 4)
        np.add.at(writes, (warp[pub] + 1, j[pub]), 1)
        blocks[warp[pub] + 1, j[pub]] = a[pub, i]
        own = (lane * k + i < 4 - k) & (warp > 0)
        np.add.at(writes, (warp[own], 4 + lane[own] * k + i), 1)
        blocks[warp[own], 4 + lane[own] * k + i] = a[own, i]
    return blocks, writes


def paired_exchange(a: np.ndarray, plan) -> tuple[np.ndarray, list]:
    """Each lane's alpha at s0 - 4 .. s0 - 1 (column 4 - m: s0 - m) as the
    paired kernel forms them: by ``__shfl_up_sync`` by ceil(m / k) lanes of
    register k ceil(m / k) - m, NEG_INF before the lattice at warp 0; in the
    other warps, the lanes with ``lane k < 4`` take all four from words
    lane k .. lane k + 3 of their warp's block.  Also returns the (warp,
    lane, word) reads."""
    k, tid = plan.k, np.arange(32 * plan.warps)
    lane, warp = tid % 32, tid // 32
    blocks, _ = _blocks(a, plan)
    x, reads = np.empty((len(a), 4), a.dtype), []
    for m in range(1, 5):
        c = -(-m // k)
        got = _shfl(a[:, k * c - m], c)
        x[:, 4 - m] = np.where((warp == 0) & (lane * k < m), NEG, got)
    rd = (warp > 0) & (lane * k < 4)
    for j in range(4):
        x[rd, j] = blocks[warp[rd], lane[rd] * k + j]
        reads += [(int(w), int(ln), int(ln) * k + j) for w, ln in zip(warp[rd], lane[rd])]
    return x, reads


@pytest.mark.parametrize("S", [3, 31, 33, 61, 481, 1041, 4095])
def test_the_paired_exchange_gives_the_shifted_rows(S):
    """The pair's exchange under every plan gives each state the row's
    values at s-1 .. s-4, as ``shift_right`` does (NEG_INF before the
    lattice); every block word a reading lane takes is written once a step
    (none is read unwritten), the left warp's four words by that warp; the
    lanes that read (lane k < 4, the kernel's ``__syncwarp`` mask) take
    words 0 .. 7 - k, lane 0 words 0-3, so lane 0's frees, after the others
    have read, free each of the left warp's words once."""
    x = np.random.default_rng(S).standard_normal(S).astype(np.float32)
    xt = torch.from_numpy(x)[None]
    for plan in _plans(S):
        k = plan.k
        states = ctc_cuda.plan_states(plan, S)
        regs = _regs(x, plan, S)
        got, reads = paired_exchange(regs, plan)
        for i in range(k):  # state s0 + i's s - m: its own register, or the window
            s = states[:, i]
            for m in range(1, 5):
                v = regs[:, i - m] if i >= m else got[:, 4 + i - m]
                want = ctc.shift_right(xt, m)[0].numpy()
                assert np.array_equal(v[s >= 0], want[s[s >= 0]]), (plan, i, m)
        blocks, writes = _blocks(regs, plan)
        assert (writes[1:, :8 - k] == 1).all() and not writes[1:, 8 - k:].any(), plan
        assert not writes[0].any()
        assert {ln for _, ln, _ in reads} <= set(range(4 // k)), plan
        for w in range(1, plan.warps):
            assert {j for ww, ln, j in reads if ww == w and ln == 0} == {0, 1, 2, 3}
            assert {j for ww, _, j in reads if ww == w} == set(range(8 - k))


def _lse(*xs):
    """The kernel's lse3 and lse5: where every term lies below the floor,
    the sum of exps is 0, its log -inf, and the floor the result."""
    m = np.maximum(np.maximum.reduce(xs), NEG)
    with np.errstate(divide="ignore"):
        tot = m + np.log(sum(np.exp(x - m) for x in xs))
    return np.maximum(tot, NEG).astype(np.float32)


def _lse2(a, b):
    return (np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))).astype(np.float32)


def emulated_paired_alphas(lp: np.ndarray, skip: np.ndarray, length: int, plan) -> np.ndarray:
    """One row's alphas (T, S) as ``ctc_alpha_paired_lanes_kernel`` forms
    them in the plan's registers: the emissions at s0 - 2 .. s0 + k - 1 of
    frame t and s0 .. of frame t + 1, the weights from them, the pair's
    exchange, the single step a1 at t and the composed step at t + 1."""
    T, S = lp.shape
    k = plan.k
    s = np.arange(32 * plan.warps)[:, None] * k + np.arange(k)[None, :]
    t_end = min(length, T)

    def at(row, d, fill=NEG):  # row[s + d], fill outside the lattice
        idx = s + d
        return np.where((idx >= 0) & (idx < S), row[np.clip(idx, 0, S - 1)], fill)

    k0, k1, k2 = (np.where(at(skip, d, False), np.float32(0), NEG) for d in (0, -1, -2))
    rows = np.empty((T + 1, S), np.float32)
    a = np.full(s.shape, NEG)
    for t in range(0, T, 2):
        p0, p0s1, p0s2 = at(lp[t], 0), at(lp[t], -1), at(lp[t], -2)
        p1 = at(lp[t + 1], 0) if t + 1 < t_end else np.full(s.shape, NEG)
        if t == 0:
            a1 = np.where(s < 2, p0, NEG).astype(np.float32)
            z1 = np.where((s == 1) | (s == 2), p0s1, NEG)
            z2 = np.where((s == 2) | (s == 3), p0s2, NEG)
            a = np.maximum(_lse(a1, z1, z2 + k0) + p1, NEG) if 1 < t_end else a1
        elif t < t_end:
            w1, w2 = _lse2(p0, p0s1), _lse(p0 + k0, p0s1, p0s2 + k0)
            w3, w4 = _lse2(p0s1 + k1, p0s2 + k0), (p0s2 + k0 + k2).astype(np.float32)
            x, _ = paired_exchange(a, plan)
            xm = [np.stack([a[:, i - m] if i >= m else x[:, 4 + i - m] for i in range(k)], 1)
                  for m in range(5)]
            a1 = np.maximum(_lse(xm[0], xm[1], xm[2] + k0) + p0, NEG).astype(np.float32)
            if t + 1 < t_end:
                a = np.maximum(_lse(xm[0] + p0, xm[1] + w1, xm[2] + w2, xm[3] + w3,
                                    xm[4] + w4) + p1, NEG).astype(np.float32)
            else:
                a = a1
        else:
            a1 = a
        rows[t], rows[t + 1] = _row(a1, plan, S), _row(a, plan, S)
    return rows[:T]


@pytest.mark.parametrize("shape, lens", [((6, 91, 9, 30), [91, 0, 1, 2, 3, 90]),
                                         ((3, 24, 12, 240), None)])
def test_emulated_pairs_give_the_plain_paired_recursion(shape, lens):
    """The paired recursion built from every plan's exchange against
    ``alphas_paired_plain``: an odd T, rows of 0, 1, 2 and 3 frames (one
    ending mid-pair), a row ending mid-pair at T - 1, repeats; S 61 and 481
    over 1-16 warps."""
    logits, logit_len, labels, label_len = ctc_case("cpu", *shape)
    if lens is not None:
        logit_len = torch.tensor(lens, dtype=torch.int32)
    _, lp, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    want = ctc.alphas_paired_plain(lp, skip, logit_len)[0].numpy()
    T, B, S = lp.shape
    lp_n, skip_n = lp.numpy(), skip.numpy()
    for plan in _plans(S):
        for b in range(B):
            got = emulated_paired_alphas(lp_n[:, b], skip_n[b], int(logit_len[b]), plan)
            np.testing.assert_allclose(got, want[:, b], rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)


def _edge_ring(warps: int, t_end: int, T: int, ring: int, seed: int) -> int:
    """The paired kernel's edge protocol, its warps interleaved at random:
    after pair q a warp (but the last) puts step q's four words into warp +
    1's block, each once it is free, if the pair at 2 q + 2 recurses; the
    pair at t = 2 q > 0, if t < t_end, waits until those four words of its
    own block carry step q - 1, reads and frees them (a warp's own words,
    which only it writes and reads, in program order, are not modelled).
    Fails on a deadlock or a word read with another step's value; returns
    the steps read."""
    rng = np.random.default_rng(seed)
    slot = {}  # (ring slot, warp, word) -> step, absent when free

    def warp_program(w):
        def publish(q):
            if w + 1 < warps and 2 * q + 2 < t_end:
                for j in range(4):
                    key = (q % ring, w, j)
                    yield lambda: key not in slot
                    slot[key] = q

        yield from publish(0)
        for t in range(2, T, 2):
            if t >= t_end:
                break
            q = t // 2
            if w > 0:
                keys = [((q - 1) % ring, w - 1, j) for j in range(4)]
                yield lambda: all(key in slot for key in keys)
                assert all(slot[key] == q - 1 for key in keys)
                for key in keys:
                    del slot[key]
                reads.append(q)
            yield from publish(q)

    reads = []
    progs = {w: warp_program(w) for w in range(warps)}
    waits = {w: next(p, None) for w, p in progs.items()}
    while any(c is not None for c in waits.values()):
        ready = [w for w, c in waits.items() if c is not None and c()]
        assert ready, f"deadlock: warps {warps}, t_end {t_end}, T {T}"
        w = ready[rng.integers(len(ready))]
        waits[w] = next(progs[w], None)
    assert not slot, "a published word was never read"
    return len(reads)


@pytest.mark.parametrize("warps, T", [(1, 9), (2, 91), (16, 90), (32, 7)])
def test_the_paired_edge_ring_neither_waits_forever_nor_overwrites(warps, T):
    """Every row length from 0 to T (ending at t = 0, mid-pair, after a
    whole pair, at an odd T): no warp waits for a step its left warp does
    not publish, no word is stored again before it is read and freed, and
    every word published is read, over a ring of 4 steps (the kernel's 16:
    the shorter ring lets the wavefront wrap it)."""
    for length in range(T + 1):
        t_end = min(length, T)
        reads = _edge_ring(warps, t_end, T, ring=4, seed=length)
        assert reads == (warps - 1) * len(range(2, t_end, 2))
