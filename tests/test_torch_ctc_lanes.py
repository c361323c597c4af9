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
