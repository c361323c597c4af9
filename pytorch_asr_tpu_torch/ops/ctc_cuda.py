"""CTC loss on the card: the K4 kernels ``csrc/ctc_alpha_beta.cu`` behind
``ops/ctc.py``'s autograd function.

Counterpart of ``pytorch_asr_tpu/ops/ctc_pallas.py::ctc_loss_auto``.  Each
wrapper takes its plain PyTorch version (``ops/ctc.py``) for CPU tensors and
launches its kernel for CUDA tensors; there is no other switch and no
fallback.  ``PAIRED_FWD``, as the JAX module's switch of the same name, makes
the alpha recursion take two frames an iteration (``ctc_alpha_paired``); no
path sets it, it is the measured alternative.

The route of all three is ``lane_plan(S)``, a pure function of the lattice's
states: the register form (a block of ``warps`` warps an utterance, ``k``
consecutive states a lane) up to ``MAX_LANE_STATES``, and past it the wide
form (the lattice rows in device memory), counted apart as
``ctc_alpha_wide``, ``ctc_beta_wide`` and ``ctc_alpha_paired_wide``.  Each
wrapper's ``wide`` forces the wide form where the register form would run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pytorch_asr_tpu_torch.ops import build, ctc

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ctc_alpha": [_P] * 6 + [_I] * 5 + [_P],
               "ctc_alpha_wide": [_P] * 5 + [_I] * 3 + [_P],
               "ctc_alpha_paired": [_P] * 6 + [_I] * 5 + [_P],
               "ctc_alpha_paired_wide": [_P] * 5 + [_I] * 3 + [_P],
               "ctc_beta": [_P] * 8 + [_I] * 5 + [_P],
               "ctc_beta_wide": [_P] * 8 + [_I] * 3 + [_P]}
MAX_LANE_STATES = 4096  # the register form's route: 32 warps x 32 lanes x 4 states
PAIRED_FWD = False  # the alpha recursion two frames an iteration (read at each call)


class LanePlan(NamedTuple):
    """A K4 launch: ``form`` "lanes" (the register form: ``warps`` warps, lane
    l of warp w holding states (32 w + l) k .. + k - 1) or "wide" (the rows
    in device memory: thread j of 32 ``warps`` takes states j + 32 warps i,
    i < k)."""

    form: str
    warps: int
    k: int


def wide_plan(S: int) -> LanePlan:
    """The wide form's launch for S states: at most 1024 threads."""
    threads = min(1024, -(-max(S, 1) // 32) * 32)
    return LanePlan("wide", threads // 32, -(-max(S, 1) // threads))


def lane_plan(S: int) -> LanePlan:
    """K4's route for a lattice of S states: the register form with the
    fewest states a lane that 32 warps allow (a lane's chains run one after
    another; the warps' overlap), and as many warps as S needs, up to
    ``MAX_LANE_STATES``; past it the wide form."""
    if S > MAX_LANE_STATES:
        return wide_plan(S)
    k = 1
    while 32 * 32 * k < S:
        k *= 2
    return LanePlan("lanes", -(-max(S, 1) // (32 * k)), k)


def plan_states(plan: LanePlan, S: int) -> np.ndarray:
    """(32 warps, k) int: the state each thread's slot i holds under
    ``plan``, -1 past the lattice, as the C source indexes them."""
    tid = np.arange(32 * plan.warps)[:, None]
    i = np.arange(plan.k)[None, :]
    s = tid * plan.k + i if plan.form == "lanes" else tid + 32 * plan.warps * i
    return np.where(s < S, s, -1)


def _check(name: str, tensors: dict, T: int, B: int, S: int) -> None:
    want = {"logp_tbs": ((T, B, S), torch.float32), "alphas": ((T, B, S), torch.float32),
            "skip": ((B, S), torch.bool), "skip_from": ((B, S), torch.bool),
            "beta_T": ((B, S), torch.float32), "lens": ((B,), torch.int32),
            "logz": ((B,), torch.float32), "trace": ((T, 8), torch.int64)}
    device = tensors["logp_tbs"].device
    for key, t in tensors.items():
        if t is None:
            continue
        shape, dtype = want[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: all inputs must be contiguous on one CUDA device")


def route(name: str, S: int, wide: bool, trace) -> LanePlan:
    """The launch of ``name`` at S states: ``lane_plan(S)``, or with
    ``wide`` the wide form, which takes no ``trace``."""
    plan = wide_plan(S) if wide else lane_plan(S)
    if plan.form == "wide" and trace is not None:
        raise ValueError(f"{name}: the wide form takes no trace")
    return plan


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def ctc_alpha(logp_tbs: torch.Tensor, skip: torch.Tensor, logit_len: torch.Tensor,
              trace: torch.Tensor | None = None,
              wide: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha recursion: (T, B, S) lattice log-probs -> (alphas (T, B, S), final (B, S)).
    With ``PAIRED_FWD`` set, ``ctc_alpha_paired`` (its trace a record a
    pair).  ``wide`` forces the wide form (``route``).

    ``trace``, a contiguous int64 (T, 8) tensor on the card, receives block
    0's phase clocks of each frame it recurses (the register form only;
    ``chip_smoke.py::ctc_split`` reads them): the global timer (ns) as the
    frame starts, the SM clock (cycles) then, after its logp row is in
    registers, after the neighbour warp's edge (the wait for its slot), after
    the shuffles, after the lse3 chain, after the edge's publication, the
    stores and the next row's loads, and the global timer at its end."""
    if PAIRED_FWD:
        return ctc_alpha_paired(logp_tbs, skip, logit_len, trace, wide)
    if logp_tbs.device.type == "cpu":
        return ctc.alphas_plain(logp_tbs, skip, logit_len)
    T, B, S = logp_tbs.shape
    _check("ctc_alpha", {"logp_tbs": logp_tbs, "skip": skip, "lens": logit_len,
                         "trace": trace}, T, B, S)
    plan = route("ctc_alpha", S, wide, trace)
    alphas = torch.empty_like(logp_tbs)
    final = torch.empty((B, S), dtype=torch.float32, device=logp_tbs.device)
    lib = build.load("ctc_alpha_beta", _SIGNATURES)
    ptrs = (logp_tbs.data_ptr(), skip.data_ptr(), logit_len.data_ptr(), alphas.data_ptr(),
            final.data_ptr())
    stream = torch.cuda.current_stream(logp_tbs.device).cuda_stream
    if plan.form == "wide":
        name, err = "ctc_alpha_wide", lib.ctc_alpha_wide(*ptrs, T, B, S, stream)
    else:
        name, err = "ctc_alpha", lib.ctc_alpha(*ptrs, _ptr(trace), T, B, S, plan.warps, plan.k,
                                               stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return alphas, final


def ctc_alpha_paired(logp_tbs: torch.Tensor, skip: torch.Tensor, logit_len: torch.Tensor,
                     trace: torch.Tensor | None = None,
                     wide: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The alpha recursion two frames an iteration; see ``ctc.alphas_paired_plain``.
    Routed as ``ctc_alpha`` (``route``): its register form on the alpha's
    lanes, or its wide form (``ctc_alpha_paired_wide``).

    ``trace``, a contiguous int64 (T, 8) tensor on the card, receives, at the
    first row t of each pair t > 0 it recurses, the phase clocks of lane 0 of
    block 0's last warp (the register form only; ``bench_kernel_turns.
    ctc_split`` with ``PAIRED_PHASES`` reads them): the global timer (ns) as
    the pair starts, the SM clock then, after its rows are in registers,
    after the emission weights, after the shuffles, after the left warp's
    edge, after the lse chains, and after the edge's publication, the next
    rows' loads and the stores."""
    if logp_tbs.device.type == "cpu":
        return ctc.alphas_paired_plain(logp_tbs, skip, logit_len)
    T, B, S = logp_tbs.shape
    _check("ctc_alpha_paired", {"logp_tbs": logp_tbs, "skip": skip, "lens": logit_len,
                                "trace": trace}, T, B, S)
    plan = route("ctc_alpha_paired", S, wide, trace)
    alphas = torch.empty_like(logp_tbs)
    final = torch.empty((B, S), dtype=torch.float32, device=logp_tbs.device)
    lib = build.load("ctc_alpha_beta", _SIGNATURES)
    ptrs = (logp_tbs.data_ptr(), skip.data_ptr(), logit_len.data_ptr(), alphas.data_ptr(),
            final.data_ptr())
    stream = torch.cuda.current_stream(logp_tbs.device).cuda_stream
    if plan.form == "wide":
        name, err = "ctc_alpha_paired_wide", lib.ctc_alpha_paired_wide(*ptrs, T, B, S, stream)
    else:
        name, err = "ctc_alpha_paired", lib.ctc_alpha_paired(*ptrs, _ptr(trace), T, B, S,
                                                             plan.warps, plan.k, stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return alphas, final


def ctc_beta(logp_tbs, alphas, skip_from, beta_T, lens, logz,
             trace: torch.Tensor | None = None, wide: bool = False) -> torch.Tensor:
    """Beta recursion -> state posteriors w (T, B, S); see ``ctc.posteriors_plain``.
    ``trace`` and ``wide`` as ``ctc_alpha``'s, the trace's chain phase ending
    after the posteriors' exp; its rows are the frames below each row's last
    (which installs ``beta_T``)."""
    if logp_tbs.device.type == "cpu":
        return ctc.posteriors_plain(logp_tbs, alphas, skip_from, beta_T, lens, logz)
    T, B, S = logp_tbs.shape
    _check("ctc_beta", {"logp_tbs": logp_tbs, "alphas": alphas, "skip_from": skip_from,
                        "beta_T": beta_T, "lens": lens, "logz": logz, "trace": trace}, T, B, S)
    plan = route("ctc_beta", S, wide, trace)
    w = torch.empty_like(logp_tbs)
    lib = build.load("ctc_alpha_beta", _SIGNATURES)
    ptrs = (logp_tbs.data_ptr(), alphas.data_ptr(), skip_from.data_ptr(), beta_T.data_ptr(),
            lens.data_ptr(), logz.data_ptr(), w.data_ptr())
    stream = torch.cuda.current_stream(logp_tbs.device).cuda_stream
    if plan.form == "wide":
        scratch = torch.empty((2, B, S), dtype=torch.float32, device=logp_tbs.device)
        name, err = "ctc_beta_wide", lib.ctc_beta_wide(*ptrs, scratch.data_ptr(), T, B, S,
                                                       stream)
    else:
        name, err = "ctc_beta", lib.ctc_beta(*ptrs, _ptr(trace), T, B, S, plan.warps, plan.k,
                                             stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return w


KERNELS = ctc.Recursions(ctc_alpha, ctc_beta)


def ctc_loss(logits, logit_len, labels, label_len, blank: int = 0) -> torch.Tensor:
    """(B,) per-utterance CTC loss: the K4 kernels for CUDA tensors, the plain
    recursions for CPU tensors.  Same semantics as ``ctc.ctc_loss``."""
    return ctc.CTCLoss.apply(logits, logit_len, labels, label_len, blank, KERNELS)
