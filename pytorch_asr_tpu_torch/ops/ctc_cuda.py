"""CTC loss on the card: the K4 kernels ``csrc/ctc_alpha_beta.cu`` behind
``ops/ctc.py``'s autograd function.

Counterpart of ``pytorch_asr_tpu/ops/ctc_pallas.py::ctc_loss_auto``.  Each
wrapper takes its plain PyTorch version (``ops/ctc.py``) for CPU tensors and
launches its kernel for CUDA tensors; there is no other switch and no
fallback.  ``PAIRED_FWD``, as the JAX module's switch of the same name, makes
the alpha recursion take two frames an iteration (``ctc_alpha_paired``); no
path sets it, it is the measured alternative.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_asr_tpu_torch.ops import build, ctc

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ctc_alpha": [_P] * 5 + [_I] * 3 + [_P],
               "ctc_alpha_paired": [_P] * 5 + [_I] * 3 + [_P],
               "ctc_beta": [_P] * 7 + [_I] * 3 + [_P]}
MAX_STATES = 4096   # lattice states a block holds: 1024 threads x 4 in registers
PAIRED_FWD = False  # the alpha recursion two frames an iteration (read at each call)


def _check(name: str, tensors: dict, T: int, B: int, S: int) -> None:
    if S > MAX_STATES:
        raise ValueError(f"{name}: {S} lattice states exceed {MAX_STATES} "
                         f"(labels longer than {(MAX_STATES - 1) // 2})")
    want = {"logp_tbs": ((T, B, S), torch.float32), "alphas": ((T, B, S), torch.float32),
            "skip": ((B, S), torch.bool), "skip_from": ((B, S), torch.bool),
            "beta_T": ((B, S), torch.float32), "lens": ((B,), torch.int32),
            "logz": ((B,), torch.float32)}
    device = tensors["logp_tbs"].device
    for key, t in tensors.items():
        shape, dtype = want[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: all inputs must be contiguous on one CUDA device")


def ctc_alpha(logp_tbs: torch.Tensor, skip: torch.Tensor,
              logit_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha recursion: (T, B, S) lattice log-probs -> (alphas (T, B, S), final (B, S)).
    With ``PAIRED_FWD`` set, ``ctc_alpha_paired``."""
    if PAIRED_FWD:
        return ctc_alpha_paired(logp_tbs, skip, logit_len)
    return _alpha("ctc_alpha", ctc.alphas_plain, logp_tbs, skip, logit_len)


def ctc_alpha_paired(logp_tbs: torch.Tensor, skip: torch.Tensor,
                     logit_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The alpha recursion two frames an iteration; see ``ctc.alphas_paired_plain``."""
    return _alpha("ctc_alpha_paired", ctc.alphas_paired_plain, logp_tbs, skip, logit_len)


def _alpha(name: str, plain, logp_tbs, skip, logit_len):
    if logp_tbs.device.type == "cpu":
        return plain(logp_tbs, skip, logit_len)
    T, B, S = logp_tbs.shape
    _check(name, {"logp_tbs": logp_tbs, "skip": skip, "lens": logit_len}, T, B, S)
    alphas = torch.empty_like(logp_tbs)
    final = torch.empty((B, S), dtype=torch.float32, device=logp_tbs.device)
    lib = build.load("ctc_alpha_beta", _SIGNATURES)
    build.check(getattr(lib, name)(logp_tbs.data_ptr(), skip.data_ptr(), logit_len.data_ptr(),
                                   alphas.data_ptr(), final.data_ptr(), T, B, S,
                                   torch.cuda.current_stream(logp_tbs.device).cuda_stream),
                name)
    build.LAUNCHES[name] += 1
    return alphas, final


def ctc_beta(logp_tbs, alphas, skip_from, beta_T, lens, logz) -> torch.Tensor:
    """Beta recursion -> state posteriors w (T, B, S); see ``ctc.posteriors_plain``."""
    if logp_tbs.device.type == "cpu":
        return ctc.posteriors_plain(logp_tbs, alphas, skip_from, beta_T, lens, logz)
    T, B, S = logp_tbs.shape
    _check("ctc_beta", {"logp_tbs": logp_tbs, "alphas": alphas, "skip_from": skip_from,
                        "beta_T": beta_T, "lens": lens, "logz": logz}, T, B, S)
    w = torch.empty_like(logp_tbs)
    lib = build.load("ctc_alpha_beta", _SIGNATURES)
    build.check(lib.ctc_beta(logp_tbs.data_ptr(), alphas.data_ptr(), skip_from.data_ptr(),
                             beta_T.data_ptr(), lens.data_ptr(), logz.data_ptr(),
                             w.data_ptr(), T, B, S,
                             torch.cuda.current_stream(logp_tbs.device).cuda_stream),
                "ctc_beta")
    build.LAUNCHES["ctc_beta"] += 1
    return w


KERNELS = ctc.Recursions(ctc_alpha, ctc_beta)


def ctc_loss(logits, logit_len, labels, label_len, blank: int = 0) -> torch.Tensor:
    """(B,) per-utterance CTC loss: the K4 kernels for CUDA tensors, the plain
    recursions for CPU tensors.  Same semantics as ``ctc.ctc_loss``."""
    return ctc.CTCLoss.apply(logits, logit_len, labels, label_len, blank, KERNELS)
