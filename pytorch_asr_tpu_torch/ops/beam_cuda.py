"""CTC prefix beam search on the card: the K7/K8 kernel ``csrc/prefix_beam.cu``.

Counterpart of ``pytorch_asr_tpu/ops/beam_pallas.py::prefix_beam_fused_lanes``
(K7, all chars) and ``prefix_beam_fused_lanes_topa`` (K8, each frame's top-A
chars).  ``prefix_beam`` takes the plain search
(``decoding/prefix_beam.py::beam_scan_plain``) for CPU tensors and launches
the kernel for CUDA tensors; there is no other switch and no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as plain
from pytorch_asr_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"prefix_beam": [_P] * 10 + [_I] * 7 + [_F, _F, _P]}
MAX_SMEM = 232448    # the dynamic shared memory a Hopper block may use
MAX_BEAM = 1024      # picks are held one a thread


def smem_bytes(K: int, C: int, V: int) -> int:
    """Shared memory of one block, as ``csrc/prefix_beam.cu`` lays it out."""
    return 72 * K + 17 * K * C + 8 * V + 512


def _check(logp, logit_len, lm_table, top_val, top_idx, K: int, L: int) -> int:
    """Validates the inputs; returns C, the candidate lanes of a beam."""
    B, T, V = logp.shape
    want = {"logp": (logp, (B, T, V), torch.float32),
            "logit_len": (logit_len, (B,), torch.int32)}
    C = V
    if lm_table is not None:
        want["lm_table"] = (lm_table, (lm_table.shape[0], V), torch.float32)
        if lm_table.shape[0] * V >= 2 ** 31:
            raise ValueError(f"prefix_beam: lm_table {tuple(lm_table.shape)} too large")
    if (top_val is None) != (top_idx is None):
        raise ValueError("prefix_beam: give both top_val and top_idx, or neither")
    if top_idx is not None:
        C = top_idx.shape[-1]
        want["top_val"] = (top_val, (B, T, C), torch.float32)
        want["top_idx"] = (top_idx, (B, T, C), torch.int32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"prefix_beam: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != logp.device or not t.is_contiguous():
            raise ValueError("prefix_beam: all inputs must be contiguous on one CUDA device")
    if not 1 <= K <= MAX_BEAM or L < 0 or C < 1:
        raise ValueError(f"prefix_beam: beam_size {K} must be in 1..{MAX_BEAM}, "
                         f"max_len {L} >= 0, lanes {C} >= 1")
    need = smem_bytes(K, C, V)
    if need > MAX_SMEM:
        raise ValueError(f"prefix_beam: K*C = {K}*{C} candidate lanes need {need} bytes of "
                         f"shared memory, more than a block's {MAX_SMEM}")
    return C


def prefix_beam(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int, max_len: int,
                lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                lm_beta: float = 0.0, top_val: torch.Tensor | None = None,
                top_idx: torch.Tensor | None = None):
    """Prefix beam search over log-probs ``logp`` (B, T, V) float32 with
    lengths ``logit_len`` (B,) int32 and, optionally, a dense LM table
    (n_ctx, V) float32 fused as ``lm_alpha * row + lm_beta`` a char.  With
    ``top_val``/``top_idx`` (B, T, A) the extensions are each frame's top-A
    chars (K8), else all chars (K7).  Returns (tokens (B, max_len) int32,
    lengths (B,) int32, scores (B,) float32) of the best beam of each row."""
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, logit_len, beam_size, max_len, lm_table, lm_alpha,
                                     lm_beta, top_val, top_idx)
    B, T, V = logp.shape
    K, L = beam_size, max_len
    C = _check(logp, logit_len, lm_table, top_val, top_idx, K, L)
    dev = logp.device
    parents = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    appends = torch.empty_like(parents)
    tokens = torch.empty((B, L), dtype=torch.int32, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = build.load("prefix_beam", _SIGNATURES)
    name = "prefix_beam_topa" if top_idx is not None else "prefix_beam"
    build.check(lib.prefix_beam(
        logp.data_ptr(), ptr(top_val), ptr(top_idx), logit_len.data_ptr(), ptr(lm_table),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, C, L, lm_table.shape[0] if lm_table is not None else 1,
        lm_alpha, lm_beta, torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores
