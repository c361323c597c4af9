"""One LSTM direction: the CUDA kernel ``csrc/lstm_seq.cu`` and its plain version.

Counterpart of ``pytorch_asr_tpu/ops/lstm_pallas.py::lstm_seq`` (inference
forward).  ``lstm_seq`` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; there is no other switch and no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_asr_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lstm_seq_fwd": [_P] * 7 + [_I] * 7 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)


def lstm_seq_plain(x, wih, whh, bias, lengths, reverse: bool = False,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked per-step loop, the plain version of the kernel.

    Matches ``pytorch_asr_tpu.models.encoder_bilstm._lstm_scan`` with the
    window mask: the projection ``x @ wih`` of ``x``'s type accumulates in
    float32 and adds ``bias``; the recurrence runs in float32 with gates
    i, f, g, o; the carry is held where ``t >= len``; ``reverse`` walks
    t = T-1 .. 0; the output is zero outside [0, len).
    """
    B, T, _ = x.shape
    H = whh.shape[0]
    xproj = x.float() @ wih.to(x.dtype).float() + bias.float()     # (B, T, 4H)
    whh = whh.float()
    lengths = lengths.to(x.device)
    h = x.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    out = x.new_zeros((B, T, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (xproj[:, t] + h @ whh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = (t < lengths)[:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = torch.where(m, h_new, 0.0)
    return out.to(out_dtype or torch.float32)


def lstm_seq(x, wih, whh, bias, lengths, reverse: bool = False,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked LSTM over a batch-major padded sequence.

    Args:
      x: (B, T, D) float32 or bfloat16, natural time order.
      wih: (D, 4H) of x's type; whh: (H, 4H) float32; bias: (4H,) float32.
      lengths: (B,) int32 valid lengths; the window is [0, len) for BOTH
        directions, and ``reverse`` walks it backwards.
      out_dtype: float32 (the default) or bfloat16.
    Returns: (B, T, H) hidden states, zero outside the window.
    """
    if x.device.type == "cpu":
        return lstm_seq_plain(x, wih, whh, bias, lengths, reverse, out_dtype)
    out_dtype = out_dtype or torch.float32
    _check_cuda_args(x, wih, whh, bias, lengths, out_dtype)
    B, T, D = x.shape
    H = whh.shape[0]
    out = torch.empty((B, T, H), dtype=out_dtype, device=x.device)
    if B == 0 or T == 0:
        return out
    xproj = torch.empty((B, T, 4 * H), dtype=torch.float32, device=x.device)
    lib = build.load("lstm_seq", _SIGNATURES)
    err = lib.lstm_seq_fwd(
        x.data_ptr(), wih.data_ptr(), whh.data_ptr(), bias.data_ptr(),
        lengths.data_ptr(), xproj.data_ptr(), out.data_ptr(),
        B, T, D, H, int(reverse), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "lstm_seq")
    build.LAUNCHES["lstm_seq"] += 1
    return out


def _check_cuda_args(x, wih, whh, bias, lengths, out_dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"lstm_seq: x must be (B, T, D) float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    B, T, D = x.shape
    H = whh.shape[0]
    want = {"wih": (wih, (D, 4 * H), x.dtype), "whh": (whh, (H, 4 * H), torch.float32),
            "bias": (bias, (4 * H,), torch.float32), "lengths": (lengths, (B,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"lstm_seq: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (x, wih, whh, bias, lengths):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("lstm_seq: all inputs must be contiguous on one CUDA device")
    if out_dtype not in _DTYPES:
        raise ValueError(f"lstm_seq: out_dtype must be float32 or bfloat16, got {out_dtype}")
