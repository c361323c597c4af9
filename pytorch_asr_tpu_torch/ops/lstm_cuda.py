"""The LSTM kernels of ``csrc/lstm_seq.cu`` and their plain versions.

Counterpart of ``pytorch_asr_tpu/ops/lstm_pallas.py::lstm_seq``, one
direction: the inference forward (K2) and, under autograd, the training
forward that saves residuals plus its backward (K3).  And of its
``bilstm_seq`` (K11): both directions of a BiLSTM layer in one launch, with
its own training pair; no encoder calls it, as in the JAX package, where it
is kept beside ``lstm_seq`` as a measured design.  Each wrapper takes its
plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors; there is no other switch and no fallback.

K2's and K3's forward recurrence run on a co-resident grid, one CTA an SM,
each holding its hidden units' columns of ``whh`` in shared memory;
``recurrence_grid`` picks the grid, and a launch that cannot be resident
raises.  K11's forward runs the same kernel on a grid of both directions,
half the SMs each.  K3's and K11's backward walk an utterance a block.
``_bilstm_seq_per_utterance`` keeps K11's old forward, a block an
utterance, as the grid kernel's bit-equality oracle; no op calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pytorch_asr_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lstm_seq_fwd": [_P] * 10 + [_I] * 11 + [_P],
               "lstm_seq_train_fwd": [_P] * 12 + [_I] * 12 + [_P],
               "lstm_seq_bwd": [_P] * 13 + [_I] * 7 + [_P],
               "bilstm_seq_fwd": [_P] * 10 + [_I] * 10 + [_P],
               "bilstm_seq_train_fwd": [_P] * 12 + [_I] * 11 + [_P],
               "bilstm_seq_per_utterance": [_P] * 9 + [_I] * 8 + [_P],
               "bilstm_seq_bwd": [_P] * 14 + [_I] * 6 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)
SMS = 132                      # the H100 SXM's SMs
SMEM_PER_BLOCK = 232448        # shared memory a Hopper block can opt in to, bytes


class Grid(NamedTuple):
    """The co-resident grid of K2's and K3's forward recurrence (K11's with
    ``directions`` 2).  CTA j of a direction owns the hidden units [j units,
    min((j + 1) units, H)) and their gate columns k, H+k, 2H+k, 3H+k."""
    hidden: int    # H
    ctas: int      # CTAs a direction, one an SM
    units: int     # hidden units a CTA owns (the last may own fewer)
    rows: int      # utterances whose h a CTA stages at once
    smem: int      # bytes of shared memory a CTA
    directions: int = 1  # 2: K11's grid (ctas, 2), a direction a row


def _padded_row(H: int) -> int:
    """csrc/lstm_seq.cu::padded_row: a shared-memory row of H floats, 4 mod 32."""
    return -(-H // 32) * 32 + 4


def recurrence_grid(H: int, B: int, sms: int = SMS, smem: int = SMEM_PER_BLOCK,
                    units: int | None = None, directions: int = 1) -> Grid:
    """The grid of the forward recurrence for hidden width H and B utterances.

    Each CTA holds 4 ``units`` columns of whh (all H rows, fp32) in shared
    memory, the h of ``rows`` utterances, B x 13 ``units`` floats of gates,
    cell carry and two steps' xproj, and 16 floats of tail
    (csrc/lstm_seq.cu::grid_smem_bytes).  ``units`` defaults to
    the fewest that spread H over at most ``sms`` CTAs, ceil(H / sms): the
    most CTAs and the shortest chains a CTA (``chip_smoke.py``'s sweep chose
    it at configs 1 and 2).  ``rows`` is B where it fits, else as many as fit.
    ``directions`` 2 is K11's grid: each direction gets ``sms // 2`` SMs
    and its own CTAs, the same rule on each half.  Raises ValueError where
    the grid cannot hold whh on its SMs.
    """
    if directions not in (1, 2):
        raise ValueError(f"lstm_seq: directions must be 1 or 2, got {directions}")
    sms //= directions
    units = units or -(-H // sms)
    ctas = -(-H // units)
    hp = _padded_row(H)
    fixed = 4 * (4 * units * hp + 13 * B * units + 16) + 4 * B
    rows = min(B, (smem - fixed) // (4 * hp))
    if ctas > sms or rows < 1:
        raise ValueError(
            f"lstm_seq: H {H} at B {B} does not fit the co-resident grid: {ctas} CTAs of "
            f"{units} units need {fixed + 4 * hp} bytes of shared memory each ({4 * units} "
            f"columns of whh, one staged row of h, the state of {B} rows), on {sms} SMs of "
            f"{smem} bytes a direction")
    return Grid(H, ctas, units, rows, fixed + 4 * rows * hp, directions)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _projection(x, wih, bias):
    """(B, T, 4H) float32 ``x @ wih + bias``, ``x``'s type accumulated in float32."""
    return x.float() @ wih.to(x.dtype).float() + bias.float()


def lstm_seq_plain(x, wih, whh, bias, lengths, reverse: bool = False,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked per-step loop, the plain version of the inference kernel.

    Matches ``pytorch_asr_tpu.models.encoder_bilstm._lstm_scan`` with the
    window mask: the projection ``x @ wih`` of ``x``'s type accumulates in
    float32 and adds ``bias``; the recurrence runs in float32 with gates
    i, f, g, o; the carry is held where ``t >= len``; ``reverse`` walks
    t = T-1 .. 0; the output is zero outside [0, len).
    """
    B, T, _ = x.shape
    H = whh.shape[0]
    xproj = _projection(x, wih, bias)                                # (B, T, 4H)
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


def lstm_seq_train_plain(x, wih, whh, bias, lengths, reverse: bool = False,
                         out_dtype: torch.dtype | None = None,
                         residual_dtype: torch.dtype = torch.bfloat16):
    """Plain training forward -> (out (B, T, H), acts (T, B, 4H), ct (T, B, H)).

    ``out`` as ``lstm_seq_plain``.  ``acts`` holds the candidate gate
    activations (i, f, g, o) at every step, valid or not; ``ct`` the masked
    carry (the c entering the next step); both in ``residual_dtype``, as the
    Pallas training forward stores them.
    """
    B, T, _ = x.shape
    H = whh.shape[0]
    xproj = _projection(x, wih, bias)
    whh = whh.float()
    lengths = lengths.to(x.device)
    h = x.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    out = x.new_zeros((B, T, H), dtype=torch.float32)
    acts = x.new_empty((T, B, 4 * H), dtype=residual_dtype)
    ct = x.new_empty((T, B, H), dtype=residual_dtype)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (xproj[:, t] + h @ whh).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        acts[t] = torch.cat([i, f, g, o], dim=-1)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = (t < lengths)[:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = torch.where(m, h_new, 0.0)
        ct[t] = c
    return out.to(out_dtype or torch.float32), acts, ct


def lstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct, reverse: bool = False):
    """Plain backward of one direction -> (dx, dwih, dwhh, db).

    The Pallas ``_bwd_kernel`` as one reverse walk over the stored residuals,
    with no recompute: c_prev is the stored carry of the step processed just
    before (zeros before the first), h_prev = o_prev * tanh(c_prev); dgates
    is 0 outside [0, len), where dh and dc pass through unchanged and the
    upstream gradient never enters.  dx comes back in x's type, dwih in wih's
    type, dwhh and db in float32.
    """
    B, T, D = x.shape
    H = whh.shape[0]
    a, c = acts.float(), ct.float()                                  # (T, B, 4H), (T, B, H)
    tanh_c = torch.tanh(c)
    h_all = a[..., 3 * H:] * tanh_c
    zeros = c.new_zeros((1, B, H))
    if reverse:        # processing order walked t descending
        c_prev, h_prev = torch.cat([c[1:], zeros]), torch.cat([h_all[1:], zeros])
    else:
        c_prev, h_prev = torch.cat([zeros, c[:-1]]), torch.cat([zeros, h_all[:-1]])
    valid = torch.arange(T, device=x.device)[:, None] < lengths.to(x.device)[None, :]
    gy = gy.float().transpose(0, 1)                                  # (T, B, H)
    whh_t = whh.float().t()
    dh = x.new_zeros((B, H), dtype=torch.float32)
    dc = torch.zeros_like(dh)
    dgates = x.new_empty((T, B, 4 * H), dtype=torch.float32)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = a[t].chunk(4, dim=-1)
        dh_tot = dh + gy[t]
        d_o = dh_tot * tanh_c[t]
        dc_tot = dc + dh_tot * o * (1.0 - tanh_c[t] * tanh_c[t])
        dg = torch.cat([dc_tot * g * i * (1.0 - i), dc_tot * c_prev[t] * f * (1.0 - f),
                        dc_tot * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
        m = valid[t][:, None]
        dg = torch.where(m, dg, 0.0)
        dgates[t] = dg
        dh = torch.where(m, dg @ whh_t, dh)
        dc = torch.where(m, dc_tot * f, dc)
    dgs = dgates.reshape(T * B, 4 * H)
    x_tb = x.float().transpose(0, 1).reshape(T * B, D)
    dx = (dgs @ wih.float().t()).reshape(T, B, D).transpose(0, 1).to(x.dtype)
    dwih = (x_tb.t() @ dgs).to(wih.dtype)
    dwhh = h_prev.reshape(T * B, H).t() @ dgs
    return dx, dwih, dwhh, dgs.sum(0)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_seq_infer(x, wih, whh, bias, lengths, reverse: bool = False,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inference forward (K2): the kernel for CUDA tensors, ``lstm_seq_plain`` for CPU."""
    if x.device.type == "cpu":
        return lstm_seq_plain(x, wih, whh, bias, lengths, reverse, out_dtype)
    return forward_on_grid(None, x, wih, whh, bias, lengths, reverse, out_dtype)


def lstm_seq_train_fwd(x, wih, whh, bias, lengths, reverse: bool = False,
                       out_dtype: torch.dtype | None = None,
                       residual_dtype: torch.dtype = torch.bfloat16):
    """Training forward (K3) -> (out, acts, ct); see ``lstm_seq_train_plain``."""
    if x.device.type == "cpu":
        return lstm_seq_train_plain(x, wih, whh, bias, lengths, reverse, out_dtype,
                                    residual_dtype)
    return forward_on_grid(None, x, wih, whh, bias, lengths, reverse, out_dtype, residual_dtype)


def forward_on_grid(grid: Grid | None, x, wih, whh, bias, lengths, reverse: bool = False,
                    out_dtype: torch.dtype | None = None,
                    residual_dtype: torch.dtype | None = None,
                    trace: torch.Tensor | None = None):
    """K2 (``residual_dtype`` None) -> out, or K3's training forward -> (out,
    acts, ct), launched on ``grid``; None takes ``recurrence_grid``'s rule for
    the tensors' card (``chip_smoke.py`` sweeps other grids through here).
    ``trace``, a contiguous int64 (T, 5) tensor on the card, receives in row
    s the timestamps of step s from CTA 0 (K2 walks max(len) steps, K3 T):
    the global timer in ns as the step starts, and the SM clock in cycles
    then, after staging h, after the dot chains and after the cell updates."""
    out_dtype = out_dtype or torch.float32
    _check_cuda_args(x, wih, whh, bias, lengths, out_dtype)
    return _launch_grid(grid, 1, x, wih, whh, bias, lengths, reverse, out_dtype,
                        residual_dtype, trace)


def bilstm_on_grid(grid: Grid | None, x, wih, whh, bias, lengths,
                   out_dtype: torch.dtype | None = None,
                   residual_dtype: torch.dtype | None = None,
                   trace: torch.Tensor | None = None):
    """K11's forward (``residual_dtype`` None) -> out (B, T, 2H), or its
    training forward -> (out, acts (2, T, B, 4H), ct (2, T, B, H)), on a
    grid of both directions (``directions`` 2); None takes
    ``recurrence_grid``'s rule.  ``trace`` as ``forward_on_grid``'s, from
    CTA 0 of the forward direction."""
    out_dtype = out_dtype or torch.float32
    _check_dual_args(x, wih, whh, bias, lengths, out_dtype)
    return _launch_grid(grid, 2, x, wih, whh, bias, lengths, False, out_dtype,
                        residual_dtype, trace)


def _launch_grid(grid, dirs: int, x, wih, whh, bias, lengths, reverse, out_dtype,
                 residual_dtype, trace):
    """Launch the grid kernel for one direction (K2, K3) or both (K11)."""
    B, T, D = x.shape
    if trace is not None and (tuple(trace.shape) != (T, 5) or trace.dtype != torch.int64
                              or trace.device != x.device or not trace.is_contiguous()):
        raise ValueError(f"lstm_seq: trace must be contiguous ({T}, 5) int64 on {x.device}")
    H = whh.shape[-2]
    train = residual_dtype is not None
    if train and residual_dtype not in _DTYPES:
        raise ValueError(f"lstm_seq: residual_dtype must be float32 or bfloat16, "
                         f"got {residual_dtype}")
    lead = (dirs,) if dirs == 2 else ()
    out = torch.empty((B, T, dirs * H), dtype=out_dtype, device=x.device)
    if train:
        acts = torch.empty((*lead, T, B, 4 * H), dtype=residual_dtype, device=x.device)
        ct = torch.empty((*lead, T, B, H), dtype=residual_dtype, device=x.device)
    if B == 0 or T == 0:
        return (out, acts, ct) if train else out
    grid = grid or recurrence_grid(H, B, _sm_count(x.device.index), directions=dirs)
    if grid.hidden != H or grid.directions != dirs:
        raise ValueError(f"lstm_seq: a grid for H {grid.hidden} and {grid.directions} "
                         f"direction(s), not H {H} and {dirs}")
    xproj = torch.empty((*lead, B, T, 4 * H), dtype=torch.float32, device=x.device)
    hbuf = torch.empty((*lead, 2, B, H), dtype=torch.float32, device=x.device)
    sync = torch.zeros(1, dtype=torch.int32, device=x.device)
    lib = build.load("lstm_seq", _SIGNATURES)
    ptrs = [t.data_ptr() for t in (x, wih, whh, bias, lengths, xproj, hbuf, sync)]
    ptrs += [0 if trace is None else trace.data_ptr(), out.data_ptr()]
    if train:
        ptrs += [acts.data_ptr(), ct.data_ptr()]
    flags = [B, T, D, H] + ([int(reverse)] if dirs == 1 else [])
    flags += [int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)]
    if train:
        flags.append(int(residual_dtype == torch.bfloat16))
    flags += [grid.ctas, grid.units, grid.rows, grid.smem]
    stem = "lstm_seq" if dirs == 1 else "bilstm_seq"
    entry, name = (f"{stem}_train_fwd",) * 2 if train else (f"{stem}_fwd", stem)
    build.check(getattr(lib, entry)(*ptrs, *flags, _stream(x)), name)
    build.LAUNCHES[name] += 1
    return (out, acts, ct) if train else out


def lstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct, reverse: bool = False):
    """Backward (K3) -> (dx, dwih, dwhh, db); see ``lstm_seq_bwd_plain``."""
    if x.device.type == "cpu":
        return lstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct, reverse)
    B, T, D = x.shape
    H = whh.shape[0]
    gy = gy.float().contiguous()
    _check_cuda_args(x, wih, whh, whh.new_empty(4 * H), lengths, torch.float32)
    for name, t, shape in (("gy", gy, (B, T, H)), ("acts", acts, (T, B, 4 * H)),
                           ("ct", ct, (T, B, H))):
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"lstm_seq_bwd: {name} must be contiguous {shape} on "
                             f"{x.device}, got {tuple(t.shape)}")
    if acts.dtype != ct.dtype or acts.dtype not in _DTYPES:
        raise ValueError(f"lstm_seq_bwd: residuals must share a type of {_DTYPES}")
    dx = torch.empty_like(x)
    dwih = torch.empty_like(wih)
    dwhh = torch.empty_like(whh)
    db = torch.empty(4 * H, dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return dx.zero_(), dwih.zero_(), dwhh.zero_(), db.zero_()
    dgates = torch.empty((B, T, 4 * H), dtype=torch.float32, device=x.device)
    hprev = torch.empty((B, T, H), dtype=torch.float32, device=x.device)
    lib = build.load("lstm_seq", _SIGNATURES)
    err = lib.lstm_seq_bwd(
        gy.data_ptr(), x.data_ptr(), wih.data_ptr(), whh.data_ptr(), lengths.data_ptr(),
        acts.data_ptr(), ct.data_ptr(), dgates.data_ptr(), hprev.data_ptr(),
        dx.data_ptr(), dwih.data_ptr(), dwhh.data_ptr(), db.data_ptr(),
        B, T, D, H, int(reverse), int(x.dtype == torch.bfloat16),
        int(acts.dtype == torch.bfloat16), _stream(x))
    build.check(err, "lstm_seq_bwd")
    build.LAUNCHES["lstm_seq_bwd"] += 1
    return dx, dwih, dwhh, db


class LSTMSeq(torch.autograd.Function):
    """The training pair: K3's forward saves residuals, its backward walks them."""

    @staticmethod
    def forward(ctx, x, wih, whh, bias, lengths, reverse, out_dtype, residual_dtype):
        out, acts, ct = lstm_seq_train_fwd(x, wih, whh, bias, lengths, reverse, out_dtype,
                                           residual_dtype)
        ctx.save_for_backward(x, wih, whh, lengths, acts, ct)
        ctx.reverse = reverse
        return out

    @staticmethod
    def backward(ctx, gy):
        x, wih, whh, lengths, acts, ct = ctx.saved_tensors
        dx, dwih, dwhh, db = lstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct, ctx.reverse)
        return dx, dwih, dwhh, db, None, None, None, None


def lstm_seq(x, wih, whh, bias, lengths, reverse: bool = False,
             out_dtype: torch.dtype | None = None,
             residual_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Masked LSTM over a batch-major padded sequence.

    Args:
      x: (B, T, D) float32 or bfloat16, natural time order.
      wih: (D, 4H) of x's type; whh: (H, 4H) float32; bias: (4H,) float32.
      lengths: (B,) int32 valid lengths; the window is [0, len) for BOTH
        directions, and ``reverse`` walks it backwards.
      out_dtype: float32 (the default) or bfloat16.
      residual_dtype: type of the residuals the training forward saves
        (bfloat16, as the JAX package's default, or float32).
    Returns: (B, T, H) hidden states, zero outside the window.

    With grad mode off or no input needing a gradient this is the inference
    forward (K2); otherwise the training pair (K3), as the JAX package runs
    its primal outside ``jax.grad`` and its VJP pair inside.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wih, whh, bias)):
        return LSTMSeq.apply(x, wih, whh, bias, lengths, reverse,
                             out_dtype or torch.float32, residual_dtype)
    return lstm_seq_infer(x, wih, whh, bias, lengths, reverse, out_dtype)


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


# ---------------------------------------------------------------- K11: both directions


def bilstm_seq_plain(x, wih, whh, bias, lengths,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of K11's inference forward: ``lstm_seq_plain`` once a
    direction with ``wih[d]``, ``whh[d]``, ``bias[d]`` (d = 0 forward, 1
    reverse), the outputs concatenated -> (B, T, 2H)."""
    return torch.cat([lstm_seq_plain(x, wih[d], whh[d], bias[d], lengths, bool(d), out_dtype)
                      for d in (0, 1)], dim=-1)


def bilstm_seq_train_plain(x, wih, whh, bias, lengths, out_dtype: torch.dtype | None = None,
                           residual_dtype: torch.dtype = torch.bfloat16):
    """Plain training forward of K11 -> (out (B, T, 2H), acts (2, T, B, 4H),
    ct (2, T, B, H)): ``lstm_seq_train_plain`` once a direction."""
    outs = [lstm_seq_train_plain(x, wih[d], whh[d], bias[d], lengths, bool(d), out_dtype,
                                 residual_dtype) for d in (0, 1)]
    return (torch.cat([o[0] for o in outs], dim=-1), torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def bilstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct):
    """Plain backward of K11 -> (dx, dwih (2, D, 4H), dwhh (2, H, 4H), db (2, 4H)):
    ``lstm_seq_bwd_plain`` once a direction on its half of ``gy``; dx is
    the sum of the two directions' dx, each in x's type."""
    H = whh.shape[1]
    grads = [lstm_seq_bwd_plain(gy[..., d * H:(d + 1) * H], x, wih[d], whh[d], lengths,
                                acts[d], ct[d], bool(d)) for d in (0, 1)]
    return (grads[0][0] + grads[1][0], *(torch.stack([g[i] for g in grads]) for i in (1, 2, 3)))


def bilstm_seq_infer(x, wih, whh, bias, lengths,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K11's inference forward: the dual grid for CUDA tensors,
    ``bilstm_seq_plain`` for CPU."""
    if x.device.type == "cpu":
        return bilstm_seq_plain(x, wih, whh, bias, lengths, out_dtype)
    return bilstm_on_grid(None, x, wih, whh, bias, lengths, out_dtype)


def bilstm_seq_train_fwd(x, wih, whh, bias, lengths, out_dtype: torch.dtype | None = None,
                         residual_dtype: torch.dtype = torch.bfloat16):
    """K11's training forward -> (out, acts, ct); see ``bilstm_seq_train_plain``."""
    if x.device.type == "cpu":
        return bilstm_seq_train_plain(x, wih, whh, bias, lengths, out_dtype, residual_dtype)
    return bilstm_on_grid(None, x, wih, whh, bias, lengths, out_dtype, residual_dtype)


def _bilstm_seq_per_utterance(x, wih, whh, bias, lengths,
                              out_dtype: torch.dtype | None = None,
                              residual_dtype: torch.dtype | None = None):
    """The oracle: K11's forward (-> out) or, with ``residual_dtype``, its
    training forward (-> (out, acts, ct)) on the per-utterance kernel, a
    block an utterance and direction, CUDA tensors only.  The grid kernel
    must equal it bit for bit; only the card tests and ``chip_smoke.py``
    call it, under its own launch count."""
    out_dtype = out_dtype or torch.float32
    _check_dual_args(x, wih, whh, bias, lengths, out_dtype)
    train = residual_dtype is not None
    if train and residual_dtype not in _DTYPES:
        raise ValueError(f"bilstm_seq: residual_dtype must be float32 or bfloat16, "
                         f"got {residual_dtype}")
    B, T, D = x.shape
    H = whh.shape[1]
    out = torch.empty((B, T, 2 * H), dtype=out_dtype, device=x.device)
    res = residual_dtype or torch.float32
    acts = torch.empty((2, T, B, 4 * H) if train else (0,), dtype=res, device=x.device)
    ct = torch.empty((2, T, B, H) if train else (0,), dtype=res, device=x.device)
    if B and T:
        xproj = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=x.device)
        lib = build.load("lstm_seq", _SIGNATURES)
        err = lib.bilstm_seq_per_utterance(
            x.data_ptr(), wih.data_ptr(), whh.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
            xproj.data_ptr(), out.data_ptr(), acts.data_ptr(), ct.data_ptr(), B, T, D, H,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(train),
            int(res == torch.bfloat16), _stream(x))
        build.check(err, "bilstm_seq_per_utterance")
        build.LAUNCHES["bilstm_seq_per_utterance"] += 1
    return (out, acts, ct) if train else out


def bilstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct):
    """K11's backward -> (dx, dwih, dwhh, db); see ``bilstm_seq_bwd_plain``."""
    if x.device.type == "cpu":
        return bilstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct)
    B, T, D = x.shape
    H = whh.shape[1]
    gy = gy.float().contiguous()
    _check_dual_args(x, wih, whh, whh.new_empty((2, 4 * H)), lengths, torch.float32)
    for name, t, shape in (("gy", gy, (B, T, 2 * H)), ("acts", acts, (2, T, B, 4 * H)),
                           ("ct", ct, (2, T, B, H))):
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bilstm_seq_bwd: {name} must be contiguous {shape} on "
                             f"{x.device}, got {tuple(t.shape)}")
    if acts.dtype != ct.dtype or acts.dtype not in _DTYPES:
        raise ValueError(f"bilstm_seq_bwd: residuals must share a type of {_DTYPES}")
    dx = torch.empty_like(x)
    dwih = torch.empty_like(wih)
    dwhh = torch.empty_like(whh)
    db = torch.empty((2, 4 * H), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return dx.zero_(), dwih.zero_(), dwhh.zero_(), db.zero_()
    dgates = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=x.device)
    hprev = torch.empty((2, B, T, H), dtype=torch.float32, device=x.device)
    dx2 = torch.empty((2, B, T, D), dtype=x.dtype, device=x.device)
    lib = build.load("lstm_seq", _SIGNATURES)
    err = lib.bilstm_seq_bwd(
        gy.data_ptr(), x.data_ptr(), wih.data_ptr(), whh.data_ptr(), lengths.data_ptr(),
        acts.data_ptr(), ct.data_ptr(), dgates.data_ptr(), hprev.data_ptr(), dx2.data_ptr(),
        dx.data_ptr(), dwih.data_ptr(), dwhh.data_ptr(), db.data_ptr(), B, T, D, H,
        int(x.dtype == torch.bfloat16), int(acts.dtype == torch.bfloat16), _stream(x))
    build.check(err, "bilstm_seq_bwd")
    build.LAUNCHES["bilstm_seq_bwd"] += 1
    return dx, dwih, dwhh, db


class BiLSTMSeq(torch.autograd.Function):
    """K11's training pair: the forward saves both directions' residuals,
    the backward walks them."""

    @staticmethod
    def forward(ctx, x, wih, whh, bias, lengths, out_dtype, residual_dtype):
        out, acts, ct = bilstm_seq_train_fwd(x, wih, whh, bias, lengths, out_dtype,
                                             residual_dtype)
        ctx.save_for_backward(x, wih, whh, lengths, acts, ct)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, wih, whh, lengths, acts, ct = ctx.saved_tensors
        dx, dwih, dwhh, db = bilstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct)
        return dx, dwih, dwhh, db, None, None, None


def bilstm_seq(x, wih, whh, bias, lengths, out_dtype: torch.dtype | None = None,
               residual_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Masked BiLSTM layer: both directions in one launch (K11).

    Args:
      x: (B, T, D) float32 or bfloat16, natural time order.
      wih: (2, D, 4H) of x's type, stacked [forward, reverse]; whh: (2, H, 4H)
        float32; bias: (2, 4H) float32.
      lengths: (B,) int32; the window is [0, len) for both directions.
      out_dtype: float32 (the default) or bfloat16.
      residual_dtype: type of the residuals the training forward saves.
    Returns: (B, T, 2H) = [forward | reverse] hidden states, zero outside the
    window; equal per direction to ``lstm_seq`` (the same operations in the
    same order).  Under autograd the training pair, else the inference
    forward, as ``lstm_seq`` picks.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wih, whh, bias)):
        return BiLSTMSeq.apply(x, wih, whh, bias, lengths, out_dtype or torch.float32,
                               residual_dtype)
    return bilstm_seq_infer(x, wih, whh, bias, lengths, out_dtype)


def _check_dual_args(x, wih, whh, bias, lengths, out_dtype) -> None:
    """K11's inputs: each direction as ``lstm_seq`` takes it, stacked."""
    if wih.dim() != 3 or whh.dim() != 3 or bias.dim() != 2 or not (
            wih.shape[0] == whh.shape[0] == bias.shape[0] == 2):
        raise ValueError(f"bilstm_seq: wih, whh, bias must be stacked (2, ...), got "
                         f"{tuple(wih.shape)}, {tuple(whh.shape)}, {tuple(bias.shape)}")
    _check_cuda_args(x, wih[0], whh[0], bias[0], lengths, out_dtype)
    for t in (wih, whh, bias):
        if not t.is_contiguous():
            raise ValueError("bilstm_seq: all inputs must be contiguous on one CUDA device")
