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
``recurrence_grid`` picks the grid.  K11's forward runs the same kernel on a
grid of both directions, half the SMs each.  Where the grid cannot hold
``whh`` (one direction from H ~1300 at B 8-16, K11 from H ~920, or a batch of
hundreds), the ops take the wide route: the per-utterance kernel, a block an
utterance (and direction), which gives the grid's bits and runs to H 9,685.
``forward_route`` chooses from the shapes before the launch, and the wide
route counts under its own names (``lstm_seq_wide``, ``lstm_seq_train_wide``,
``bilstm_seq_wide``, ``bilstm_seq_train_wide``).  K3's backward runs its dh
recurrence on a co-resident grid too, each CTA holding its units' rows of
``whh`` (``backward_grid``); past it (from H 1305 at B 8) it walks an
utterance a block, counted as ``lstm_seq_bwd_wide`` (``backward_route``).
K11's backward runs the same grid kernel on a grid of both directions, half
the SMs each (``backward_route(..., directions=2)``), and past it (from H
925 at B 8) walks an utterance and direction a block, counted as
``bilstm_seq_bwd_wide``.  ``_bilstm_seq_per_utterance`` and
``_bilstm_seq_bwd_per_utterance`` run K11's wide routes as the grid
kernels' bit-equality oracles, under counts of their own; no op calls them.
``lstm_seq_stream`` is K2 started from a carried (h, c) and handing its
state on, forward only and without gradients, on either route (counted
``lstm_seq_stream`` and ``lstm_seq_stream_wide``): the streaming
recognizer's chunk (``decoding/streaming.py``), JAX's ``_lstm_chunk``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pytorch_asr_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lstm_seq_fwd": [_P] * 10 + [_I] * 11 + [_P],
               "lstm_seq_train_fwd": [_P] * 12 + [_I] * 12 + [_P],
               "lstm_seq_bwd": [_P] * 15 + [_I] * 11 + [_P],
               "lstm_seq_bwd_per_utterance": [_P] * 13 + [_I] * 7 + [_P],
               "bilstm_seq_fwd": [_P] * 10 + [_I] * 10 + [_P],
               "bilstm_seq_train_fwd": [_P] * 12 + [_I] * 11 + [_P],
               "bilstm_seq_per_utterance": [_P] * 9 + [_I] * 8 + [_P],
               "lstm_seq_per_utterance": [_P] * 9 + [_I] * 9 + [_P],
               "bilstm_seq_bwd": [_P] * 16 + [_I] * 10 + [_P],
               "bilstm_seq_bwd_per_utterance": [_P] * 14 + [_I] * 6 + [_P],
               "lstm_seq_stream": [_P] * 11 + [_I] * 10 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)
SMS = build.SMS
SMEM_PER_BLOCK = 232448        # shared memory a Hopper block can opt in to, bytes
# The wide route's launch counts: (inference, training forward) by directions.
WIDE = {1: ("lstm_seq_wide", "lstm_seq_train_wide"),
        2: ("bilstm_seq_wide", "bilstm_seq_train_wide")}


class Grid(NamedTuple):
    """The co-resident grid of K2's and K3's forward recurrence (K11's with
    ``directions`` 2).  CTA j of a direction owns the hidden units [j units,
    min((j + 1) units, H)) and their gate columns k, H+k, 2H+k, 3H+k.  K3's
    backward grid (``backward_grid``) reads it alike: CTA j holds its units'
    rows of whh, and ``rows`` counts staged rows of dgates."""
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
    grid, fits, need, sms = _grid_shape(H, B, sms, smem, units, directions)
    if not fits:
        raise ValueError(
            f"lstm_seq: H {H} at B {B} does not fit the co-resident grid: {grid.ctas} CTAs of "
            f"{grid.units} units need {need} bytes of shared memory each ({4 * grid.units} "
            f"columns of whh, one staged row of h, the state of {B} rows), on {sms} SMs of "
            f"{smem} bytes a direction")
    return grid


def _grid_shape(H: int, B: int, sms: int, smem: int, units: int | None,
                directions: int) -> tuple[Grid, bool, int, int]:
    """``recurrence_grid``'s rule -> (the grid, whether it fits: its CTAs on
    the SMs of a direction and at least one staged row, the bytes a CTA
    needs with one staged row, the SMs a direction)."""
    if directions not in (1, 2):
        raise ValueError(f"lstm_seq: directions must be 1 or 2, got {directions}")
    sms //= directions
    units = units or -(-H // sms)
    hp = _padded_row(H)
    fixed = 4 * (4 * units * hp + 13 * B * units + 16) + 4 * B
    rows = min(B, (smem - fixed) // (4 * hp))
    grid = Grid(H, -(-H // units), units, rows, fixed + 4 * rows * hp, directions)
    return grid, grid.ctas <= sms and rows >= 1, fixed + 4 * hp, sms


def forward_route(H: int, B: int, sms: int = SMS, directions: int = 1,
                  smem: int = SMEM_PER_BLOCK) -> Grid | None:
    """The route of the forward recurrence for hidden width H and B >= 1
    utterances: ``recurrence_grid``'s grid wherever it fits, else None, the
    wide route (the per-utterance kernel, 6 H floats of shared memory a
    block).  Decided from the shapes alone.  Raises ValueError only where
    neither fits: H > 9,685 at the card's 232,448 bytes."""
    grid, fits, _, _ = _grid_shape(H, B, sms, smem, None, directions)
    if fits:
        return grid
    _check_per_utterance_fits(H, smem)
    return None


def _check_per_utterance_fits(H: int, smem: int) -> None:
    if 6 * H * 4 > smem:
        raise ValueError(f"lstm_seq: H {H} fits neither the co-resident grid nor the "
                         f"per-utterance kernel's {6 * H * 4} bytes of shared memory a "
                         f"block ({smem})")


def backward_grid(H: int, B: int, sms: int = SMS, smem: int = SMEM_PER_BLOCK,
                  directions: int = 1) -> Grid:
    """The grid of K3's backward recurrence for hidden width H and B
    utterances (K11's with ``directions`` 2).

    Each CTA holds its ``units`` rows of whh (4H fp32 each) in shared memory,
    ``rows`` staged dgates rows (4H fp32 each), and for each (utterance,
    unit) dh, dc and the 7 inputs of its cell; then B lengths
    (csrc/lstm_seq.cu::bwd_grid_smem_bytes).  ``units`` is ceil(H / sms),
    as the forward's.  ``rows`` is B where it fits, else as many as fit.
    ``directions`` 2 is K11's grid (ctas, 2): each direction gets ``sms //
    2`` SMs and its own CTAs, the same rule on each half.  Raises ValueError
    where the grid cannot hold whh's rows and one staged row on its SMs.
    """
    grid, fits, need, sms = _bwd_grid_shape(H, B, sms, smem, directions)
    if not fits:
        raise ValueError(
            f"lstm_seq_bwd: H {H} at B {B} does not fit the co-resident grid: {grid.ctas} CTAs "
            f"of {grid.units} units need {need} bytes of shared memory each ({grid.units} rows "
            f"of whh, one staged row of dgates, the state of {B} rows), on {sms} SMs of "
            f"{smem} bytes a direction")
    return grid


def _bwd_grid_shape(H: int, B: int, sms: int, smem: int,
                    directions: int) -> tuple[Grid, bool, int, int]:
    """``backward_grid``'s rule -> (the grid, whether it fits: its CTAs on
    the SMs of a direction and at least one staged row, the bytes a CTA
    needs with one staged row, the SMs a direction)."""
    if directions not in (1, 2):
        raise ValueError(f"lstm_seq_bwd: directions must be 1 or 2, got {directions}")
    sms //= directions
    units = -(-H // sms)
    fixed = 4 * (units * 4 * H + 9 * B * units) + 4 * B
    rows = min(B, (smem - fixed) // (16 * H))
    grid = Grid(H, -(-H // units), units, rows, fixed + 16 * rows * H, directions)
    return grid, grid.ctas <= sms and rows >= 1, fixed + 16 * H, sms


def backward_route(H: int, B: int, sms: int = SMS, smem: int = SMEM_PER_BLOCK,
                   directions: int = 1) -> Grid | None:
    """The route of K3's backward recurrence (K11's with ``directions`` 2)
    for hidden width H and B >= 1 utterances: ``backward_grid``'s grid
    wherever it fits, else None, the wide route (the per-utterance kernel, 6
    H floats of shared memory a block).  Decided from the shapes alone.
    Raises ValueError only where neither fits: H > 9,685 at the card's
    232,448 bytes."""
    grid, fits, _, _ = _bwd_grid_shape(H, B, sms, smem, directions)
    if fits:
        return grid
    _check_per_utterance_fits(H, smem)
    return None


def _projection(x, wih, bias):
    """(B, T, 4H) float32 ``x @ wih + bias``, ``x``'s type accumulated in float32."""
    return x.float() @ wih.to(x.dtype).float() + bias.float()


def lstm_seq_plain(x, wih, whh, bias, lengths, reverse: bool = False,
                   out_dtype: torch.dtype | None = None, h0: torch.Tensor | None = None,
                   c0: torch.Tensor | None = None):
    """Masked per-step loop, the plain version of the inference kernel.

    Matches ``pytorch_asr_tpu.models.encoder_bilstm._lstm_scan`` with the
    window mask: the projection ``x @ wih`` of ``x``'s type accumulates in
    float32 and adds ``bias``; the recurrence runs in float32 with gates
    i, f, g, o; the carry is held where ``t >= len``; ``reverse`` walks
    t = T-1 .. 0; the output is zero outside [0, len).

    Given a carried state ``h0``, ``c0`` (B, H) float32 (forward only), it
    starts there and returns ``(out, hT, cT)``, the state after each row's
    last valid step (``h0``, ``c0`` for a row of length 0): JAX's streaming
    ``_lstm_chunk``, the plain version of ``lstm_seq_stream``.  Then the
    projection runs a step at a time, B rows each, so that a sequence cut
    into chunks gives one pass's bits, as the kernel's does (its sum for an
    element runs in k order whatever the rows).
    """
    B, T, _ = x.shape
    H = whh.shape[0]
    carry = h0 is not None
    if carry and reverse:
        raise ValueError("lstm_seq_plain: a carried state walks forward only")
    whh = whh.float()
    lengths = lengths.to(x.device)
    if carry:
        h, c = h0.float(), c0.float()
        step_proj = lambda t: _projection(x[:, t], wih, bias)        # noqa: E731
    else:
        h = x.new_zeros((B, H), dtype=torch.float32)
        c = torch.zeros_like(h)
        xproj = _projection(x, wih, bias)                            # (B, T, 4H)
        step_proj = lambda t: xproj[:, t]                            # noqa: E731
    out = x.new_zeros((B, T, H), dtype=torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (step_proj(t) + h @ whh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = (t < lengths)[:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = torch.where(m, h_new, 0.0)
    out = out.to(out_dtype or torch.float32)
    return (out, h, c) if carry else out


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
    """Inference forward (K2): the kernel for CUDA tensors (the grid, or the
    wide route: ``forward_route``), ``lstm_seq_plain`` for CPU."""
    if x.device.type == "cpu":
        return lstm_seq_plain(x, wih, whh, bias, lengths, reverse, out_dtype)
    return _forward(1, x, wih, whh, bias, lengths, reverse, out_dtype, None)


def lstm_seq_stream(x, wih, whh, bias, lengths, h0, c0,
                    out_dtype: torch.dtype | None = None, reverse: bool = False):
    """K2 from a carried state -> (out (B, T, H), hT, cT): the streaming
    recognizer's chunk.  ``h0``, ``c0``, ``hT``, ``cT`` are (B, H) float32;
    the state after each row's last valid step, or ``h0``, ``c0`` for a row
    of length 0; other arguments as ``lstm_seq``'s.  The kernel for CUDA
    tensors (``forward_route``'s grid, counted ``lstm_seq_stream``, or past it
    the per-utterance kernel, ``lstm_seq_stream_wide``: ``stream_on_route``),
    ``lstm_seq_plain`` with the carry for CPU.  Inference only, forward only:
    it raises under autograd and for ``reverse``.  Chunks of a sequence give
    the bits of one launch over it (the same projection sums and steps)."""
    if reverse:
        raise ValueError("lstm_seq_stream: a carried state walks forward only")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wih, whh, bias, h0, c0)):
        raise RuntimeError("lstm_seq_stream: inference only; it has no backward")
    if x.device.type == "cpu":
        return lstm_seq_plain(x, wih, whh, bias, lengths, False, out_dtype, h0, c0)
    route = forward_route(whh.shape[0], max(x.shape[0], 1), build.sm_count(x.device.index))
    return stream_on_route(route, x, wih, whh, bias, lengths, h0, c0, out_dtype)


def stream_on_route(route: Grid | None, x, wih, whh, bias, lengths, h0, c0,
                    out_dtype: torch.dtype | None = None):
    """``lstm_seq_stream`` on CUDA tensors on ``route``: a ``Grid`` (the
    co-resident grid kernel, counted ``lstm_seq_stream``) or None (the
    per-utterance kernel, ``lstm_seq_stream_wide``); the two give the same
    bits.  -> (out, hT, cT)."""
    out_dtype = out_dtype or torch.float32
    _check_cuda_args(x, wih, whh, bias, lengths, out_dtype)
    B, T, _ = x.shape
    H = whh.shape[0]
    for what, t in (("h0", h0), ("c0", c0)):
        if (tuple(t.shape) != (B, H) or t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"lstm_seq_stream: {what} must be ({B}, {H}) float32 on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype}")
    if route is not None and (route.hidden != H or route.directions != 1):
        raise ValueError(f"lstm_seq_stream: a grid for H {route.hidden} and "
                         f"{route.directions} direction(s), not H {H} and 1")
    out = torch.empty((B, T, H), dtype=out_dtype, device=x.device)
    state_in = torch.stack([h0, c0])
    if B == 0 or T == 0:
        return out, state_in[0], state_in[1]
    state_out = torch.empty_like(state_in)
    xproj = torch.empty((B, T, 4 * H), dtype=torch.float32, device=x.device)
    hbuf = torch.empty((2, B, H), dtype=torch.float32, device=x.device)
    sync = torch.zeros(1, dtype=torch.int32, device=x.device)
    lib = build.load("lstm_seq", _SIGNATURES)
    ptrs = [t.data_ptr() for t in (x, wih, whh, bias, lengths, xproj, hbuf, sync, state_in,
                                   state_out, out)]
    grid = route or Grid(H, 0, 0, 0, 0)
    name = "lstm_seq_stream" if route is not None else "lstm_seq_stream_wide"
    build.check(lib.lstm_seq_stream(*ptrs, B, T, x.shape[2], H, int(x.dtype == torch.bfloat16),
                                    int(out_dtype == torch.bfloat16), grid.ctas, grid.units,
                                    grid.rows, grid.smem, _stream(x)), name)
    build.LAUNCHES[name] += 1
    return out, state_out[0], state_out[1]


def lstm_seq_train_fwd(x, wih, whh, bias, lengths, reverse: bool = False,
                       out_dtype: torch.dtype | None = None,
                       residual_dtype: torch.dtype = torch.bfloat16):
    """Training forward (K3) -> (out, acts, ct); see ``lstm_seq_train_plain``."""
    if x.device.type == "cpu":
        return lstm_seq_train_plain(x, wih, whh, bias, lengths, reverse, out_dtype,
                                    residual_dtype)
    return _forward(1, x, wih, whh, bias, lengths, reverse, out_dtype, residual_dtype)


def _outputs(dirs: int, x, H: int, out_dtype, residual_dtype):
    """(out, acts, ct) of a forward launch on one direction or both, acts
    and ct None for the inference forward."""
    if residual_dtype is not None and residual_dtype not in _DTYPES:
        raise ValueError(f"lstm_seq: residual_dtype must be float32 or bfloat16, "
                         f"got {residual_dtype}")
    B, T, _ = x.shape
    lead = (dirs,) if dirs == 2 else ()
    out = torch.empty((B, T, dirs * H), dtype=out_dtype, device=x.device)
    if residual_dtype is None:
        return out, None, None
    return (out, torch.empty((*lead, T, B, 4 * H), dtype=residual_dtype, device=x.device),
            torch.empty((*lead, T, B, H), dtype=residual_dtype, device=x.device))


def _forward(dirs: int, x, wih, whh, bias, lengths, reverse, out_dtype, residual_dtype):
    """The ops' forward on CUDA tensors, one direction or both (K11): the
    grid where ``forward_route`` gives one, else the wide route."""
    out_dtype = out_dtype or torch.float32
    (_check_dual_args if dirs == 2 else _check_cuda_args)(x, wih, whh, bias, lengths, out_dtype)
    grid = forward_route(whh.shape[-2], max(x.shape[0], 1), build.sm_count(x.device.index), dirs)
    if grid is None:
        return _per_utterance(dirs, WIDE[dirs][residual_dtype is not None], x, wih, whh, bias,
                              lengths, reverse, out_dtype, residual_dtype)
    return _launch_grid(grid, dirs, x, wih, whh, bias, lengths, reverse, out_dtype,
                        residual_dtype, None)


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
    _check_trace(trace, T, x.device)
    H = whh.shape[-2]
    train = residual_dtype is not None
    out, acts, ct = _outputs(dirs, x, H, out_dtype, residual_dtype)
    if B == 0 or T == 0:
        return (out, acts, ct) if train else out
    grid = grid or recurrence_grid(H, B, build.sm_count(x.device.index), directions=dirs)
    if grid.hidden != H or grid.directions != dirs:
        raise ValueError(f"lstm_seq: a grid for H {grid.hidden} and {grid.directions} "
                         f"direction(s), not H {H} and {dirs}")
    lead = (dirs,) if dirs == 2 else ()
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
    """Backward (K3) -> (dx, dwih, dwhh, db); see ``lstm_seq_bwd_plain``.
    For CUDA tensors the dh recurrence takes ``backward_route``'s route:
    the grid, or past it the per-utterance kernel (``backward_on_route``)."""
    if x.device.type == "cpu":
        return lstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct, reverse)
    route = backward_route(whh.shape[0], max(x.shape[0], 1), build.sm_count(x.device.index))
    return backward_on_route(route, gy, x, wih, whh, lengths, acts, ct, reverse)


def backward_on_route(route: Grid | None, gy, x, wih, whh, lengths, acts, ct,
                      reverse: bool = False, trace: torch.Tensor | None = None,
                      scratch: dict | None = None):
    """K3's backward on CUDA tensors -> (dx, dwih, dwhh, db): the dh
    recurrence on ``route``, a ``Grid`` (counted as ``lstm_seq_bwd``) or, as
    ``backward_route`` gives past the grid, None: the per-utterance kernel
    (``lstm_seq_bwd_wide``); then the products.  ``trace``, on a grid only,
    a contiguous int64 (T, 5) tensor on the card, receives in row s CTA 0's
    timestamps of step s (max(len) steps): the global timer in ns as the
    step starts, and the SM clock in cycles then, after staging dgates and
    the cell inputs, after the dh chains and after the cells.  ``scratch``,
    a dict, receives the recurrence's outputs ``dgates`` (B, T, 4H) and
    ``hprev`` (B, T, H)."""
    return _backward(1, route, None, gy, x, wih, whh, lengths, acts, ct, reverse, trace, scratch)


def _backward(dirs: int, route: Grid | None, name: str | None, gy, x, wih, whh, lengths, acts,
              ct, reverse: bool, trace, scratch):
    """The backward of one direction (K3) or both (K11) on CUDA tensors:
    the dh recurrence on ``route`` (a grid, or None: the per-utterance
    kernel), then the products; counted under ``name``, by default
    ``lstm_seq_bwd`` / ``bilstm_seq_bwd`` on a grid and ``..._wide`` off it."""
    B, T, D = x.shape
    H = whh.shape[-2]
    stem = "lstm_seq_bwd" if dirs == 1 else "bilstm_seq_bwd"
    lead = (dirs,) if dirs == 2 else ()
    gy = gy.float().contiguous()
    check = _check_dual_args if dirs == 2 else _check_cuda_args
    check(x, wih, whh, whh.new_empty((*lead, 4 * H)), lengths, torch.float32)
    for what, t, shape in (("gy", gy, (B, T, dirs * H)), ("acts", acts, (*lead, T, B, 4 * H)),
                           ("ct", ct, (*lead, T, B, H))):
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{stem}: {what} must be contiguous {shape} on "
                             f"{x.device}, got {tuple(t.shape)}")
    if acts.dtype != ct.dtype or acts.dtype not in _DTYPES:
        raise ValueError(f"{stem}: residuals must share a type of {_DTYPES}")
    _check_trace(trace, T, x.device)
    if route is None and trace is not None:
        raise ValueError(f"{stem}: only the grid records a trace")
    if route is not None and (route.hidden != H or route.directions != dirs):
        raise ValueError(f"{stem}: a grid for H {route.hidden} and {route.directions} "
                         f"direction(s), not H {H} and {dirs}")
    dx = torch.empty_like(x)
    dwih = torch.empty_like(wih)
    dwhh = torch.empty_like(whh)
    db = torch.empty((*lead, 4 * H), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return dx.zero_(), dwih.zero_(), dwhh.zero_(), db.zero_()
    dgates = torch.empty((*lead, B, T, 4 * H), dtype=torch.float32, device=x.device)
    hprev = torch.empty((*lead, B, T, H), dtype=torch.float32, device=x.device)
    if scratch is not None:
        scratch.update(dgates=dgates, hprev=hprev)
    halves = [torch.empty((2, B, T, D), dtype=x.dtype, device=x.device)] if dirs == 2 else []
    lib = build.load("lstm_seq", _SIGNATURES)
    ptrs = [t.data_ptr() for t in (gy, x, wih, whh, lengths, acts, ct, dgates, hprev, *halves,
                                   dx, dwih, dwhh, db)]
    flags = [B, T, D, H] + ([int(reverse)] if dirs == 1 else [])
    flags += [int(x.dtype == torch.bfloat16), int(acts.dtype == torch.bfloat16)]
    if route is None:
        name = name or f"{stem}_wide"
        err = getattr(lib, f"{stem}_per_utterance")(*ptrs, *flags, _stream(x))
    else:
        name = name or stem
        sync = torch.zeros(1, dtype=torch.int32, device=x.device)
        err = getattr(lib, stem)(*ptrs, sync.data_ptr(), 0 if trace is None else trace.data_ptr(),
                                 *flags, route.ctas, route.units, route.rows, route.smem,
                                 _stream(x))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return dx, dwih, dwhh, db


def _check_trace(trace, T: int, device) -> None:
    if trace is not None and (tuple(trace.shape) != (T, 5) or trace.dtype != torch.int64
                              or trace.device != device or not trace.is_contiguous()):
        raise ValueError(f"lstm_seq: trace must be contiguous ({T}, 5) int64 on {device}")


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
    """K11's inference forward: the dual grid (or the wide route:
    ``forward_route``) for CUDA tensors, ``bilstm_seq_plain`` for CPU."""
    if x.device.type == "cpu":
        return bilstm_seq_plain(x, wih, whh, bias, lengths, out_dtype)
    return _forward(2, x, wih, whh, bias, lengths, False, out_dtype, None)


def bilstm_seq_train_fwd(x, wih, whh, bias, lengths, out_dtype: torch.dtype | None = None,
                         residual_dtype: torch.dtype = torch.bfloat16):
    """K11's training forward -> (out, acts, ct); see ``bilstm_seq_train_plain``."""
    if x.device.type == "cpu":
        return bilstm_seq_train_plain(x, wih, whh, bias, lengths, out_dtype, residual_dtype)
    return _forward(2, x, wih, whh, bias, lengths, False, out_dtype, residual_dtype)


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
    return _per_utterance(2, "bilstm_seq_per_utterance", x, wih, whh, bias, lengths, False,
                          out_dtype, residual_dtype)


def _per_utterance(dirs: int, name: str, x, wih, whh, bias, lengths, reverse, out_dtype,
                   residual_dtype):
    """Launch the per-utterance kernel, one direction (``lstm_seq_per_utterance``)
    or both, on checked CUDA inputs, counted under ``name``."""
    train = residual_dtype is not None
    B, T, D = x.shape
    H = whh.shape[-2]
    out, acts, ct = _outputs(dirs, x, H, out_dtype, residual_dtype)
    if B and T:
        lead = (dirs,) if dirs == 2 else ()
        xproj = torch.empty((*lead, B, T, 4 * H), dtype=torch.float32, device=x.device)
        lib = build.load("lstm_seq", _SIGNATURES)
        ptrs = [t.data_ptr() if t is not None else 0
                for t in (x, wih, whh, bias, lengths, xproj, out, acts, ct)]
        flags = [B, T, D, H] + ([int(reverse)] if dirs == 1 else [])
        flags += [int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(train),
                  int(residual_dtype == torch.bfloat16)]
        entry = "lstm_seq_per_utterance" if dirs == 1 else "bilstm_seq_per_utterance"
        build.check(getattr(lib, entry)(*ptrs, *flags, _stream(x)), name)
        build.LAUNCHES[name] += 1
    return (out, acts, ct) if train else out


def bilstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct):
    """K11's backward -> (dx, dwih, dwhh, db); see ``bilstm_seq_bwd_plain``.
    For CUDA tensors the dh recurrence takes ``backward_route``'s route with
    directions 2: the dual grid, or past it the per-utterance kernel
    (``bilstm_backward_on_route``)."""
    if x.device.type == "cpu":
        return bilstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct)
    route = backward_route(whh.shape[-2], max(x.shape[0], 1), build.sm_count(x.device.index),
                           directions=2)
    return bilstm_backward_on_route(route, gy, x, wih, whh, lengths, acts, ct)


def bilstm_backward_on_route(route: Grid | None, gy, x, wih, whh, lengths, acts, ct,
                             trace: torch.Tensor | None = None, scratch: dict | None = None):
    """K11's backward on CUDA tensors -> (dx, dwih (2, D, 4H), dwhh (2, H,
    4H), db (2, 4H)): the dh recurrence of both directions on ``route``, a
    dual ``Grid`` (``backward_grid`` with directions 2; counted as
    ``bilstm_seq_bwd``) or None, the per-utterance kernel
    (``bilstm_seq_bwd_wide``); then K3's products once a direction and dx
    summed.  ``trace`` and ``scratch`` as ``backward_on_route``'s (the trace
    CTA (0, 0)'s, the forward direction's; dgates (2, B, T, 4H) and hprev
    (2, B, T, H))."""
    return _backward(2, route, None, gy, x, wih, whh, lengths, acts, ct, False, trace, scratch)


def _bilstm_seq_bwd_per_utterance(gy, x, wih, whh, lengths, acts, ct,
                                  scratch: dict | None = None):
    """The oracle of K11's backward grid: the per-utterance kernel, a block
    an utterance and direction, CUDA tensors only, under its own launch
    count (``bilstm_seq_bwd_per_utterance``); only the card tests and
    ``chip_smoke.py`` call it."""
    return _backward(2, None, "bilstm_seq_bwd_per_utterance", gy, x, wih, whh, lengths, acts,
                     ct, False, None, scratch)


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
