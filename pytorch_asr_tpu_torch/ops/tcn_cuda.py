"""The fused TCN block: the CUDA kernels of ``csrc/tcn_block.cu`` and their plain versions.

Counterpart of ``pytorch_asr_tpu/ops/dilated_conv_pallas.py``: the inference
block with its residual (K5, ``tcn_block``), and the training pair (K6):
``tcn_block_train_fwd`` returns the block body and the normalized input,
``tcn_block_bwd`` the gradients of the body; ``TCNBlockTrain`` puts them
under autograd, with the LayerNorm backward in plain torch as the JAX
package leaves it to XLA.  Each wrapper takes its plain PyTorch version for
CPU tensors and launches its kernel for CUDA tensors; there is no other
switch and no fallback.

Layouts are the JAX package's: x (B, T, C); ln_scale, ln_bias (C,); w_conv
(K, C, 2Cm), the K taps of a non-causal conv of dilation d, tap k reading
frame t + (k - K//2) d; b_conv (2Cm,), the lin half then the gate half;
w_point (Cm, C); b_point (C,).  Parameters are float32.  The GLU half-width
Cm is C in the model's block; a model rank of the tensor-parallel block
(``models/encoder_tcn.py``) runs the training pair on its slice, Cm = C / m,
read off the weights as the JAX kernel reads it.  Its launches count under
``tcn_block_train_fwd_split`` and ``tcn_block_bwd_split``.  K5 is square.

Parity trap: frames outside [0, T) of the padded batch read 0 in the conv,
but frames past an utterance's length inside [0, T) are whatever the model
left there (0), and their LayerNorm output is ``ln_bias``, not 0; the last
valid frames' taps read it.  Both JAX paths do this (``_tcn_block_kernel``
zeroes xn only outside [0, T)), and so does the port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorch_asr_tpu_torch.ops import build

EPS = 1e-6    # the block LayerNorm's epsilon (torch's default is 1e-5)
HALO = 32     # the JAX kernel's halo: it takes dilation * (K // 2) <= 32
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tcn_block_fwd": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
               "tcn_block_bwd_workspace": [_I] * 5,
               "tcn_block_bwd": [_P] * 11 + [_I] * 6 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)


def check_dilation(w_conv: torch.Tensor, dilation: int) -> None:
    """The JAX kernel's limit, kept so both packages accept the same configs."""
    K = w_conv.shape[0]
    if dilation * (K // 2) > HALO:
        raise ValueError(f"dilation {dilation} x half-kernel {K // 2} exceeds halo {HALO}")


def layer_norm(x: torch.Tensor, ln_scale, ln_bias) -> torch.Tensor:
    """The block's LayerNorm in float32: mean, then the mean of (x - mean)^2."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + EPS) * ln_scale + ln_bias


def _taps(xn: torch.Tensor, K: int, dilation: int) -> list[torch.Tensor]:
    """xs_k[:, t] = xn[:, t + (k - K//2) d], 0 outside [0, T), for k < K."""
    T, pad = xn.shape[1], (K // 2) * dilation
    padded = F.pad(xn, (0, 0, pad, pad))
    return [padded[:, k * dilation: k * dilation + T] for k in range(K)]


def _pre(xs: list[torch.Tensor], w_conv, b_conv) -> torch.Tensor:
    """The conv's (B, T, 2Cm) output, summed tap by tap, plus the bias."""
    return sum(x_k @ w_k for x_k, w_k in zip(xs, w_conv)) + b_conv


def tcn_block_train_fwd_plain(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                              dilation: int):
    """-> (y, xn), both (B, T, C) float32: the block body without its
    residual, y = P(GLU(conv(LN(x)))), and LN(x) (``_tcn_fwd_train_kernel``),
    at any GLU half-width Cm (``w_point.shape[0]``)."""
    xn = layer_norm(x, ln_scale, ln_bias)
    lin, gate = _pre(_taps(xn, w_conv.shape[0], dilation), w_conv, b_conv).chunk(2, dim=-1)
    return (lin * torch.sigmoid(gate)) @ w_point + b_point, xn


def tcn_block_plain(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                    dilation: int) -> torch.Tensor:
    """x + the block body, the sum in float32, in x's type (``_tcn_block_kernel``)."""
    y, _ = tcn_block_train_fwd_plain(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                                     dilation)
    return (x.float() + y).to(x.dtype)


def tcn_block_bwd_plain(xn, dy, w_conv, b_conv, w_point, dilation: int):
    """Gradients of the block body from xn and dy -> (dxn, dw_conv, db_conv,
    dw_point, db_point), float32 (``_tcn_bwd_kernel``).  The GLU tensors are
    recomputed from xn; dxn is the transposed conv: dacc at frame t reaches
    xn frame t + (k - K//2) d through tap k."""
    K = w_conv.shape[0]
    xs = _taps(xn, K, dilation)
    lin, gate = _pre(xs, w_conv, b_conv).chunk(2, dim=-1)
    sg = torch.sigmoid(gate)
    glu = lin * sg
    dy = dy.float()
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dglu = dy @ w_point.T
    dacc = torch.cat([dglu * sg, dglu * lin * sg * (1.0 - sg)], dim=-1)
    dwc = torch.stack([rows(x_k).T @ rows(dacc) for x_k in xs])
    B, T, C = xn.shape
    pad = (K // 2) * dilation
    dpad = xn.new_zeros((B, T + 2 * pad, C))
    for k in range(K):
        dpad[:, k * dilation: k * dilation + T] += dacc @ w_conv[k].T
    return (dpad[:, pad: pad + T], dwc, rows(dacc).sum(0), rows(glu).T @ rows(dy),
            rows(dy).sum(0))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _counted(name: str, C: int, Cm: int) -> str:
    """The launch count's name: a split width counts apart from the square block."""
    return name if Cm == C else f"{name}_split"


def _check_cuda_args(name: str, x, params: dict, square: bool = False) -> int:
    """Check the shapes, types and places of a launch's tensors; returns Cm."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    C = x.shape[2]
    K = params["w_conv"].shape[0] if params["w_conv"].dim() == 3 else 0
    Cm = C if square else params["w_point"].shape[0]     # w_point is (Cm, C)
    shapes = {"ln_scale": (C,), "ln_bias": (C,), "w_conv": (K, C, 2 * Cm), "b_conv": (2 * Cm,),
              "w_point": (Cm, C), "b_point": (C,), "xn": x.shape, "dy": x.shape}
    for key, t in params.items():
        if tuple(t.shape) != tuple(shapes[key]) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be {tuple(shapes[key])} float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (x, *params.values()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: all inputs must be contiguous on one CUDA device")
    return Cm


def _fwd(name: str, x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point, dilation,
         residual: bool):
    """Launch ``tcn_block_fwd``: K5 with the residual (square), else the K6
    forward at the weights' Cm."""
    Cm = _check_cuda_args(name, x, {"ln_scale": ln_scale, "ln_bias": ln_bias,
                                    "w_conv": w_conv, "b_conv": b_conv, "w_point": w_point,
                                    "b_point": b_point}, square=residual)
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    B, T, C = x.shape
    xn = torch.empty((B, T, C), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x) if residual else torch.empty_like(xn)
    if B * T == 0:
        return out, xn
    glu = torch.empty((B, T, Cm), dtype=torch.float32, device=x.device)
    lib = build.load("tcn_block", _SIGNATURES)
    err = lib.tcn_block_fwd(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_conv.data_ptr(),
        b_conv.data_ptr(), w_point.data_ptr(), b_point.data_ptr(), xn.data_ptr(),
        glu.data_ptr(), out.data_ptr(), B, T, C, Cm, w_conv.shape[0], dilation, EPS,
        int(x.dtype == torch.bfloat16), int(residual), _stream(x))
    build.check(err, name)
    build.LAUNCHES[_counted(name, C, Cm)] += 1
    return out, xn


def tcn_block(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
              dilation: int) -> torch.Tensor:
    """Inference block (K5): x + P(GLU(conv(LN(x)))), summed in float32, in
    x's type (float32 or bfloat16).  The caller masks padded frames."""
    check_dilation(w_conv, dilation)
    if x.device.type == "cpu":
        return tcn_block_plain(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                               dilation)
    return _fwd("tcn_block", x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point, dilation,
                residual=True)[0]


def tcn_block_train_fwd(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                        dilation: int):
    """Training forward (K6) -> (y, xn); see ``tcn_block_train_fwd_plain``."""
    check_dilation(w_conv, dilation)
    if x.device.type == "cpu":
        return tcn_block_train_fwd_plain(x, ln_scale, ln_bias, w_conv, b_conv, w_point,
                                         b_point, dilation)
    return _fwd("tcn_block_train_fwd", x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                dilation, residual=False)


def tcn_block_bwd(xn, dy, w_conv, b_conv, w_point, dilation: int):
    """Backward (K6) -> (dxn, dw_conv, db_conv, dw_point, db_point); see
    ``tcn_block_bwd_plain``."""
    check_dilation(w_conv, dilation)
    if xn.device.type == "cpu":
        return tcn_block_bwd_plain(xn, dy, w_conv, b_conv, w_point, dilation)
    dy = dy.float().contiguous()
    Cm = _check_cuda_args("tcn_block_bwd", xn, {"xn": xn, "dy": dy, "w_conv": w_conv,
                                                "b_conv": b_conv, "w_point": w_point})
    B, T, C = xn.shape
    K = w_conv.shape[0]
    dxn = torch.empty_like(xn)
    grads = [torch.empty_like(t) for t in (w_conv, b_conv, w_point)]
    dbp = torch.empty(C, dtype=torch.float32, device=xn.device)
    if B * T == 0:
        return dxn, *(g.zero_() for g in grads), dbp.zero_()
    lib = build.load("tcn_block", _SIGNATURES)
    ws = torch.empty(lib.tcn_block_bwd_workspace(B, T, C, Cm, K), dtype=torch.float32,
                     device=xn.device)
    err = lib.tcn_block_bwd(
        xn.data_ptr(), dy.data_ptr(), w_conv.data_ptr(), b_conv.data_ptr(), w_point.data_ptr(),
        ws.data_ptr(), dxn.data_ptr(), *(g.data_ptr() for g in grads), dbp.data_ptr(),
        B, T, C, Cm, K, dilation, _stream(xn))
    build.check(err, "tcn_block_bwd")
    build.LAUNCHES[_counted("tcn_block_bwd", C, Cm)] += 1
    return dxn, *grads, dbp


def layer_norm_bwd(x, ln_scale, dxn):
    """LayerNorm backward in plain torch -> (dx in x's type, d ln_scale,
    d ln_bias), as ``_train_vjp_bwd`` runs it in XLA."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (xf - mu) * rstd
    dxhat = dxn * ln_scale
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), (dxn * xhat).sum((0, 1)), dxn.sum((0, 1))


class TCNBlockTrain(torch.autograd.Function):
    """The training pair: K6's forward saves x and xn, its backward
    recomputes the GLU tensors from xn; the LayerNorm backward follows in
    plain torch."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point, dilation):
        y, xn = tcn_block_train_fwd(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                                    dilation)
        ctx.save_for_backward(x, xn, ln_scale, w_conv, b_conv, w_point)
        ctx.dilation = dilation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, xn, ln_scale, w_conv, b_conv, w_point = ctx.saved_tensors
        dxn, dwc, dbc, dwp, dbp = tcn_block_bwd(xn, dy, w_conv, b_conv, w_point, ctx.dilation)
        dx, dln_scale, dln_bias = layer_norm_bwd(x, ln_scale, dxn)
        return dx, dln_scale, dln_bias, dwc, dbc, dwp, dbp, None


def tcn_block_train(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                    dilation: int) -> torch.Tensor:
    """Training-path block body y = P(GLU(conv(LN(x)))), float32, without the
    residual (the model adds dropout, the residual and the mask);
    differentiable in all seven tensors through K6."""
    return TCNBlockTrain.apply(x, ln_scale, ln_bias, w_conv, b_conv, w_point, b_point,
                               dilation)
