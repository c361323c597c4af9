"""TCN encoder (counterpart of ``pytorch_asr_tpu.models.encoder_tcn``; BASELINE config 3).

A strided conv stem subsamples time, then residual blocks of non-causal
dilated 1-D convs (LayerNorm -> dilated conv -> GLU -> pointwise -> dropout
-> + x) and a final LayerNorm.  The blocks run through ``ops.tcn_cuda``: the
inference kernel (K5) in eval, the training pair (K6) in training.
Parameters keep the JAX names and layouts, so ``weights.load_jax_params``
loads a JAX tree as it is.  Under a mesh whose model axis m > 1 divides the
channels, each block splits its GLU over the model ranks, as the JAX
package's ``TCNBlock._tp_pallas`` does (``TCNBlock._split``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import TCNEncoderConfig
from pytorch_asr_tpu_torch.models.encoder_bilstm import conv_out_len, dropout
from pytorch_asr_tpu_torch.ops import tcn_cuda
from pytorch_asr_tpu_torch.parallel.mesh import active_mesh, copy_to_model, reduce_from_model

FINAL_LN_EPS = 1e-6   # flax nn.LayerNorm's default (torch's is 1e-5)


def _mask_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    return torch.where(mask[..., None], x, 0.0)


class FinalLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=x.dtype)``: float32 statistics with the fast
    variance max(E[x^2] - E[x]^2, 0), (x - mean) * (rsqrt(var + eps) * scale)
    + bias, cast back to x's type.  ``torch.nn.LayerNorm`` differs in its
    variance and its default eps."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True) - mu.square(), min=0.0)
        return ((xf - mu) * (torch.rsqrt(var + FINAL_LN_EPS) * self.weight)
                + self.bias).to(x.dtype)


class TCNBlock(nn.Module):
    """Residual block: LN -> dilated conv -> GLU -> pointwise -> dropout -> + x.

    ``train`` picks the path, as in the JAX package.  Training runs the K6
    pair for the float32 body y, then dropout and the residual in the
    compute dtype, ``x + y.to(x.dtype)``, as the JAX Pallas training path
    does; with or without autograd recording.  Inference is one K5 call,
    which adds the residual in float32 and returns x's type, as the JAX
    Pallas inference path does.  K5 has no backward, so inference with
    gradients runs the K6 pair and the same float32 sum, the same numbers as
    K5.  Either way padded frames are masked after the block.
    """

    def __init__(self, channels: int, kernel_size: int, dilation: int, dropout_rate: float):
        super().__init__()
        C, K = channels, kernel_size
        self.channels, self.dilation, self.dropout = C, dilation, dropout_rate
        self.ln_scale = nn.Parameter(torch.empty(C))
        self.ln_bias = nn.Parameter(torch.empty(C))
        self.w_conv = nn.Parameter(torch.empty(K, C, 2 * C))
        self.b_conv = nn.Parameter(torch.empty(2 * C))
        self.w_point = nn.Parameter(torch.empty(C, C))
        self.b_point = nn.Parameter(torch.empty(C))

    def _split(self, x: torch.Tensor, lengths: torch.Tensor, train: bool,
               generator: torch.Generator | None, mesh) -> torch.Tensor:
        """Model rank k of m runs the block body through K6 at width cm = C / m
        on its GLU pairs: w_conv's lin columns [k cm, (k+1) cm) with their
        gate columns C + the same, the matching w_point rows, and b_point / m
        (summed back whole); the bodies sum over the model ranks, then
        dropout, ``x + y`` and the mask, in training and in eval, as JAX's
        ``_tp_pallas`` (whose eval reuses the body-only kernel too: K5
        would add x on every rank).  x's gradient sums over the ranks; each
        rank's weight gradients are its part."""
        C, m, k = self.channels, mesh.model, mesh.model_index
        cm = C // m
        lin, gate = slice(k * cm, (k + 1) * cm), slice(C + k * cm, C + (k + 1) * cm)
        w = [self.ln_scale.contiguous(), self.ln_bias.contiguous(),
             torch.cat([self.w_conv[:, :, lin], self.w_conv[:, :, gate]], dim=2),
             torch.cat([self.b_conv[lin], self.b_conv[gate]]),
             self.w_point[lin].contiguous(), self.b_point / m]
        y = tcn_cuda.tcn_block_train(copy_to_model(x, mesh).contiguous(), *w, self.dilation)
        y = reduce_from_model(y, mesh)
        if train and self.dropout > 0:
            y = dropout(y, self.dropout, generator)
        return _mask_time(x + y.to(x.dtype), lengths)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        mesh = active_mesh()
        if mesh is not None and mesh.model > 1 and self.channels % mesh.model == 0:
            return self._split(x, lengths, train, generator, mesh)
        w = [t.contiguous() for t in (self.ln_scale, self.ln_bias, self.w_conv, self.b_conv,
                                      self.w_point, self.b_point)]
        # Frames past a row's length are 0 here, but the block's LayerNorm
        # turns them into ln_bias and the last valid frames' taps read it:
        # only the mask below zeroes them again, as in both JAX paths.
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w))
        if train:
            y = tcn_cuda.tcn_block_train(x.contiguous(), *w, self.dilation)
            if self.dropout > 0:
                y = dropout(y, self.dropout, generator)
            out = x + y.to(x.dtype)
        elif needs_grad:
            y = tcn_cuda.tcn_block_train(x.contiguous(), *w, self.dilation)
            out = (x.float() + y).to(x.dtype)
        else:
            out = tcn_cuda.tcn_block(x.contiguous(), *w, self.dilation)
        return _mask_time(out, lengths)


class TCNEncoder(nn.Module):
    """(B, T, n_mels) features -> ((B, T / subsample, channels), lengths)."""

    def __init__(self, cfg: TCNEncoderConfig, n_mels: int, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        k = 2 * cfg.subsample
        # Fixed symmetric padding: valid outputs do not depend on batch padding.
        # The Conv1d holds the stem's weights, stride and padding; ``forward``
        # calls F.conv1d itself, in the compute dtype.
        self.stem = nn.utils.skip_init(nn.Conv1d, n_mels, cfg.channels, k,
                                       stride=cfg.subsample, padding=(k - 1) // 2)
        self.blocks = nn.ModuleList(
            TCNBlock(cfg.channels, cfg.kernel_size,
                     cfg.dilation_cycle[i % len(cfg.dilation_cycle)], cfg.dropout)
            for i in range(cfg.num_blocks))
        self.final_ln = FinalLayerNorm(cfg.channels)

    def subsampled_len(self, feat_len: torch.Tensor) -> torch.Tensor:
        return conv_out_len(feat_len, 2 * self.cfg.subsample, self.cfg.subsample)

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        # The stem is F.conv1d in the compute dtype (cuDNN on the card): the
        # JAX package leaves it to XLA's convolution, with no Pallas kernel.
        dt = self.dtype
        x = F.conv1d(feats.to(dt).transpose(1, 2), self.stem.weight.to(dt),
                     self.stem.bias.to(dt), stride=self.stem.stride, padding=self.stem.padding)
        lengths = self.subsampled_len(feat_len)
        x = _mask_time(F.relu(x).transpose(1, 2), lengths)
        for block in self.blocks:
            x = block(x, lengths, train, generator)
        x = self.final_ln(x)
        return _mask_time(x, lengths), lengths
