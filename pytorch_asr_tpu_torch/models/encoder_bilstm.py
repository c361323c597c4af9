"""conv + BiLSTM encoder (counterpart of ``pytorch_asr_tpu.models.encoder_bilstm``).

Layout follows the JAX package so its weights load as they are:
the conv output is ordered ``f*C + c`` into the first LSTM layer, the convs
pad a fixed ``(k-1)//2`` on both sides, and the LSTM weights keep the JAX
layout ``wih (D, 4H)``, ``whh (H, 4H)``, ``bias (4H,)`` that the kernel takes.
The causal conv, unidirectional stacks and direction-sharded tensor
parallelism are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import BiLSTMEncoderConfig
from pytorch_asr_tpu_torch.ops import lstm_cuda


def conv_out_len(length: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Valid output length of a strided conv with fixed symmetric padding
    ``(kernel-1)//2``, so valid positions do not depend on batch padding."""
    p = (kernel - 1) // 2
    return torch.clamp((length + 2 * p - kernel) // stride + 1, min=0)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability 1 - rate, drawn
    from ``generator``, and scale the kept ones by 1 / (1 - rate) in x's type.
    (``F.dropout`` takes no generator.)"""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def _conv_out_size(size: int, kernel: int, stride: int) -> int:
    return max((size + 2 * ((kernel - 1) // 2) - kernel) // stride + 1, 0)


class ConvSubsampler(nn.Module):
    """Strided 2-D conv stack over (time, freq), ReLU and a re-mask after each.

    Convolutions run as ``F.conv2d`` in the compute dtype (the JAX package
    leaves them to XLA's convolution; they have no hand-written kernel).
    """

    def __init__(self, cfg: BiLSTMEncoderConfig, n_mels: int, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        kt, kf = cfg.conv_kernel
        self.padding = ((kt - 1) // 2, (kf - 1) // 2)
        chans = (1, *cfg.conv_channels)
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv2d, chans[i], chans[i + 1], tuple(cfg.conv_kernel),
                               stride=tuple(cfg.conv_stride), padding=self.padding)
            for i in range(len(cfg.conv_channels)))
        freq = n_mels
        for _ in cfg.conv_channels:
            freq = _conv_out_size(freq, kf, cfg.conv_stride[1])
        self.out_dim = freq * cfg.conv_channels[-1]

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor):
        """(B, T, F) features -> ((B, T', F'*C) in ``f*C + c`` order, (B,) lengths)."""
        x = feats[:, None].to(self.dtype)                       # (B, 1, T, F)
        lengths = feat_len
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                stride=conv.stride, padding=self.padding))
            lengths = conv_out_len(lengths, self.cfg.conv_kernel[0], self.cfg.conv_stride[0])
            # Re-mask every layer: bias + relu make padded frames nonzero,
            # and the next strided conv would read them.
            mask = torch.arange(x.shape[2], device=x.device)[None, :] < lengths[:, None]
            x = torch.where(mask[:, None, :, None], x, 0.0)
        B, C, T, Fq = x.shape
        # NCHW -> (B, T, F, C) before the reshape, for the JAX (NHWC) feature order.
        return x.permute(0, 2, 3, 1).reshape(B, T, Fq * C), lengths


class LSTMDirection(nn.Module):
    """One direction of a BiLSTM layer, through ``ops.lstm_cuda.lstm_seq``.

    ``residual_dtype`` is the type of the residuals that training saves:
    bfloat16, the JAX package's default; a test may set float32 for exact
    gradients."""

    def __init__(self, input_dim: int, hidden_dim: int, reverse: bool, dtype: torch.dtype):
        super().__init__()
        self.reverse, self.dtype = reverse, dtype
        self.residual_dtype = torch.bfloat16
        self.wih = nn.Parameter(torch.empty(input_dim, 4 * hidden_dim))
        self.whh = nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim))
        self.bias = nn.Parameter(torch.empty(4 * hidden_dim))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        # x and wih in the compute dtype; whh and bias stay float32, and so
        # does the recurrence.  Output in the compute dtype, zero outside
        # [0, len).
        return lstm_cuda.lstm_seq(
            x.to(self.dtype).contiguous(), self.wih.to(self.dtype).contiguous(),
            self.whh.contiguous(), self.bias.contiguous(),
            lengths.to(torch.int32).contiguous(), self.reverse, self.dtype,
            self.residual_dtype)


def set_residual_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the training residual type of every LSTM direction in ``model``."""
    for m in model.modules():
        if isinstance(m, LSTMDirection):
            m.residual_dtype = dtype
    return model


class BiLSTMEncoder(nn.Module):
    """conv subsampling + stacked BiLSTM; returns (B, T', 2H) states + lengths."""

    def __init__(self, cfg: BiLSTMEncoderConfig, n_mels: int, dtype: torch.dtype):
        super().__init__()
        if cfg.causal_conv or not cfg.bidirectional:
            raise NotImplementedError(
                "the port has the bidirectional, symmetric-padding encoder only")
        self.cfg = cfg
        self.conv = ConvSubsampler(cfg, n_mels, dtype)
        H = cfg.hidden_dim
        dims = [self.conv.out_dim] + [2 * H] * (cfg.num_layers - 1)
        self.layers = nn.ModuleList(
            nn.ModuleDict({"fwd": LSTMDirection(d, H, False, dtype),
                           "bwd": LSTMDirection(d, H, True, dtype)})
            for d in dims)

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        x, lengths = self.conv(feats, feat_len)
        for layer in self.layers:
            x = torch.cat([layer["fwd"](x, lengths), layer["bwd"](x, lengths)], dim=-1)
            if train and self.cfg.dropout > 0:
                x = dropout(x, self.cfg.dropout, generator)
        return x, lengths
