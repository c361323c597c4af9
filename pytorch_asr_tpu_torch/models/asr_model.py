"""Frontend + encoder + CTC head (counterpart of ``pytorch_asr_tpu.models.asr_model``).

The encoder is the conv + BiLSTM stack (configs 1 and 2) or the TCN
(config 3), chosen by ``model.encoder.kind``.  No waveform augmentation
(config 5) and no LAS decoder yet; SpecAugment and dropout run in train
mode, drawn from an explicit ``torch.Generator``.  The compute dtype is
applied by explicit casts where the JAX modules cast (flax ``dtype=``): the
convs, the LSTM inputs, the TCN blocks' inputs and outputs and the CTC head
run in it, while the frontend, CMVN, the LSTM recurrence and the TCN
blocks' insides stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import FrontendConfig, ModelConfig
from pytorch_asr_tpu_torch.frontend.specaugment import SpecAugmentConfig, spec_augment
from pytorch_asr_tpu_torch.models.encoder_bilstm import BiLSTMEncoder
from pytorch_asr_tpu_torch.models.encoder_tcn import TCNEncoder
from pytorch_asr_tpu_torch.ops import stft_cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ASRModel(nn.Module):
    """``forward(audio, audio_len, train=False, generator=None)`` returns a
    dict: ctc_logits (B, T', V) float32, enc (B, T', D), enc_len (B,), with
    D = 2H for the BiLSTM and D = channels for the TCN."""

    def __init__(self, frontend_cfg: FrontendConfig, model_cfg: ModelConfig,
                 vocab_size: int, seed: int = 0):
        super().__init__()
        enc = model_cfg.encoder
        if model_cfg.decoder is not None or enc.kind not in ("bilstm", "tcn"):
            raise NotImplementedError("the port has the CTC-only BiLSTM and TCN models only")
        self.frontend_cfg = frontend_cfg
        self.compute_dtype = DTYPES[model_cfg.compute_dtype]
        if enc.kind == "bilstm":
            self.encoder = BiLSTMEncoder(enc, frontend_cfg.n_mels, self.compute_dtype)
            enc_dim = 2 * enc.hidden_dim
        else:
            self.encoder = TCNEncoder(enc, frontend_cfg.n_mels, self.compute_dtype)
            enc_dim = enc.channels
        self.ctc_head = nn.utils.skip_init(nn.Linear, enc_dim, vocab_size)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the CPU so every device gets
        the same ones.  The distributions follow the flax initialisers of the
        JAX model (the numbers differ): truncated lecun-normal conv and head
        kernels with zero biases, xavier-uniform ``wih``, orthogonal ``whh``,
        and an LSTM bias of 1 on the forget gate; for the TCN, lecun-normal
        stem, ``w_conv`` (fan-in over the taps, K*C) and ``w_point``,
        LayerNorm scales 1 and zero biases."""
        g = torch.Generator().manual_seed(seed)

        def lecun(w: torch.Tensor, fan_in: int) -> torch.Tensor:
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            return nn.init.trunc_normal_(torch.empty(w.shape), std=std, a=-2 * std,
                                         b=2 * std, generator=g)

        if isinstance(self.encoder, TCNEncoder):
            enc = self.encoder
            enc.stem.weight.copy_(lecun(enc.stem.weight, enc.stem.weight[0].numel()))
            enc.stem.bias.zero_()
            for block in enc.blocks:
                K, C, _ = block.w_conv.shape
                block.w_conv.copy_(lecun(block.w_conv, K * C))
                block.w_point.copy_(lecun(block.w_point, C))
                block.ln_scale.fill_(1.0)
                for b in (block.ln_bias, block.b_conv, block.b_point):
                    b.zero_()
            enc.final_ln.weight.fill_(1.0)
            enc.final_ln.bias.zero_()
        else:
            for conv in self.encoder.conv.convs:
                conv.weight.copy_(lecun(conv.weight, conv.weight[0].numel()))
                conv.bias.zero_()
            for layer in self.encoder.layers:
                for d in (layer["fwd"], layer["bwd"]):
                    D, G = d.wih.shape
                    d.wih.copy_(nn.init.xavier_uniform_(torch.empty(D, G), generator=g))
                    d.whh.copy_(nn.init.orthogonal_(torch.empty(d.whh.shape), generator=g))
                    d.bias.zero_()
                    d.bias[G // 4: G // 2] = 1.0
        self.ctc_head.weight.copy_(lecun(self.ctc_head.weight, self.ctc_head.in_features))
        self.ctc_head.bias.zero_()

    def compute_features(self, audio: torch.Tensor, audio_len: torch.Tensor):
        return stft_cuda.log_mel(audio, audio_len, self.frontend_cfg)

    def encode(self, audio: torch.Tensor, audio_len: torch.Tensor, train: bool = False,
               generator: torch.Generator | None = None):
        fc = self.frontend_cfg
        if train and fc.waveform_augment:
            raise NotImplementedError("frontend.waveform_augment (config 5) is not "
                                      "ported yet")
        feats, feat_len = self.compute_features(audio, audio_len)
        if train and fc.specaugment:
            sa_cfg = SpecAugmentConfig(
                num_freq_masks=fc.sa_freq_masks, freq_mask_width=fc.sa_freq_width,
                num_time_masks=fc.sa_time_masks, time_mask_fraction=fc.sa_time_fraction,
                time_warp=fc.sa_time_warp)
            feats = spec_augment(feats, feat_len, sa_cfg, generator)
        return self.encoder(feats, feat_len, train, generator)

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        enc, enc_len = self.encode(audio, audio_len, train, generator)
        dt = self.compute_dtype
        logits = F.linear(enc.to(dt), self.ctc_head.weight.to(dt), self.ctc_head.bias.to(dt))
        return {"enc": enc, "enc_len": enc_len, "ctc_logits": logits.float()}
