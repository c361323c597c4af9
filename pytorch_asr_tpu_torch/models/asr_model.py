"""Frontend + encoder + CTC head (counterpart of ``pytorch_asr_tpu.models.asr_model``).

No waveform augmentation (config 5) and no LAS decoder yet; SpecAugment and
dropout run in train mode, drawn from an explicit ``torch.Generator``.  The
compute dtype is applied by explicit casts where the JAX modules cast
(flax ``dtype=``): the convs, the LSTM inputs and the CTC head run in it,
while the frontend, CMVN and the LSTM recurrence stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import FrontendConfig, ModelConfig
from pytorch_asr_tpu_torch.frontend.specaugment import SpecAugmentConfig, spec_augment
from pytorch_asr_tpu_torch.models.encoder_bilstm import BiLSTMEncoder
from pytorch_asr_tpu_torch.ops import stft_cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ASRModel(nn.Module):
    """``forward(audio, audio_len, train=False, generator=None)`` returns a
    dict: ctc_logits (B, T', V) float32, enc (B, T', 2H), enc_len (B,)."""

    def __init__(self, frontend_cfg: FrontendConfig, model_cfg: ModelConfig,
                 vocab_size: int, seed: int = 0):
        super().__init__()
        if model_cfg.decoder is not None or model_cfg.encoder.kind != "bilstm":
            raise NotImplementedError("the port has the CTC-only BiLSTM model only")
        self.frontend_cfg = frontend_cfg
        self.compute_dtype = DTYPES[model_cfg.compute_dtype]
        self.encoder = BiLSTMEncoder(model_cfg.encoder, frontend_cfg.n_mels,
                                     self.compute_dtype)
        self.ctc_head = nn.utils.skip_init(nn.Linear, 2 * model_cfg.encoder.hidden_dim,
                                           vocab_size)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the CPU so every device gets
        the same ones.  The distributions follow the flax initialisers of the
        JAX model (the numbers differ): truncated lecun-normal conv and head
        kernels with zero biases, xavier-uniform ``wih``, orthogonal ``whh``,
        and an LSTM bias of 1 on the forget gate."""
        g = torch.Generator().manual_seed(seed)

        def lecun(w: torch.Tensor, fan_in: int) -> torch.Tensor:
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            return nn.init.trunc_normal_(torch.empty(w.shape), std=std, a=-2 * std,
                                         b=2 * std, generator=g)

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
