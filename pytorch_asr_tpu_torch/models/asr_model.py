"""Frontend + encoder + CTC head + LAS decoder when configured (counterpart
of ``pytorch_asr_tpu.models.asr_model``).

The encoder is the conv + BiLSTM stack (configs 1, 2, 4 and 5) or the TCN
(config 3), chosen by ``model.encoder.kind``; with ``model.decoder`` set
the LAS attention decoder (``models/las_decoder.py``, configs 4 and 5)
reads the encoder output.  Waveform augmentation (config 5), SpecAugment
and dropout run in train mode, drawn from an explicit ``torch.Generator``.
With ``remat_encoder`` the encoder runs under activation checkpointing when
gradients are on (``remat``); augmentation, the frontend and SpecAugment
stay outside it, as in the JAX package.
The compute dtype is applied by explicit casts where the JAX modules cast
(flax ``dtype=``): the convs, the LSTM inputs, the TCN blocks' inputs and
outputs and the CTC head run in it, while the frontend, CMVN, the LSTM
recurrence, the TCN blocks' insides and the decoder stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import FrontendConfig, ModelConfig
from pytorch_asr_tpu_torch.frontend.augment import WaveformAugmentConfig, augment_waveform
from pytorch_asr_tpu_torch.frontend.specaugment import SpecAugmentConfig, spec_augment
from pytorch_asr_tpu_torch.models.encoder_bilstm import BiLSTMEncoder
from pytorch_asr_tpu_torch.models.encoder_tcn import TCNEncoder
from pytorch_asr_tpu_torch.models.las_decoder import DecoderState, LASDecoder
from pytorch_asr_tpu_torch.ops import stft_cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def encoder_output_dim(model_cfg: ModelConfig) -> int:
    """The encoder's output width: 2H for the BiLSTM, H for its
    unidirectional (streaming-capable) stack, the channels for the TCN."""
    enc = model_cfg.encoder
    if enc.kind == "bilstm":
        return (2 if enc.bidirectional else 1) * enc.hidden_dim
    if enc.kind == "tcn":
        return enc.channels
    raise ValueError(f"unknown encoder kind {enc.kind!r}")


def remat(encoder: nn.Module, feats: torch.Tensor, feat_len: torch.Tensor, train: bool,
          generator: torch.Generator | None):
    """``encoder(feats, feat_len, train, generator)`` under activation
    checkpointing (``train.remat_encoder``, flax ``nn.remat`` of the encoder
    in the JAX package): its activations are dropped after the forward and
    computed again in the backward.

    ``torch.utils.checkpoint`` replays only the global RNG states, while the
    encoder's dropout draws from ``generator``.  So the recompute starts from
    the generator's state at the forward, as ``nn.remat`` replays the same
    keys, and puts back the state the generator had before it: the masks,
    the gradients and the generator after the step equal those without
    remat.  The recompute may stop early (checkpoint's early stop), hence the
    ``finally``."""
    from torch.utils.checkpoint import checkpoint

    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(x, lengths):
        calls[0] += 1
        if calls[0] == 1 or generator is None:
            return encoder(x, lengths, train, generator)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return encoder(x, lengths, train, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, feats, feat_len, use_reentrant=False, preserve_rng_state=False)


class ASRModel(nn.Module):
    """``forward(audio, audio_len, targets=None, train=False, generator=None,
    ss_prob=0.0)`` returns a dict: ctc_logits (B, T', V) float32, enc (B, T',
    D), enc_len (B,), with D = ``encoder_output_dim``; and dec_logits (B, U,
    V) float32 when a decoder is configured and the sos-prefixed decoder
    inputs ``targets`` (B, U) are given."""

    def __init__(self, frontend_cfg: FrontendConfig, model_cfg: ModelConfig,
                 vocab_size: int, seed: int = 0, remat_encoder: bool = False):
        super().__init__()
        enc = model_cfg.encoder
        enc_dim = encoder_output_dim(model_cfg)
        self.frontend_cfg = frontend_cfg
        self.remat_encoder = remat_encoder
        self.compute_dtype = DTYPES[model_cfg.compute_dtype]
        if enc.kind == "bilstm":
            self.encoder = BiLSTMEncoder(enc, frontend_cfg.n_mels, self.compute_dtype)
        else:
            self.encoder = TCNEncoder(enc, frontend_cfg.n_mels, self.compute_dtype)
        self.ctc_head = nn.utils.skip_init(nn.Linear, enc_dim, vocab_size)
        self.las = None
        if model_cfg.decoder is not None:
            self.las = LASDecoder(model_cfg.decoder, vocab_size, enc_dim)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``, drawn on the CPU so every device gets
        the same ones.  The distributions follow the flax initialisers of the
        JAX model (the numbers differ): truncated lecun-normal conv and head
        kernels with zero biases, xavier-uniform ``wih``, orthogonal ``whh``,
        and an LSTM bias of 1 on the forget gate; for the TCN, lecun-normal
        stem, ``w_conv`` (fan-in over the taps, K*C) and ``w_point``,
        LayerNorm scales 1 and zero biases; for the decoder, normal(0.02)
        ``embed``, orthogonal ``wh``, zero biases and xavier-uniform for the
        rest, with flax's fans (the taps of ``loc_filter`` count in both)."""
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
                for d in layer.values():
                    D, G = d.wih.shape
                    d.wih.copy_(nn.init.xavier_uniform_(torch.empty(D, G), generator=g))
                    d.whh.copy_(nn.init.orthogonal_(torch.empty(d.whh.shape), generator=g))
                    d.bias.zero_()
                    d.bias[G // 4: G // 2] = 1.0
        self.ctc_head.weight.copy_(lecun(self.ctc_head.weight, self.ctc_head.in_features))
        self.ctc_head.bias.zero_()
        if self.las is not None:
            self._init_decoder(g)

    def _init_decoder(self, g: torch.Generator) -> None:
        def xavier(shape) -> torch.Tensor:
            # flax: fan_in = in * taps, fan_out = out * taps for (taps, in, out)
            taps = math.prod(shape[:-2])
            limit = math.sqrt(6.0 / (shape[-2] * taps + shape[-1] * taps))
            return (torch.rand(shape, generator=g) * 2.0 - 1.0) * limit

        for name, p in self.las.named_parameters():
            if name == "embed":
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif name.endswith("_wh"):
                p.copy_(nn.init.orthogonal_(torch.empty(p.shape), generator=g))
            elif name.endswith("_b") or name in ("b_att", "b_out"):
                p.zero_()
            else:
                p.copy_(xavier(p.shape))

    def compute_features(self, audio: torch.Tensor, audio_len: torch.Tensor):
        return stft_cuda.log_mel(audio, audio_len, self.frontend_cfg)

    def encode(self, audio: torch.Tensor, audio_len: torch.Tensor, train: bool = False,
               generator: torch.Generator | None = None):
        fc = self.frontend_cfg
        if train and fc.waveform_augment:
            wa_cfg = WaveformAugmentConfig(speed_range=fc.wa_speed_range,
                                           gain_db_range=fc.wa_gain_db,
                                           noise_snr_db_range=fc.wa_noise_snr_db)
            audio, audio_len = augment_waveform(audio, audio_len, wa_cfg, generator)
        feats, feat_len = self.compute_features(audio, audio_len)
        if train and fc.specaugment:
            sa_cfg = SpecAugmentConfig(
                num_freq_masks=fc.sa_freq_masks, freq_mask_width=fc.sa_freq_width,
                num_time_masks=fc.sa_time_masks, time_mask_fraction=fc.sa_time_fraction,
                time_warp=fc.sa_time_warp)
            feats = spec_augment(feats, feat_len, sa_cfg, generator)
        if self.remat_encoder and torch.is_grad_enabled():
            return remat(self.encoder, feats, feat_len, train, generator)
        return self.encoder(feats, feat_len, train, generator)

    def forward(self, audio: torch.Tensor, audio_len: torch.Tensor,
                targets: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None, ss_prob: float = 0.0) -> dict:
        enc, enc_len = self.encode(audio, audio_len, train, generator)
        out = {"enc": enc, "enc_len": enc_len, "ctc_logits": self.ctc_logits(enc)}
        if self.las is not None and targets is not None:
            out["dec_logits"] = self.las(enc, enc_len, targets, train, ss_prob, generator)
        return out

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        """The CTC head in the compute dtype -> (B, T', V) float32 logits."""
        dt = self.compute_dtype
        return F.linear(enc.to(dt), self.ctc_head.weight.to(dt),
                        self.ctc_head.bias.to(dt)).float()

    def decoder_begin(self, enc: torch.Tensor, enc_len: torch.Tensor):
        """Per-utterance decoder quantities for the beam searches:
        (W_e h (B, T, A), frame mask (B, T), initial ``DecoderState``)."""
        mask = torch.arange(enc.shape[1], device=enc.device)[None, :] < enc_len[:, None]
        return self.las.project_encoder(enc), mask, self.las.init_state(enc, enc_len)

    def decoder_step(self, enc, enc_projed, enc_mask, y_prev,
                     state: DecoderState) -> tuple[torch.Tensor, DecoderState]:
        """One autoregressive decoder step for the beam searches."""
        return self.las.step(enc, enc_projed, enc_mask, y_prev, state)
