"""LAS attention decoder: the port's counterpart of
``pytorch_asr_tpu.models.las_decoder`` (BASELINE configs 4 and 5).

Location-sensitive attention over the encoder frames:

    s_u     = LSTM(s_{u-1}, [emb(y_{u-1}), ctx_{u-1}])
    e_{u,t} = v . tanh(W_s s_u + W_e h_t + W_f (F * a_{u-1})_t + b)
    a_u     = masked softmax(e_u);  ctx_u = sum_t a_{u,t} h_t
    logits  = W_o [s_u, ctx_u]

The parameters carry the JAX names and layouts, so loading a JAX tree is a
rename (``weights.load_jax_params``): ``embed (V, E)``, ``lstm{l}_wx
((E+D)|H, 4H)``, ``lstm{l}_wh (H, 4H)``, ``lstm{l}_b (4H,)``, ``w_e (D, A)``,
``w_s (H, A)``, ``b_att (A,)``, ``w_f (F, A)``, ``loc_filter (k, 1, F)``,
``v_att (A, 1)``, ``w_out (H+D, V)``, ``b_out (V,)``.  One ``step`` serves
teacher forcing (``forward``) and the beam searches
(``decoding/attention_beam.py``).  Parity traps with the JAX module:

* the cell is not ``nn.LSTM``: gates i, f, g, o from one split, the forget
  gate is ``sigmoid(f + 1)``, one bias;
* the location conv is a cross-correlation with XLA's "SAME" padding, which
  ``F.conv1d(..., padding="same")`` matches (``(k-1)//2`` on the left);
* masked frames get the finite ``NEG`` before the softmax, so a row of
  ``enc_len`` 0 attends uniformly over T rather than giving NaN;
* everything runs in float32 whatever the model's compute dtype;
* ``LASDecoderConfig.dropout`` is read by nothing, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_asr_tpu_torch.configs.base import LASDecoderConfig

NEG = -1.0e9


class DecoderState(NamedTuple):
    h: torch.Tensor      # (num_layers, B, H) f32
    c: torch.Tensor      # (num_layers, B, H) f32
    att: torch.Tensor    # (B, T) previous alignment
    ctx: torch.Tensor    # (B, D) previous context


class LASDecoder(nn.Module):
    """The parameters are allocated here and drawn by the owner
    (``ASRModel.init_weights``) or loaded from a JAX tree."""

    def __init__(self, cfg: LASDecoderConfig, vocab_size: int, enc_dim: int) -> None:
        super().__init__()
        self.cfg, self.vocab_size, self.enc_dim = cfg, vocab_size, enc_dim
        V, E, H, A, D = vocab_size, cfg.embed_dim, cfg.hidden_dim, cfg.attention_dim, enc_dim
        shapes = {"embed": (V, E)}
        for l in range(cfg.num_layers):
            shapes[f"lstm{l}_wx"] = ((E + D) if l == 0 else H, 4 * H)
            shapes[f"lstm{l}_wh"] = (H, 4 * H)
            shapes[f"lstm{l}_b"] = (4 * H,)
        shapes.update(w_e=(D, A), w_s=(H, A), b_att=(A,), w_f=(cfg.location_filters, A),
                      loc_filter=(cfg.location_kernel, 1, cfg.location_filters),
                      v_att=(A, 1), w_out=(H + D, V), b_out=(V,))
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(wx, wh, b) of LSTM layer ``l``."""
        return (getattr(self, f"lstm{l}_wx"), getattr(self, f"lstm{l}_wh"),
                getattr(self, f"lstm{l}_b"))

    def project_encoder(self, enc: torch.Tensor) -> torch.Tensor:
        """W_e h_t for all frames, computed once per utterance."""
        return enc.float() @ self.w_e

    def init_state(self, enc: torch.Tensor, enc_len: torch.Tensor) -> DecoderState:
        """Zero LSTM state; the first alignment is uniform over the valid
        frames, ``mask / max(enc_len, 1)``, and its context the weighted sum."""
        B, T, _ = enc.shape
        L, H = self.cfg.num_layers, self.cfg.hidden_dim
        mask = torch.arange(T, device=enc.device)[None, :] < enc_len[:, None]
        att0 = mask.float() / torch.clamp(enc_len[:, None], min=1)
        ctx0 = torch.einsum("bt,btd->bd", att0, enc.float())
        zeros = torch.zeros((L, B, H), device=enc.device)
        return DecoderState(h=zeros, c=zeros.clone(), att=att0, ctx=ctx0)

    def attend(self, h_top, enc, enc_projed, enc_mask, att_prev):
        """Location-sensitive attention -> (att (B, T), ctx (B, D))."""
        loc = F.conv1d(att_prev[:, None], self.loc_filter.permute(2, 1, 0),
                       padding="same").transpose(1, 2)                  # (B, T, F)
        e = torch.tanh((h_top @ self.w_s)[:, None, :] + enc_projed + loc @ self.w_f
                       + self.b_att) @ self.v_att                        # (B, T, 1)
        e = torch.where(enc_mask[..., None], e, NEG)
        att = torch.softmax(e[..., 0], dim=-1)
        ctx = torch.einsum("bt,btd->bd", att, enc.float())
        return att, ctx

    def step(self, enc, enc_projed, enc_mask, y_prev, state: DecoderState):
        """One decoder step: y_prev (B,) ids -> (logits (B, V) f32, new state)."""
        x = torch.cat([self.embed[y_prev.long()], state.ctx], dim=-1) @ self.lstm0_wx
        hs, cs = [], []
        for l in range(self.cfg.num_layers):
            wx, wh, b = self.layer(l)
            if l > 0:
                x = hs[-1] @ wx
            i, f, g, o = torch.chunk(x + state.h[l] @ wh + b, 4, dim=-1)
            c_new = torch.sigmoid(f + 1.0) * state.c[l] + torch.sigmoid(i) * torch.tanh(g)
            hs.append(torch.sigmoid(o) * torch.tanh(c_new))
            cs.append(c_new)
        att, ctx = self.attend(hs[-1], enc, enc_projed, enc_mask, state.att)
        logits = torch.cat([hs[-1], ctx], dim=-1) @ self.w_out + self.b_out
        return logits, DecoderState(torch.stack(hs), torch.stack(cs), att, ctx)

    def forward(self, enc: torch.Tensor, enc_len: torch.Tensor, targets: torch.Tensor,
                train: bool = False, ss_prob: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced decode of the sos-prefixed inputs ``targets`` (B, U)
        -> logits (B, U, V) float32.

        With ``train`` and ``cfg.scheduled_sampling`` > 0, each input after
        step 0 is replaced, per row and step, by the previous step's argmax
        with probability ``ss_prob``, drawn from ``generator``."""
        B, U = targets.shape
        T = enc.shape[1]
        enc = enc.float()          # once, not in every step's ``attend``
        enc_mask = torch.arange(T, device=enc.device)[None, :] < enc_len[:, None]
        enc_projed = self.project_encoder(enc)
        state = self.init_state(enc, enc_len)
        use_ss = train and self.cfg.scheduled_sampling > 0.0
        prev_pred = torch.full((B,), -1, dtype=torch.long, device=enc.device)
        outs = []
        for u in range(U):
            y_in = targets[:, u].long()
            if use_ss:
                draw = torch.rand((B,), generator=generator, device=enc.device)
                replace = (draw < ss_prob) & (prev_pred >= 0)
                y_in = torch.where(replace, torch.clamp(prev_pred, min=0), y_in)
            logits, state = self.step(enc, enc_projed, enc_mask, y_in, state)
            if use_ss:
                prev_pred = logits.argmax(dim=-1)
            outs.append(logits)
        return torch.stack(outs, dim=1)
