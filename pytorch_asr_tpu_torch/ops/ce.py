"""Label-smoothed cross-entropy for the attention decoder: the port's
counterpart of ``pytorch_asr_tpu.ops.ce`` (plain PyTorch; the JAX package has
no kernel for it either)."""

from __future__ import annotations

import torch


def smoothed_ce_loss(logits: torch.Tensor, targets: torch.Tensor, target_len: torch.Tensor,
                     label_smoothing: float = 0.0,
                     count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean label-smoothed CE over every valid position of the batch (not a
    mean per row): ``(1 - eps) nll + eps (-mean_V logp)``, the mean over all
    V, blank included.  logits (B, U, V), targets (B, U) eos-terminated,
    target_len (B,) counting the eos slot.  ``count`` divides instead of
    the batch's valid positions: a data rank's share of a global batch's
    mean.  Returns a 0-d float32 tensor."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, targets.long()[..., None])[..., 0]          # (B, U)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    mask = torch.arange(logits.shape[1], device=logits.device)[None, :] < target_len[:, None]
    total = torch.sum(nll * mask)
    return total / torch.clamp(mask.sum().float() if count is None else count, min=1.0)


def make_decoder_io(tokens: torch.Tensor, token_len: torch.Tensor, sos_id: int, eos_id: int):
    """Teacher-forcing inputs and outputs from (B, L) 0-padded labels:
    dec_in (B, L+1) ``[sos, t_0 .. t_{L-1}]``, dec_out (B, L+1) ``[t_0 ..
    t_{L-1}]`` with eos at ``token_len`` and 0 past it, and dec_len (B,)
    ``token_len + 1`` (the eos slot is scored)."""
    B, L = tokens.shape
    dec_in = torch.cat([torch.full((B, 1), sos_id, dtype=tokens.dtype, device=tokens.device),
                        tokens], dim=1)
    shifted = torch.cat([tokens, torch.zeros((B, 1), dtype=tokens.dtype,
                                             device=tokens.device)], dim=1)
    pos = torch.arange(L + 1, device=tokens.device)[None, :]
    lens = token_len[:, None]
    dec_out = torch.where(pos == lens, eos_id, shifted)
    dec_out = torch.where(pos > lens, 0, dec_out).to(tokens.dtype)
    return dec_in, dec_out, token_len + 1
