"""Greedy CTC decoding (counterpart of ``pytorch_asr_tpu.decoding.greedy``)."""

from __future__ import annotations

import torch


def greedy_ctc(logits: torch.Tensor, logit_len: torch.Tensor, blank: int = 0):
    """(B, T, V) -> (ids (B, T), lengths (B,)): argmax, collapse repeats,
    drop blanks, mask by length.  Rows are left-packed: ids[b, :n] are the
    decoded tokens, the rest zero."""
    B, T = logits.shape[:2]
    best = logits.argmax(dim=-1)                                    # (B, T)
    t = torch.arange(T, device=logits.device)
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != prev) & (t[None, :] < logit_len[:, None])
    n = keep.sum(dim=1)
    pos = torch.cumsum(keep, dim=1) - 1
    out = torch.zeros_like(best)
    rows = torch.arange(B, device=logits.device)[:, None].expand(B, T)
    out[rows[keep], pos[keep]] = best[keep]
    return out, n
