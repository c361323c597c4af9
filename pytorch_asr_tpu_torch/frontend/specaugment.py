"""SpecAugment (Park et al. 2019): the port's counterpart of
``pytorch_asr_tpu.frontend.specaugment``.

Frequency and time masks (zeros; the features are mean-normalised) and an
optional piecewise-linear time warp, with the same bounds as the JAX package.
Random numbers come from an explicit ``torch.Generator``, so they are not the
JAX package's: ``draw_masks`` and ``draw_warp`` draw them, and
``apply_masks`` and ``time_warp`` take them, so a test can pass its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SpecAugmentConfig:
    num_freq_masks: int = 2
    freq_mask_width: int = 27
    num_time_masks: int = 2
    time_mask_fraction: float = 0.05   # max width as a fraction of utterance
    # Time warp: a pivot w0 in [W, len-W) shifts by w in [-W, W]; 0 disables.
    time_warp: int = 0
    enabled: bool = True


def randint(generator, low, high, shape, device) -> torch.Tensor:
    """Uniform int64 in [low, high) with per-element bounds (``high > low``)."""
    low = torch.as_tensor(low, device=device)
    high = torch.as_tensor(high, device=device)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    return torch.minimum(low + (u * (high - low)).long(), high - 1)


def draw_warp(generator, feat_len: torch.Tensor, W: int):
    """(w0, w), each (B,) int64: pivot in [W, max(len-W, W+1)), shift in [-W, W]."""
    B = feat_len.shape[0]
    hi0 = torch.clamp(feat_len.long() - W, min=W + 1)
    w0 = randint(generator, W, hi0, (B,), feat_len.device)
    w = randint(generator, -W, W + 1, (B,), feat_len.device)
    return w0, w


def time_warp(feats: torch.Tensor, feat_len: torch.Tensor, W: int, w0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear time warp around pivot p = w0 + w, for given (w0, w).

    Output frame t reads input frame src(t), linearly interpolated:
        src(t) = t * w0 / p                      for t <= p
        src(t) = w0 + (t - p) * (L - w0)/(L - p) for t >  p
    Rows shorter than 2W+2 frames and frames beyond the valid length pass
    through unchanged.
    """
    B, T, M = feats.shape
    feat_len = feat_len.long()
    ok = feat_len > 2 * W + 1
    p = torch.minimum(torch.clamp(w0 + w, min=1), torch.clamp(feat_len - 1, min=1))
    w0f, pf, lf = (v.float()[:, None] for v in (w0, p, feat_len))
    t = torch.arange(T, dtype=torch.float32, device=feats.device)[None, :]
    left = t * w0f / torch.clamp(pf, min=1.0)
    right = w0f + (t - pf) * (lf - w0f) / torch.clamp(lf - pf, min=1.0)
    src = torch.where(t <= pf, left, right)
    src = torch.where((t < lf) & ok[:, None], src, t.expand(B, T))
    lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = (src - lo.float())[..., None]
    take = lambda idx: torch.gather(feats, 1, idx[..., None].expand(B, T, M))  # noqa: E731
    return take(lo) * (1.0 - frac) + take(hi) * frac


def draw_masks(generator, feat_len: torch.Tensor, T: int, M: int,
               cfg: SpecAugmentConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep-masks ((B, T) time, (B, M) frequency), bool.

    Frequency: ``num_freq_masks`` bands of width in [0, freq_mask_width).
    Time: ``num_time_masks`` bands of width in [0, T), capped at
    max(1, int(len * time_mask_fraction)), starting within [0, len - width].
    """
    B = feat_len.shape[0]
    dev = feat_len.device
    n_f = cfg.num_freq_masks
    width_f = randint(generator, 0, max(cfg.freq_mask_width, 1), (B, n_f), dev)
    start_f = randint(generator, 0, torch.clamp(M - width_f, min=1), (B, n_f), dev)
    f = torch.arange(M, device=dev)[None, None, :]
    freq_keep = ~((f >= start_f[..., None]) & (f < (start_f + width_f)[..., None])).any(1)
    n_t = cfg.num_time_masks
    max_t = torch.clamp((feat_len.float() * cfg.time_mask_fraction).long(), min=1)
    width_t = torch.minimum(randint(generator, 0, T, (B, n_t), dev), max_t[:, None])
    start_t = randint(generator, 0, T, (B, n_t), dev)
    start_t = torch.minimum(start_t, torch.clamp(feat_len.long()[:, None] - width_t, min=0))
    t = torch.arange(T, device=dev)[None, None, :]
    time_keep = ~((t >= start_t[..., None]) & (t < (start_t + width_t)[..., None])).any(1)
    return time_keep, freq_keep


def apply_masks(feats: torch.Tensor, time_keep: torch.Tensor,
                freq_keep: torch.Tensor) -> torch.Tensor:
    return feats * time_keep[..., None] * freq_keep[:, None, :]


def spec_augment(feats: torch.Tensor, feat_len: torch.Tensor, cfg: SpecAugmentConfig,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Time warp (optional), then frequency and time masks, drawn from ``generator``."""
    if not cfg.enabled:
        return feats
    B, T, M = feats.shape
    if cfg.time_warp > 0:
        feats = time_warp(feats, feat_len, cfg.time_warp,
                          *draw_warp(generator, feat_len, cfg.time_warp))
    return apply_masks(feats, *draw_masks(generator, feat_len, T, M, cfg))
