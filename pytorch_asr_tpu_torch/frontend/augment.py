"""Waveform augmentation in train mode: the port's counterpart of
``pytorch_asr_tpu.frontend.augment`` (BASELINE config 5).

Per utterance, on the raw (B, A) waveform before the STFT: a speed
perturbation by linear-interpolation resampling (the length rescales), a
gain in dB, and white noise at an SNR in dB over the valid samples.  Shapes
stay (B, A).  The JAX package draws from its key chain, which torch cannot
reproduce, so each function takes its draws as tensors and
``augment_waveform`` draws them from an explicit ``torch.Generator``
(``draw_augment``); a test passes JAX's draws to both sides.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class WaveformAugmentConfig:
    speed_range: tuple[float, float] = (0.85, 1.15)
    gain_db_range: tuple[float, float] = (-6.0, 6.0)
    noise_snr_db_range: tuple[float, float] = (15.0, 40.0)


def speed_perturb(audio: torch.Tensor, audio_len: torch.Tensor,
                  factor: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Resample each row by ``factor`` (B, 1) (> 1 speeds up), clamped to at
    least ``len / A`` so a slow-down never stretches past the buffer.

    Output sample t reads t + floor(t (factor - 1)) and the next one, with the
    fraction of that offset, in float32: the exact integer t stays apart from
    the offset, as in JAX.  The new length is ``min(int(len / factor), A)``."""
    B, A = audio.shape
    factor = torch.maximum(factor.float(), audio_len[:, None].float() / A)
    t_int = torch.arange(A, device=audio.device)[None, :]
    off = t_int.float() * (factor - 1.0)
    ofl = torch.floor(off)
    frac = (off - ofl).to(audio.dtype)
    lo = torch.clamp(t_int + ofl.long(), 0, A - 1)
    hi = torch.clamp(lo + 1, 0, A - 1)
    out = torch.gather(audio, 1, lo) * (1.0 - frac) + torch.gather(audio, 1, hi) * frac
    new_len = torch.clamp((audio_len.float() / factor[:, 0]).to(audio_len.dtype), max=A)
    mask = t_int < new_len[:, None]
    return torch.where(mask, out, 0.0), new_len


def gain_perturb(audio: torch.Tensor, gain_db: torch.Tensor) -> torch.Tensor:
    """Scale each row by ``10 ** (gain_db / 20)``, gain_db (B, 1)."""
    return audio * (10.0 ** (gain_db / 20.0)).to(audio.dtype)


def noise_inject(audio: torch.Tensor, audio_len: torch.Tensor, snr_db: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    """Add standard-normal ``noise`` (B, A) scaled to ``snr_db`` (B,) below each
    row's power over its valid samples (divided by max(len, 1)), masked to
    the valid samples."""
    A = audio.shape[1]
    mask = (torch.arange(A, device=audio.device)[None, :] < audio_len[:, None]).to(audio.dtype)
    power = (audio * audio * mask).sum(dim=1) / torch.clamp(audio_len.to(audio.dtype), min=1.0)
    noise_power = power / (10.0 ** (snr_db / 10.0))
    return audio + noise * torch.sqrt(noise_power)[:, None] * mask


def draw_augment(generator: torch.Generator | None, B: int, A: int,
                 cfg: WaveformAugmentConfig, device) -> dict:
    """The draws of one batch: speed factor (B, 1), gain dB (B, 1), SNR dB (B,)
    uniform in the configured ranges, and noise (B, A) standard normal."""
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    return {"factor": uniform((B, 1), *cfg.speed_range),
            "gain_db": uniform((B, 1), *cfg.gain_db_range),
            "snr_db": uniform((B,), *cfg.noise_snr_db_range),
            "noise": torch.randn((B, A), generator=generator, device=device)}


def apply_augment(audio: torch.Tensor, audio_len: torch.Tensor,
                  draws: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Speed, gain and noise in that order, with ``draws``."""
    audio, audio_len = speed_perturb(audio, audio_len, draws["factor"])
    audio = gain_perturb(audio, draws["gain_db"])
    audio = noise_inject(audio, audio_len, draws["snr_db"], draws["noise"])
    return audio, audio_len


def augment_waveform(audio: torch.Tensor, audio_len: torch.Tensor, cfg: WaveformAugmentConfig,
                     generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Speed, gain and noise with draws from ``generator`` in ``cfg``'s
    ranges; returns (audio, audio_len)."""
    B, A = audio.shape
    return apply_augment(audio, audio_len, draw_augment(generator, B, A, cfg, audio.device))
