"""STFT -> log-mel frontend, plain PyTorch (counterpart of ``pytorch_asr_tpu.frontend.features``).

Framing uses center=False: frame t covers samples [t*hop, t*hop + win).
``log_mel_spectrum`` is the plain version the CUDA kernel in
``ops/stft_cuda.py`` is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_asr_tpu_torch.configs.base import FrontendConfig


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular HTK-mel filterbank."""
    n_freqs = cfg.n_fft // 2 + 1
    freqs = np.linspace(0.0, cfg.sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, cfg.n_mels), dtype=np.float32)
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def num_frames(audio_len: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Valid frame count for waveforms of ``audio_len`` samples (center=False)."""
    return torch.clamp((audio_len - cfg.win_length) // cfg.hop_length + 1, min=0)


def max_frames(audio_samples: int, cfg: FrontendConfig) -> int:
    return max(0, (audio_samples - cfg.win_length) // cfg.hop_length + 1)


def power_spectrum(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, A) -> (B, T, n_fft//2+1) power spectrogram via ``torch.fft.rfft``."""
    T = max_frames(audio.shape[-1], cfg)
    if T == 0:
        return audio.new_zeros((audio.shape[0], 0, cfg.n_fft // 2 + 1), dtype=torch.float32)
    frames = audio.float().unfold(-1, cfg.win_length, cfg.hop_length)[:, :T]
    window = torch.from_numpy(hann_window(cfg.win_length)).to(audio.device)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    return spec.real.square() + spec.imag.square()


def log_mel_spectrum(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, A) float32 -> (B, T, n_mels) ``log(max(mel, log_floor))`` for all
    ``max_frames(A)`` frames, unmasked."""
    mel = torch.from_numpy(mel_filterbank(cfg)).to(audio.device)
    return torch.log(torch.clamp(power_spectrum(audio, cfg) @ mel, min=cfg.log_floor))


def mask_and_normalize(feats: torch.Tensor, feat_len: torch.Tensor,
                       cfg: FrontendConfig) -> torch.Tensor:
    """Zero frames at or past ``feat_len``, then CMVN when ``cfg.normalize``."""
    mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
            < feat_len[:, None])[..., None]
    feats = torch.where(mask, feats, 0.0)
    if cfg.normalize:
        feats = normalize_features(feats, feat_len)
    return feats


def log_mel(audio: torch.Tensor, audio_len: torch.Tensor,
            cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, A) float32 waveform -> ((B, T, n_mels) log-mel, (B,) frame lengths)."""
    feat_len = num_frames(audio_len, cfg)
    return mask_and_normalize(log_mel_spectrum(audio, cfg), feat_len, cfg), feat_len


def normalize_features(feats: torch.Tensor, feat_len: torch.Tensor) -> torch.Tensor:
    """Per-utterance mean/variance normalization over valid frames only."""
    mask = (torch.arange(feats.shape[1], device=feats.device)[None, :]
            < feat_len[:, None])[..., None]
    denom = torch.clamp(feat_len[:, None, None].to(feats.dtype), min=1.0)
    mean = torch.sum(feats * mask, dim=1, keepdim=True) / denom
    var = torch.sum((feats - mean).square() * mask, dim=1, keepdim=True) / denom
    out = (feats - mean) * torch.rsqrt(var + 1e-5)
    return torch.where(mask, out, 0.0)
