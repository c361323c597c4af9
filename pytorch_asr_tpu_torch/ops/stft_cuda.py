"""STFT log-mel: the CUDA kernel ``csrc/stft_log_mel.cu`` and its plain version.

Counterpart of ``pytorch_asr_tpu/ops/stft_pallas.py``.  ``stft_log_mel``
takes the plain PyTorch version for a CPU tensor and launches the kernel for
a CUDA tensor; there is no other switch and no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"stft_log_mel_f32": [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]}

# The plain version: framing by unfold, torch.fft.rfft, mel product, log.
stft_log_mel_plain = features.log_mel_spectrum


@functools.lru_cache(maxsize=8)
def constants(cfg: FrontendConfig, device: torch.device):
    """``(window, twiddle, mel, band)`` on ``device``: the float32 Hann window
    (win_length,), the float64 FFT twiddles (2, n_fft//2) holding cos and
    -sin of 2 pi k / n_fft, the float32 (n_fft//2+1, n_mels) mel matrix, and
    each mel band's nonzero bins [first, last + 1) as int32 (n_mels, 2).

    Built once on the host from the port's ``hann_window`` and
    ``mel_filterbank``; the twiddles in float64.
    """
    k = np.arange(cfg.n_fft // 2)
    ang = 2.0 * np.pi * k / cfg.n_fft
    mel = features.mel_filterbank(cfg)
    band = np.zeros((cfg.n_mels, 2), np.int32)
    for m in range(cfg.n_mels):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            band[m] = nz[0], nz[-1] + 1
    mats = (features.hann_window(cfg.win_length), np.stack([np.cos(ang), -np.sin(ang)]),
            mel, band)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device) for m in mats)


def stft_log_mel(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, A) float32 waveform -> (B, T, n_mels) float32 ``log(max(mel, log_floor))``
    for all ``T = max_frames(A)`` frames, in natural frame order, unmasked."""
    if audio.device.type == "cpu":
        return stft_log_mel_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"stft_log_mel: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError("stft_log_mel: audio must be a contiguous (B, A) float32 "
                         f"tensor, got {tuple(audio.shape)} {audio.dtype}")
    if cfg.n_fft < 4 or cfg.n_fft & (cfg.n_fft - 1) or cfg.win_length > cfg.n_fft:
        raise ValueError("stft_log_mel: n_fft must be a power of two >= 4 and "
                         f"at least win_length, got {cfg.n_fft}, {cfg.win_length}")
    B, A = audio.shape
    T = features.max_frames(A, cfg)
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32, device=audio.device)
    if B == 0 or T == 0:
        return out
    window, twiddle, mel, band = constants(cfg, audio.device)
    lib = build.load("stft_log_mel", _SIGNATURES)
    err = lib.stft_log_mel_f32(
        audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(), mel.data_ptr(),
        band.data_ptr(), out.data_ptr(), B, A, T, cfg.win_length, cfg.hop_length,
        cfg.n_fft.bit_length() - 2, cfg.n_mels, cfg.log_floor,
        torch.cuda.current_stream(audio.device).cuda_stream)
    build.check(err, "stft_log_mel")
    build.LAUNCHES["stft_log_mel"] += 1
    return out


def log_mel(audio: torch.Tensor, audio_len: torch.Tensor,
            cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``log_mel_pallas``: ``stft_log_mel``, then the length
    mask and CMVN -> ((B, T, n_mels) features, (B,) frame lengths)."""
    feat_len = features.num_frames(audio_len, cfg)
    return features.mask_and_normalize(stft_log_mel(audio, cfg), feat_len, cfg), feat_len
