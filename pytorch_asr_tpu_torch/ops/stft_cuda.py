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
_SIGNATURES = {"stft_log_mel_f32": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]}
MAX_N_FFT = 1024  # the kernel's largest plan: 16 complex points a lane

# The plain version: framing by unfold, torch.fft.rfft, mel product, log.
stft_log_mel_plain = features.log_mel_spectrum


def fft_plan(n_fft: int) -> tuple[int, int, int]:
    """The kernel's FFT of half = n_fft // 2 complex points, a warp a frame:
    (log2 half, lanes that hold points, points a lane).  Lane l holds the
    points n = l + lanes j; below 32 points the other lanes repeat them."""
    log2_half = n_fft.bit_length() - 2
    log2_lanes = min(log2_half, 5)
    return log2_half, 1 << log2_lanes, 1 << (log2_half - log2_lanes)


def twiddles(n_fft: int) -> np.ndarray:
    """The kernel's twiddle table, float64 (2, rows * 32 + half): real, then
    imaginary parts.  Rows of 32, one entry a lane: first row j - 1 for each
    register j = 1 .. points - 1, giving lane l W_half^{(l mod lanes)
    bitrev(j)}, the twiddle after the in-lane pass of radix ``points`` (whose
    inner twiddles are constants in the kernel); then a row each for the
    stages across lanes, span h from lanes / 2 down to 1 (W_{2h}^{l mod h}
    for a lane with bit h set, 1 for the others); then W_{n_fft}^k for
    k < half, the split's."""
    log2_half, lanes, points = fft_plan(n_fft)
    log2_lanes, log2_points, half = lanes.bit_length() - 1, points.bit_length() - 1, n_fft // 2
    ll = np.arange(32) % lanes
    exps = []  # (numerator e, denominator d) a row
    for j in range(1, points):
        k1 = int(format(j, f"0{log2_points}b")[::-1], 2)
        exps.append((ll * k1, half))
    for s in range(log2_lanes - 1, -1, -1):
        h = 1 << s
        exps.append((np.where(ll & h, ll % h, 0), 2 * h))
    ang = [2.0 * np.pi * e / d for e, d in exps] + [2.0 * np.pi * np.arange(half) / n_fft]
    ang = np.concatenate(ang)
    return np.stack([np.cos(ang), -np.sin(ang)])


@functools.lru_cache(maxsize=8)
def constants(cfg: FrontendConfig, device: torch.device):
    """``(window, twiddle, mel_w, band)`` on ``device``: the float32 Hann
    window (win_length,), the float64 ``twiddles(n_fft)``, and the mel bank
    by band as compressed rows: ``mel_w`` float32 holds each band's weights
    over its bins [first nonzero, last nonzero + 1), band after band, and
    ``band`` int32 (n_mels + 1, 2) each band's first bin and the offset of
    its weights in ``mel_w``, then [0, len(mel_w)].

    Built once on the host from the port's ``hann_window`` and
    ``mel_filterbank``; the twiddles in float64.
    """
    mel = features.mel_filterbank(cfg)
    band = np.zeros((cfg.n_mels + 1, 2), np.int32)
    weights = []
    for m in range(cfg.n_mels):
        nz = np.flatnonzero(mel[:, m])
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        band[m] = lo, sum(len(w) for w in weights)
        weights.append(mel[lo:hi, m])
    band[cfg.n_mels, 1] = sum(len(w) for w in weights)
    mats = (features.hann_window(cfg.win_length), twiddles(cfg.n_fft),
            np.concatenate(weights).astype(np.float32), band)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device) for m in mats)


def stft_log_mel(audio: torch.Tensor, cfg: FrontendConfig,
                 trace: torch.Tensor | None = None) -> torch.Tensor:
    """(B, A) float32 waveform -> (B, T, n_mels) float32 ``log(max(mel, log_floor))``
    for all ``T = max_frames(A)`` frames, in natural frame order, unmasked.

    ``trace``, a contiguous int64 (rows, 8) tensor on the card, receives the
    kernel's phase clocks (``chip_smoke.py::stft_split`` reads them): a row
    for each of the first frames of one warp, holding the global timer (ns)
    as the frame starts, the SM clock (cycles) then, after issuing the audio
    loads, after the pack (the loads' wait included), the FFT, the split into
    power bins and the mel product and log, and the global timer at its
    end."""
    if audio.device.type == "cpu":
        return stft_log_mel_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"stft_log_mel: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError("stft_log_mel: audio must be a contiguous (B, A) float32 "
                         f"tensor, got {tuple(audio.shape)} {audio.dtype}")
    if not 4 <= cfg.n_fft <= MAX_N_FFT or cfg.n_fft & (cfg.n_fft - 1) or (
            cfg.win_length > cfg.n_fft):
        raise ValueError(f"stft_log_mel: n_fft must be a power of two in [4, {MAX_N_FFT}] "
                         f"and at least win_length, got {cfg.n_fft}, {cfg.win_length}")
    B, A = audio.shape
    T = features.max_frames(A, cfg)
    if trace is not None and (trace.dim() != 2 or trace.shape[1] != 8
                              or trace.dtype != torch.int64 or trace.device != audio.device
                              or not trace.is_contiguous()):
        raise ValueError(f"stft_log_mel: trace must be contiguous (rows, 8) int64 on "
                         f"{audio.device}")
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32, device=audio.device)
    if B == 0 or T == 0:
        return out
    window, twiddle, mel_w, band = constants(cfg, audio.device)
    lib = build.load("stft_log_mel", _SIGNATURES)
    err = lib.stft_log_mel_f32(
        audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(), mel_w.data_ptr(),
        band.data_ptr(), out.data_ptr(), 0 if trace is None else trace.data_ptr(),
        0 if trace is None else trace.shape[0], B, A, T, cfg.win_length, cfg.hop_length,
        fft_plan(cfg.n_fft)[0], cfg.n_mels, mel_w.numel(), cfg.log_floor,
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
