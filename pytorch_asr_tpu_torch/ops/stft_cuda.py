"""STFT log-mel: the CUDA kernel ``csrc/stft_log_mel.cu`` and its plain version.

Counterpart of ``pytorch_asr_tpu/ops/stft_pallas.py``.  ``stft_log_mel``
takes the plain PyTorch version for a CPU tensor and launches the kernel for
a CUDA tensor; there is no other switch and no fallback.  An ``n_fft`` with
an FFT plan (``has_fft_plan``: a power of two in [4, 1024]) runs the FFT
kernel; any other ``n_fft`` (at least ``win_length``) runs its DFT form,
counted apart as ``stft_log_mel_dft``.
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
_SIGNATURES = {"stft_log_mel_f32": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P],
               "stft_log_mel_dft_f32": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P]}
MAX_N_FFT = 1024  # the FFT kernel's largest plan: 16 complex points a lane

# The plain version: framing by unfold, torch.fft.rfft, mel product, log.
stft_log_mel_plain = features.log_mel_spectrum


def has_fft_plan(n_fft: int) -> bool:
    """The FFT kernel has a plan for ``n_fft``: a power of two in [4, 1024]."""
    return 4 <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0


def dft_table(n_fft: int) -> np.ndarray:
    """The DFT form's table, float64 (n_fft, 2): (cos, -sin)(2 pi m / n_fft)
    for m < n_fft; bin k of sample n reads row (n k) mod n_fft."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1)


def dft_smem_bytes(cfg: FrontendConfig, nnz: int, warps: int, table: bool) -> int:
    """The DFT form's shared memory for a block of ``warps`` warps: the
    table if ``table``, each warp's fp64 frame and fp32 power bins, the
    window, the mel rows and bands (the C source's ``dft_smem_bytes``)."""
    return (8 * ((2 * cfg.n_fft if table else 0) + warps * cfg.win_length)
            + 4 * (warps * (cfg.n_fft // 2 + 1) + cfg.win_length + nnz)
            + 8 * (cfg.n_mels + 1))


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
    window (win_length,), the float64 ``twiddles(n_fft)`` (for an n_fft
    with no FFT plan, the DFT form's ``dft_table(n_fft)``), and the mel bank
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
    table = twiddles(cfg.n_fft) if has_fft_plan(cfg.n_fft) else dft_table(cfg.n_fft)
    mats = (features.hann_window(cfg.win_length), table,
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
    end (the DFT form: the audio loads and the staging of the windowed frame
    are one phase, load; pack is the warp's sync; the DFT writes the power
    bins, so split is empty)."""
    if audio.device.type == "cpu":
        return stft_log_mel_plain(audio, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"stft_log_mel: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError("stft_log_mel: audio must be a contiguous (B, A) float32 "
                         f"tensor, got {tuple(audio.shape)} {audio.dtype}")
    if cfg.win_length > cfg.n_fft:
        raise ValueError(f"stft_log_mel: n_fft must be at least win_length, got "
                         f"{cfg.n_fft}, {cfg.win_length}")
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
    window, table, mel_w, band = constants(cfg, audio.device)
    fft = has_fft_plan(cfg.n_fft)
    lib = build.load("stft_log_mel", _SIGNATURES)
    name = "stft_log_mel" if fft else "stft_log_mel_dft"
    err = getattr(lib, name + "_f32")(
        audio.data_ptr(), window.data_ptr(), table.data_ptr(), mel_w.data_ptr(),
        band.data_ptr(), out.data_ptr(), 0 if trace is None else trace.data_ptr(),
        0 if trace is None else trace.shape[0], B, A, T, cfg.win_length, cfg.hop_length,
        fft_plan(cfg.n_fft)[0] if fft else cfg.n_fft, cfg.n_mels, mel_w.numel(),
        cfg.log_floor, torch.cuda.current_stream(audio.device).cuda_stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def log_mel(audio: torch.Tensor, audio_len: torch.Tensor,
            cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``log_mel_pallas``: ``stft_log_mel``, then the length
    mask and CMVN -> ((B, T, n_mels) features, (B,) frame lengths)."""
    feat_len = features.num_frames(audio_len, cfg)
    return features.mask_and_normalize(stft_log_mel(audio, cfg), feat_len, cfg), feat_len
