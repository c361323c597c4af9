"""Port's log-mel frontend vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The STFT
kernel itself is held against its plain version in test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.configs.base import FrontendConfig as JaxFrontendConfig
from pytorch_asr_tpu.frontend import features as jax_features
from pytorch_asr_tpu.ops.stft_pallas import log_mel_pallas
from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.ops import build, stft_cuda

# Two float32 FFTs (torch's and XLA's) sum in different orders: about 1e-6
# relative on the power, so 1e-4 on log-mel and on CMVN'd features.
FFT_TOL = 1e-4
# The Pallas kernel multiplies in bf16x3 (about 1e-6 relative per product,
# then the log): the JAX package's own test holds it to 2e-3.
PALLAS_TOL = 2e-3


def _audio(seed: int, B: int = 2, A: int = 16000):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, A)).astype(np.float32)
    lens = np.array([A] + [A * 3 // 4] * (B - 1), np.int32)
    for b, n in enumerate(lens):
        audio[b, n:] = 0.0
    return audio, lens


def test_window_and_mel_bank_match_jax():
    cfg = FrontendConfig()
    np.testing.assert_array_equal(features.hann_window(400), jax_features.hann_window(400))
    np.testing.assert_array_equal(features.mel_filterbank(cfg),
                                  jax_features.mel_filterbank(JaxFrontendConfig()))
    torch.testing.assert_close(torch.from_numpy(features.hann_window(400)),
                               torch.hann_window(400, periodic=True))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("A", [16000, 20735])
def test_log_mel_matches_jax(normalize, A):
    audio, lens = _audio(0, A=A)
    ours, n1 = features.log_mel(torch.from_numpy(audio), torch.from_numpy(lens),
                                FrontendConfig(normalize=normalize))
    ref, n2 = jax_features.log_mel(jnp.asarray(audio), jnp.asarray(lens),
                                   JaxFrontendConfig(normalize=normalize))
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=FFT_TOL, atol=FFT_TOL)


def test_log_mel_matches_pallas_interpret():
    audio, lens = _audio(1, A=16000)
    ours, n1 = stft_cuda.log_mel(torch.from_numpy(audio), torch.from_numpy(lens),
                                 FrontendConfig())
    ref, n2 = log_mel_pallas(jnp.asarray(audio), jnp.asarray(lens), JaxFrontendConfig(),
                             interpret=True)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)


def test_stft_wrapper_takes_plain_version_on_cpu():
    audio, _ = _audio(2)
    cfg = FrontendConfig()
    build.reset_launches()
    got = stft_cuda.stft_log_mel(torch.from_numpy(audio), cfg)
    torch.testing.assert_close(got, stft_cuda.stft_log_mel_plain(torch.from_numpy(audio), cfg),
                               rtol=0, atol=0)
    assert got.shape == (2, features.max_frames(16000, cfg), cfg.n_mels)
    assert build.LAUNCHES["stft_log_mel"] == 0


def _kernel_fft_power(frames: torch.Tensor, window, twiddle, n_fft: int) -> torch.Tensor:
    """The CUDA kernel's FFT plan, step for step, in float64 on the CPU: pack
    even/odd samples as n_fft/2 complex points in bit-reversed order, radix-2
    butterflies with twiddle[pos * half / m], then split into n_fft/2+1 bins."""
    half = n_fft // 2
    bits = half.bit_length() - 1
    x = torch.zeros(frames.shape[:-1] + (n_fft,), dtype=torch.float64)
    x[..., : frames.shape[-1]] = frames * window.double()
    n = torch.arange(half)
    rev = sum(((n >> i) & 1) << (bits - 1 - i) for i in range(bits))
    z = torch.empty(x.shape[:-1] + (half,), dtype=torch.complex128)
    z[..., rev] = torch.complex(x[..., 0::2], x[..., 1::2])
    tw = torch.complex(twiddle[0], twiddle[1])
    m = 1
    while m < half:
        q = torch.arange(half // 2)
        pos = q & (m - 1)
        i0 = ((q - pos) << 1) + pos
        t = z[..., i0 + m] * tw[pos * (half // m)]
        a = z[..., i0]
        z[..., i0], z[..., i0 + m] = a + t, a - t
        m <<= 1
    k = torch.arange(half + 1)
    zk, zn = z[..., k % half], z[..., (half - k) % half].conj()
    even, odd = (zk + zn) / 2, (zk - zn) / 2j
    rot = torch.where(k < half, tw[k % half], torch.tensor(-1.0, dtype=torch.complex128))
    return (even + rot * odd).abs().square()


def test_kernel_fft_plan_matches_rfft():
    """The kernel's constants and FFT plan on the CPU give the rfft power of the
    zero-padded frame, and its banded mel product gives the dense one."""
    cfg = FrontendConfig()
    audio, _ = _audio(3)
    window, twiddle, mel, band = stft_cuda.constants(cfg, torch.device("cpu"))
    assert twiddle.dtype == torch.float64 and band.dtype == torch.int32
    frames = torch.from_numpy(audio).double().unfold(-1, cfg.win_length, cfg.hop_length)
    power = _kernel_fft_power(frames, window, twiddle, cfg.n_fft)
    ref = torch.fft.rfft(frames * window.double(), n=cfg.n_fft).abs().square()
    # float64 throughout: the two FFTs differ only in rounding order.
    torch.testing.assert_close(power, ref, rtol=1e-10, atol=1e-9)
    banded = torch.zeros(power.shape[:-1] + (cfg.n_mels,), dtype=torch.float64)
    for m, (lo, hi) in enumerate(band.tolist()):
        banded[..., m] = power[..., lo:hi] @ mel[lo:hi, m].double()
        assert not mel[:lo, m].any() and not mel[hi:, m].any()
    torch.testing.assert_close(banded, power @ mel.double(), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(mel.numpy(), features.mel_filterbank(cfg))
    np.testing.assert_array_equal(window.numpy(), features.hann_window(cfg.win_length))
