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
from tests.test_torch_stft_fft import kernel_power

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


def test_kernel_fft_plan_matches_rfft():
    """The kernel's constants and FFT plan (emulated lane for lane in
    ``test_torch_stft_fft.py``) on the CPU give the rfft power of the
    zero-padded frame, and its compressed mel rows give the dense product."""
    cfg = FrontendConfig()
    audio, _ = _audio(3)
    window, twiddle, mel_w, band = stft_cuda.constants(cfg, torch.device("cpu"))
    assert twiddle.dtype == torch.float64 and band.dtype == torch.int32
    frames = torch.from_numpy(audio).double().unfold(-1, cfg.win_length, cfg.hop_length)
    frames = frames.reshape(-1, cfg.win_length)
    power = torch.from_numpy(kernel_power(frames.numpy(), window.double().numpy(),
                                          twiddle.numpy(), cfg.n_fft))
    ref = torch.fft.rfft(frames * window.double(), n=cfg.n_fft).abs().square()
    # float64 throughout: the two FFTs differ only in rounding order.
    torch.testing.assert_close(power, ref, rtol=1e-10, atol=1e-9)
    mel = torch.from_numpy(features.mel_filterbank(cfg)).double()
    banded = torch.zeros(power.shape[:-1] + (cfg.n_mels,), dtype=torch.float64)
    for m in range(cfg.n_mels):
        lo, off, end = int(band[m, 0]), int(band[m, 1]), int(band[m + 1, 1])
        banded[..., m] = power[..., lo:lo + end - off] @ mel_w[off:end].double()
        assert not mel[:lo, m].any() and not mel[lo + end - off:, m].any()
    torch.testing.assert_close(banded, power @ mel, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(window.numpy(), features.hann_window(cfg.win_length))
