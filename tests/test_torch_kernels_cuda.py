"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a card and skips without one.  This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.ops import build, lstm_cuda, stft_cuda

# The kernel's fp64 FFT vs the plain version's fp32 cuFFT, whose error on
# log-mel near log_floor reaches ~1e-3: 2e-3, as the JAX package holds its
# own STFT kernel.
STFT_TOL = 2e-3
# Against a float64 reference only fp32 rounding of the power, the mel sum
# and the log remain: a few 1e-6.
STFT_EXACT_TOL = 2e-5
# fp32 recurrences over 70 steps, summed in other orders.
F32_TOL = 1e-4
# bf16 outputs: one bf16 step (2^-8 below 1) where the fp32 values straddle
# a rounding boundary.
BF16_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("A", [16000, 20735, 399])
def test_stft_kernel_matches_plain(cuda, A):
    cfg = FrontendConfig()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, A)).astype(np.float32)).to(cuda)
    build.reset_launches()
    got = stft_cuda.stft_log_mel(x, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["stft_log_mel"] == (1 if got.shape[1] else 0)
    torch.testing.assert_close(got, stft_cuda.stft_log_mel_plain(x, cfg),
                               rtol=STFT_TOL, atol=STFT_TOL)


@pytest.mark.cuda
def test_stft_kernel_matches_float64(cuda):
    """Speech-band noise that falls silent: bands near log_floor included."""
    cfg = FrontendConfig()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24000)) * 0.1
    x[:, 16000:] *= 1e-4
    audio = torch.from_numpy(x.astype(np.float32)).to(cuda)
    got = stft_cuda.stft_log_mel(audio, cfg)
    window, _, mel, _ = stft_cuda.constants(cfg, cuda)
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)
    power = torch.fft.rfft(frames * window.double(), n=cfg.n_fft).abs().square()
    want = torch.log(torch.clamp(power @ mel.double(), min=cfg.log_floor)).float()
    torch.testing.assert_close(got, want, rtol=0, atol=STFT_EXACT_TOL)


@pytest.mark.cuda
def test_stft_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        stft_cuda.stft_log_mel(torch.zeros(2, 1000, dtype=torch.float64, device=cuda),
                               FrontendConfig())


def _lstm_case(device, dtype, B=5, T=70, D=40, H=48):
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = t(rng.standard_normal((B, T, D)) * 0.5).to(dtype)
    wih = t(rng.standard_normal((D, 4 * H)) * 0.3).to(dtype)
    whh = t(rng.standard_normal((H, 4 * H)) * 0.2)
    bias = t(rng.standard_normal(4 * H) * 0.1)
    lengths = torch.tensor([T, 0, 1, T - 3, T // 2], dtype=torch.int32, device=device)
    return x, wih, whh, bias, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_matches_plain(cuda, reverse, dtype):
    args = _lstm_case(cuda, dtype)
    build.reset_launches()
    got = lstm_cuda.lstm_seq(*args, reverse, dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lstm_seq"] == 1
    want = lstm_cuda.lstm_seq_plain(*args, reverse, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[1].any() and not got[4, 35:].any()


@pytest.mark.cuda
def test_lstm_kernel_rejects_what_it_does_not_take(cuda):
    x, wih, whh, bias, lengths = _lstm_case(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="lengths"):
        lstm_cuda.lstm_seq(x, wih, whh, bias, lengths.long())
    with pytest.raises(ValueError, match="whh"):
        lstm_cuda.lstm_seq(x, wih, whh.bfloat16(), bias, lengths)
