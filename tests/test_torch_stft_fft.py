"""K1's FFT plan (``csrc/stft_log_mel.cu``, a warp a frame) emulated in float64
numpy, lane for lane, with the tables ``ops/stft_cuda.py::constants`` hands
the kernel: the index arithmetic that no CPU run of the kernel can check.
Pure numpy and torch, no device."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.ops import beam_cuda, build, stft_cuda

# float64 throughout: the plan and np.fft.rfft differ only in rounding order.
FFT_TOL = 1e-12


def _bitrev(n: np.ndarray, bits: int) -> np.ndarray:
    return sum(((n >> i) & 1) << (bits - 1 - i) for i in range(bits))


def _cos16() -> list[float]:
    """The literals of the kernel's ``cos16``: cos(2 pi m / 16), m < 8."""
    text = (build.CSRC / "stft_log_mel.cu").read_text()
    body = re.search(r"double cos16\(int m\) \{(.*?)\}", text, re.S).group(1)
    return [float(v) for v in re.findall(r"-?\d+\.\d+", body)]


def _inner_twiddle(m: int, cos16: list[float]) -> complex:
    """The kernel's W_16^m = cos16(m) - i sin16(m), sin16 read off cos16."""
    return complex(cos16[m], -cos16[4 - m if m < 4 else m - 4])


def _zslot(k: np.ndarray) -> np.ndarray:
    """The kernel's zslot: a slot of padding every 16 bins."""
    return k + (k >> 4)


def kernel_power(frames: np.ndarray, window: np.ndarray, twiddle: np.ndarray,
                 n_fft: int) -> np.ndarray:
    """(F, win) frames -> (F, n_fft // 2 + 1) power, as the kernel computes it:
    pack, the in-lane pass of radix ``points`` (radix-2 decimation in
    frequency over the lane's registers with the kernel's constant
    twiddles, then
    each register's twiddle from the table), the lane stages by xor partner,
    the bit-reversed store, the split."""
    log2_half, lanes, points = stft_cuda.fft_plan(n_fft)
    log2_lanes, half = lanes.bit_length() - 1, n_fft // 2
    rows = points - 1 + log2_lanes
    tw = twiddle[0] + 1j * twiddle[1]
    lane = np.arange(32)
    ll = lane % lanes
    n = ll[:, None] + lanes * np.arange(points)[None, :]                  # (32, P)
    x = np.zeros((len(frames), n_fft))
    x[:, :frames.shape[1]] = frames * window
    z = x[:, 2 * n] + 1j * x[:, 2 * n + 1]                                # (F, 32, P)
    cos16 = _cos16()
    h = points // 2
    while h >= 1:                                                        # the in-lane pass
        for j in range(points):
            if j & h:
                continue
            w = _inner_twiddle(8 * (j % h) // h, cos16)
            a, b = z[..., j].copy(), z[..., j + h].copy()
            z[..., j], z[..., j + h] = a + b, (a - b) * w
        h //= 2
    for j in range(1, points):
        z[..., j] *= tw[(j - 1) * 32 + lane]
    base = points - 1
    for s in range(log2_lanes - 1, -1, -1):                              # lane stages
        h = 1 << s
        sign = np.where(ll & h, -1.0, 1.0)[:, None]
        w = tw[(base + log2_lanes - 1 - s) * 32 + lane][:, None]
        z = (sign * z + z[:, lane ^ h, :]) * w
    Z = np.zeros((len(frames), half + half // 16), complex)
    Z[:, _zslot(_bitrev(n, log2_half))] = z
    k = np.arange(half + 1)
    a, b = Z[:, _zslot(k & (half - 1))], Z[:, _zslot((half - k) & (half - 1))]
    even = 0.5 * (a.real + b.real) + 0.5j * (a.imag - b.imag)
    odd = 0.5 * (a.imag + b.imag) + 0.5j * (b.real - a.real)
    c = np.where(k < half, tw[rows * 32 + k % half], -1.0)
    return np.abs(even + c * odd) ** 2


@pytest.mark.parametrize("n_fft,win", [(512, 400), (512, 512), (4, 3), (16, 16), (64, 50),
                                       (128, 100), (256, 200), (1024, 800)])
def test_kernel_fft_plan_equals_rfft(n_fft, win):
    """Random frames through the emulated plan equal np.fft.rfft's power of
    the zero-padded windowed frame to 1e-12 of the largest: the tables, the
    stage order, the partner lanes and the digit reversal are right."""
    rng = np.random.default_rng(n_fft + win)
    frames = rng.standard_normal((9, win))
    window = features.hann_window(win).astype(np.float64)
    got = kernel_power(frames, window, stft_cuda.twiddles(n_fft), n_fft)
    want = np.abs(np.fft.rfft(frames * window, n=n_fft)) ** 2
    np.testing.assert_allclose(got, want, rtol=0, atol=FFT_TOL * want.max())


def test_inner_twiddles_are_the_sixteenths_of_a_turn():
    """The kernel's constant twiddles, to float64's rounding."""
    m = np.arange(8)
    np.testing.assert_allclose(_cos16(), np.cos(2 * np.pi * m / 16), rtol=0, atol=2e-16)
    for k in m:
        w = _inner_twiddle(int(k), _cos16())
        assert abs(w - np.exp(-2j * np.pi * k / 16)) <= 2e-16


@pytest.mark.parametrize("n_fft", [4, 64, 512, 1024])
def test_twiddle_rows_give_each_lane_its_stage(n_fft):
    """The table's shape, the lower lanes' 1 in the lane stages, and the
    split's W_{n_fft}^k."""
    log2_half, lanes, points = stft_cuda.fft_plan(n_fft)
    rows = points - 1 + lanes.bit_length() - 1
    tw = stft_cuda.twiddles(n_fft)
    assert tw.shape == (2, rows * 32 + n_fft // 2) and tw.dtype == np.float64
    ll = np.arange(32) % lanes
    for i, s in enumerate(range(lanes.bit_length() - 2, -1, -1)):
        r = points - 1 + i
        lower = (ll & (1 << s)) == 0
        assert (tw[0, r * 32:(r + 1) * 32][lower] == 1).all()
        assert (tw[1, r * 32:(r + 1) * 32][lower] == 0).all()
    k = np.arange(n_fft // 2)
    np.testing.assert_array_equal(tw[:, rows * 32:], np.stack(
        [np.cos(2 * np.pi * k / n_fft), -np.sin(2 * np.pi * k / n_fft)]))


def test_spectrum_slots_are_distinct_and_conflict_free():
    """At n_fft 512 the bit-reversed store of each register (and the split's
    reads of bins k and half - k) fall in distinct slots of a warp's buffer,
    and within each half-warp in distinct 8-byte banks (slot mod 16)."""
    log2_half, lanes, points = stft_cuda.fft_plan(512)
    half = 256
    slots = _zslot(np.arange(half))
    assert len(set(slots)) == half and slots.max() < half + half // 16
    ll = np.arange(32)
    for j in range(points):
        s = _zslot(_bitrev(ll + lanes * j, log2_half))
        for h in (s[:16], s[16:]):
            assert len(set(h % 16)) == 16
    for i in range(half // 32):
        s = _zslot(ll + 32 * i)
        for h in (s[:16], s[16:]):
            assert len(set(h % 16)) == 16


def test_mel_rows_give_the_dense_product():
    """The compressed mel rows that ``constants`` hands the kernel, summed
    band by band over their bins, give the dense mel product."""
    cfg = FrontendConfig()
    _, _, mel_w, band = stft_cuda.constants(cfg, torch.device("cpu"))
    mel = features.mel_filterbank(cfg)
    power = np.random.default_rng(5).random((6, cfg.n_fft // 2 + 1))
    banded = np.zeros((6, cfg.n_mels))
    w, band = mel_w.numpy().astype(np.float64), band.numpy()
    assert band[-1].tolist() == [0, len(w)]
    for m in range(cfg.n_mels):
        lo, off, end = band[m, 0], band[m, 1], band[m + 1, 1]
        banded[:, m] = power[:, lo:lo + end - off] @ w[off:end]
        assert not mel[:lo, m].any() and not mel[lo + end - off:, m].any()
    np.testing.assert_allclose(banded, power @ mel.astype(np.float64), rtol=1e-12, atol=0)


def test_kernel_takes_the_sizes_it_has_plans_for():
    """FFT plans exist for the powers of two 4 .. 1024; every other n_fft
    takes the DFT form (``dft_table``), odd ones included, so no size is
    refused for want of a plan."""
    for n_fft in (4, 8, 1024):
        log2_half, lanes, points = stft_cuda.fft_plan(n_fft)
        assert lanes * points == n_fft // 2 and 1 <= log2_half <= 9
        assert stft_cuda.has_fft_plan(n_fft)
    assert stft_cuda.MAX_N_FFT == 1024
    for n_fft in (1, 2, 3, 400, 401, 2048, 4096):
        assert not stft_cuda.has_fft_plan(n_fft)
        cfg = FrontendConfig(n_fft=n_fft, win_length=min(400, n_fft), n_mels=min(80, n_fft))
        table = stft_cuda.constants(cfg, torch.device("cpu"))[1]
        assert table.shape == (n_fft, 2) and table.dtype == torch.float64
        nnz = stft_cuda.constants(cfg, torch.device("cpu"))[2].numel()
        assert stft_cuda.dft_smem_bytes(cfg, nnz, 1, False) <= beam_cuda.MAX_SMEM


def dft_power(frames: np.ndarray, window: np.ndarray, table: np.ndarray,
              n_fft: int) -> np.ndarray:
    """(F, win) frames -> (F, n_fft // 2 + 1) power, as the DFT form sums it:
    lane l takes the bins k = l + 32 j, and for each sample n reads the
    table's row (n k) mod n_fft, the index advanced by k and wrapped."""
    win = frames.shape[1]
    x = frames * window.astype(np.float64)
    n_freq = n_fft // 2 + 1
    out = np.zeros((len(frames), n_freq))
    for lane in range(32):
        k = np.arange(lane, n_freq, 32)                   # this lane's bins
        idx = np.zeros(len(k), np.int64)
        re = np.zeros((len(frames), len(k)))
        im = np.zeros((len(frames), len(k)))
        for n in range(win):
            c = table[idx]
            re += x[:, n:n + 1] * c[:, 0]
            im += x[:, n:n + 1] * c[:, 1]
            idx += k
            idx = np.where(idx >= n_fft, idx - n_fft, idx)
            assert idx.max(initial=0) < n_fft
        out[:, k] = re * re + im * im
    return out


@pytest.mark.parametrize("n_fft", [400, 401, 2048])
def test_dft_form_indexing_gives_the_rfft(n_fft):
    """The DFT form's table and index arithmetic, emulated in float64, give
    ``np.fft.rfft``'s power of the windowed frame (win 400, zero-padded to
    n_fft; an odd n_fft included)."""
    win = 400
    frames = np.random.default_rng(n_fft).standard_normal((3, win))
    window = features.hann_window(win)
    got = dft_power(frames, window, stft_cuda.dft_table(n_fft), n_fft)
    want = np.abs(np.fft.rfft(frames * window.astype(np.float64), n=n_fft)) ** 2
    np.testing.assert_allclose(got, want, rtol=FFT_TOL, atol=FFT_TOL * want.max())
