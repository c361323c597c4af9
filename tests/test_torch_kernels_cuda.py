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
from pytorch_asr_tpu_torch.ops import build, ctc, ctc_cuda, lstm_cuda, stft_cuda

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
# CTC: float32 log-space recursions, as tests/test_ctc_pallas.py holds the
# Pallas kernels to the scan; alphas are log values of up to ~T log V.
CTC_RTOL, CTC_ALPHA_ATOL = 1e-5, 1e-4
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-4, 1e-5


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


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_train_forward_matches_plain(cuda, reverse, dtype, res_dtype):
    """K3's training forward: output and residuals.  Row 0 has length T, so
    the reverse direction's first step is t = T-1 from zeros."""
    args = _lstm_case(cuda, dtype)
    build.reset_launches()
    got = lstm_cuda.lstm_seq_train_fwd(*args, reverse, dtype, res_dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lstm_seq_train_fwd"] == 1
    want = lstm_cuda.lstm_seq_train_plain(*args, reverse, dtype, res_dtype)
    for name, g, w in zip(("out", "acts", "ct"), got, want):
        assert g.dtype == w.dtype, name
        tol = BF16_TOL if torch.bfloat16 in (g.dtype, dtype) else F32_TOL
        assert _rel_err(g, w) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_matches_plain(cuda, reverse, dtype, res_dtype):
    """K3's backward against the plain walk over the same residuals and the
    same upstream gradient: dx, dwih in x's type, dwhh, db in float32."""
    x, wih, whh, bias, lengths = _lstm_case(cuda, dtype)
    _, acts, ct = lstm_cuda.lstm_seq_train_fwd(x, wih, whh, bias, lengths, reverse, dtype,
                                               res_dtype)
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.standard_normal((x.shape[0], x.shape[1], whh.shape[0]))
                          .astype(np.float32)).to(cuda)
    build.reset_launches()
    got = lstm_cuda.lstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct, reverse)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lstm_seq_bwd"] == 1
    want = lstm_cuda.lstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct, reverse)
    for name, g, w in zip(("dx", "dwih", "dwhh", "db"), got, want):
        assert g.dtype == w.dtype, name
        tol = BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL
        assert _rel_err(g, w) <= tol, name
    assert not got[0][1].any() and not got[0][4, lengths[4]:].any()


@pytest.mark.cuda
def test_lstm_autograd_launches_the_training_pair(cuda):
    x, wih, whh, bias, lengths = _lstm_case(cuda, torch.bfloat16)
    params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
    build.reset_launches()
    out = lstm_cuda.lstm_seq(*params, lengths, True, torch.bfloat16)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (build.LAUNCHES["lstm_seq_train_fwd"], build.LAUNCHES["lstm_seq_bwd"],
            build.LAUNCHES["lstm_seq"]) == (1, 1, 0)
    assert all(p.grad is not None and torch.isfinite(p.grad.float()).all() for p in params)


def _ctc_case(device, B=6, T=90, V=9, Lmax=30, seed=8):
    """Ragged rows with repeats; row 0 has Lmax labels in T frames; with
    B > 2, row 1 has logit_len == 0 and row 2 is infeasible."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)).to(device)
    label_len = rng.integers(1, Lmax + 1, size=B).astype(np.int32)
    logit_len = np.minimum(2 * label_len + rng.integers(1, T, size=B), T).astype(np.int32)
    labels = rng.integers(1, V, size=(B, Lmax)).astype(np.int32)
    labels[0, :4] = [1, 1, 2, 2]                 # repeats block the skip
    label_len[0], logit_len[0] = Lmax, T
    if B > 2:
        logit_len[1] = 0
        label_len[2], logit_len[2] = Lmax, Lmax // 2
    for b in range(B):
        labels[b, label_len[b]:] = 0
    return logits, *(torch.from_numpy(a).to(device) for a in (logit_len, labels, label_len))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 90, 9, 30), (2, 1100, 5, 520)])
def test_ctc_kernels_match_plain(cuda, shape):
    """K4's alpha and beta kernels on the same lattice as the plain
    recursions; the second shape has S = 1041 states, more than a block's
    threads."""
    B, T, V, L = shape
    logits, logit_len, labels, label_len = _ctc_case(cuda, B, T, V, L)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha(logp_tbs, skip, lens)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, lens)
    torch.testing.assert_close(alphas, ref_alphas, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(final, ref_final, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (lens > 0)
    args = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
            ctc.terminal_betas(label_len, logp_tbs.shape[2]),
            torch.where(feasible, lens, 0).to(torch.int32), torch.where(feasible, logz, 0.0))
    w = ctc_cuda.ctc_beta(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(w, ctc.posteriors_plain(*args), rtol=CTC_GRAD_RTOL,
                               atol=CTC_GRAD_ATOL)
    assert build.LAUNCHES["ctc_alpha"] == build.LAUNCHES["ctc_beta"] == 1


@pytest.mark.cuda
def test_ctc_loss_and_grad_match_plain(cuda):
    logits, logit_len, labels, label_len = _ctc_case(cuda)
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
    ref = ctc.ctc_loss(b, logit_len, labels, label_len)
    upstream = torch.linspace(0.5, 1.5, loss.shape[0], device=cuda)
    (loss * upstream).sum().backward()
    (ref * upstream).sum().backward()
    torch.testing.assert_close(loss, ref, rtol=CTC_RTOL, atol=CTC_RTOL)
    torch.testing.assert_close(a.grad, b.grad, rtol=CTC_GRAD_RTOL, atol=CTC_GRAD_ATOL)
    assert loss[1] == 0 and loss[2] == 0 and not a.grad[1].any() and not a.grad[2].any()
