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
from pytorch_asr_tpu_torch.decoding import prefix_beam
from pytorch_asr_tpu_torch.ops import (
    beam_cuda, build, ctc, ctc_cuda, lstm_cuda, stft_cuda, tcn_cuda)

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
# Prefix beam search: the kernel repeats the plain search's float32
# operations in the same order (no FMA on the fusion line), so tokens and
# lengths are equal and scores agree to rounding (bit-equal in practice).
BEAM_RTOL = 1e-5
# TCN block: fp32 FMA products summed in k order against cuBLAS's blocked
# sums, the JAX package's 2e-4 (relative to each tensor's largest entry);
# a bf16 output one bf16 step apart where the fp32 sums straddle a rounding
# boundary.
TCN_TOL = 2e-4


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


def _beam_case(device, seed, B=4, T=60, V=31, planted=True):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    if planted:
        path = rng.integers(0, V, size=(B, T))
        for b in range(B):
            logits[b, np.arange(T), path[b]] += 4.0
    lens = np.array([T, T - 13, 0, T // 3][:B], np.int32)
    table = rng.standard_normal((V * V, V)).astype(np.float32)
    table -= np.log(np.exp(table).sum(1, keepdims=True))
    return (torch.from_numpy(logits).to(device), torch.from_numpy(lens).to(device),
            torch.from_numpy(table).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("planted", [True, False])
def test_prefix_beam_kernel_matches_plain(cuda, A, lm, planted):
    """K7 (A = 0) and K8 (A = 8) against the plain search on the card, with
    and without a dense table; one row is empty."""
    logits, lens, table = _beam_case(cuda, 3, planted=planted)
    kw = dict(beam_size=8, max_len=32, ext_top_a=A, lm_table=table if lm else None,
              lm_alpha=0.5 if lm else 0.0, lm_beta=1.0 if lm else 0.0)
    build.reset_launches()
    toks, n, score = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert build.LAUNCHES["prefix_beam_topa" if A else "prefix_beam"] == 1
    assert build.LAUNCHES["prefix_beam" if A else "prefix_beam_topa"] == 0
    torch.testing.assert_close(n, want[1], rtol=0, atol=0)
    torch.testing.assert_close(toks, want[0], rtol=0, atol=0)
    torch.testing.assert_close(score, want[2], rtol=BEAM_RTOL, atol=0)
    assert n[2] == 0 and score[2] == 0


@pytest.mark.cuda
def test_prefix_beam_kernel_takes_more_lanes_than_threads(cuda):
    """K*V = 16 * 96 = 1536 lanes: threads loop over lanes."""
    logits, lens, _ = _beam_case(cuda, 5, V=96)
    kw = dict(beam_size=16, max_len=24)
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    torch.testing.assert_close(got[2], want[2], rtol=BEAM_RTOL, atol=0)


@pytest.mark.cuda
def test_prefix_beam_kernel_rejects_what_it_does_not_take(cuda):
    logp = torch.zeros(1, 2, 4096, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        beam_cuda.prefix_beam(logp, lens, 64, 8)              # 64 x 4096 lanes
    with pytest.raises(ValueError, match="int32"):
        beam_cuda.prefix_beam(logp, lens.long(), 4, 8)
    with pytest.raises(ValueError, match="top_val"):
        beam_cuda.prefix_beam(logp, lens, 4, 8, top_idx=torch.zeros(
            1, 2, 3, dtype=torch.int32, device=cuda))


def _tcn_case(device, dtype=torch.float32, B=3, T=133, C=96, K=5, seed=9):
    """Rows of different lengths with zero padding; LayerNorm scales near 1
    and nonzero biases.  T = 133 and C = 96 leave ragged tiles (128 rows,
    32 channel pairs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 0.5
    for b, n in enumerate([T, T - 40, 7][:B]):
        x[b, max(n, 0):] = 0.0
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    p = [t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
         t(rng.standard_normal((K, C, 2 * C)) * 0.05), t(0.1 * rng.standard_normal(2 * C)),
         t(rng.standard_normal((C, C)) * 0.05), t(0.1 * rng.standard_normal(C))]
    return t(x).to(dtype), p


@pytest.mark.cuda
@pytest.mark.parametrize("T", [133, 9])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
def test_tcn_kernels_match_plain(cuda, dilation, T):
    """K5, the K6 forward and the K6 backward against their plain versions;
    T = 9 is shorter than the conv's reach 2 d (K // 2) for d >= 4."""
    x, p = _tcn_case(cuda, T=T)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(dilation)).to(cuda)
    build.reset_launches()
    out = tcn_cuda.tcn_block(x, *p, dilation)
    y, xn = tcn_cuda.tcn_block_train_fwd(x, *p, dilation)
    grads = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], dilation)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["tcn_block"], build.LAUNCHES["tcn_block_train_fwd"],
            build.LAUNCHES["tcn_block_bwd"]) == (1, 1, 1)
    want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *p, dilation)
    want = (tcn_cuda.tcn_block_plain(x, *p, dilation), want_y, want_xn,
            *tcn_cuda.tcn_block_bwd_plain(want_xn, dy, p[2], p[3], p[4], dilation))
    for name, g, w in zip(("out", "y", "xn", "dxn", "dwc", "dbc", "dwp", "dbp"),
                          (out, y, xn, *grads), want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TCN_TOL, name


@pytest.mark.cuda
def test_tcn_kernel_takes_bf16_input(cuda):
    """K5 on bf16 x, as the model feeds it: the residual added in fp32, the
    output in bf16; the K6 forward reads bf16 x too."""
    x, p = _tcn_case(cuda, dtype=torch.bfloat16)
    out = tcn_cuda.tcn_block(x, *p, 4)
    want = tcn_cuda.tcn_block_plain(x, *p, 4)
    assert out.dtype == torch.bfloat16
    assert _rel_err(out, want) <= BF16_TOL
    assert ((out.float() - want.float()).abs() > 0).float().mean() < 0.01
    y, _ = tcn_cuda.tcn_block_train_fwd(x, *p, 4)
    assert _rel_err(y, tcn_cuda.tcn_block_train_fwd_plain(x, *p, 4)[0]) <= TCN_TOL


@pytest.mark.cuda
def test_tcn_autograd_launches_the_training_pair(cuda):
    x, p = _tcn_case(cuda)
    ts = [t.clone().requires_grad_(True) for t in (x, *p)]
    build.reset_launches()
    tcn_cuda.tcn_block_train(*ts, 2).square().sum().backward()
    torch.cuda.synchronize()
    assert (build.LAUNCHES["tcn_block_train_fwd"], build.LAUNCHES["tcn_block_bwd"],
            build.LAUNCHES["tcn_block"]) == (1, 1, 0)
    cpu = [t.detach().cpu().requires_grad_(True) for t in ts]
    tcn_cuda.tcn_block_train(*cpu, 2).square().sum().backward()
    for name, g, w in zip(("x", "ln_scale", "ln_bias", "w_conv", "b_conv", "w_point",
                           "b_point"), ts, cpu):
        assert _rel_err(g.grad.cpu(), w.grad) <= 1e-3, name


@pytest.mark.cuda
def test_tcn_kernels_reject_what_they_do_not_take(cuda):
    x, p = _tcn_case(cuda)
    with pytest.raises(ValueError, match="halo"):
        tcn_cuda.tcn_block(x, *p, 32)                          # 32 x 2 > 32
    with pytest.raises(ValueError, match="halo"):
        tcn_cuda.tcn_block_bwd(x, x, p[2], p[3], p[4], 17)
    with pytest.raises(ValueError, match="w_point"):
        tcn_cuda.tcn_block(x, *p[:4], p[4].T.contiguous()[:-1], p[5], 1)
    with pytest.raises(ValueError, match="float32"):
        tcn_cuda.tcn_block(x.double(), *p, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tcn_cuda.tcn_block(x.transpose(0, 1), *p, 1)
