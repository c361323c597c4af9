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
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import (
    beam_cuda, build, ctc, ctc_cuda, lstm_cuda, stft_cuda, tcn_cuda)
from pytorch_asr_tpu_torch.scripts.bench_kernel_turns import ctc_case as _ctc_case

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
# K9: its LM products are fp32 sums in another order than torch.matmul's, so
# the fused scores drift by a few ulps a frame; planted-path inputs keep the
# search decisive (tokens and lengths exact), and the scores are held as the
# JAX package holds its own K9 on hardware (tests/test_tpu_parity.py).
RNN_RTOL, RNN_ATOL = 2e-3, 1e-3
# TCN block: fp32-grade products (3xTF32 on tensor cores) against cuBLAS's
# blocked sums, the JAX package's 2e-4 (relative to each tensor's largest entry);
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
    window = stft_cuda.constants(cfg, cuda)[0]
    mel = torch.from_numpy(features.mel_filterbank(cfg)).to(cuda)
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)
    power = torch.fft.rfft(frames * window.double(), n=cfg.n_fft).abs().square()
    want = torch.log(torch.clamp(power @ mel.double(), min=cfg.log_floor)).float()
    torch.testing.assert_close(got, want, rtol=0, atol=STFT_EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,win,hop,n_mels", [(1024, 800, 320, 80), (256, 200, 80, 40),
                                                  (64, 50, 25, 12), (4, 4, 3, 2)])
def test_stft_kernel_at_other_sizes(cuda, n_fft, win, hop, n_mels):
    """The warp-a-frame FFT's other plans (16, 4, 1 points a lane, and 2
    lanes of 1 point) against the plain version and a float64 FFT; ragged
    lengths, a frame count no multiple of the warps."""
    cfg = FrontendConfig(n_fft=n_fft, win_length=win, hop_length=hop, n_mels=n_mels)
    rng = np.random.default_rng(n_fft)
    audio = torch.from_numpy(rng.standard_normal((3, 41 * hop + win - 1)).astype(np.float32)
                             ).to(cuda)
    trace = torch.zeros((9, 8), dtype=torch.int64, device=cuda)
    got = stft_cuda.stft_log_mel(audio, cfg, trace)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, stft_cuda.stft_log_mel_plain(audio, cfg),
                               rtol=STFT_TOL, atol=STFT_TOL)
    mel = torch.from_numpy(features.mel_filterbank(cfg)).to(cuda).double()
    window = stft_cuda.constants(cfg, cuda)[0].double()
    frames = audio.double().unfold(-1, win, hop)
    power = torch.fft.rfft(frames * window, n=n_fft).abs().square()
    want = torch.log(torch.clamp(power @ mel, min=cfg.log_floor)).float()
    torch.testing.assert_close(got, want, rtol=0, atol=STFT_EXACT_TOL)
    rows = trace[trace[:, 0] != 0].cpu()
    assert len(rows) >= 1 and bool((rows[:, 2:7] >= rows[:, 1:6]).all())


def _float64_log_mel(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The log-mel function in float64 from ``torch.fft.rfft`` of the
    windowed frames."""
    mel = torch.from_numpy(features.mel_filterbank(cfg)).to(audio.device).double()
    window = torch.from_numpy(features.hann_window(cfg.win_length)).to(audio.device).double()
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)
    power = torch.fft.rfft(frames * window, n=cfg.n_fft).abs().square()
    return torch.log(torch.clamp(power @ mel, min=cfg.log_floor)).float()


@pytest.mark.cuda
def test_stft_kernel_rejects_what_it_does_not_take(cuda):
    """float64 audio and an n_fft below win_length raise; an n_fft with no
    FFT plan (2048) gives the right values, on the DFT form."""
    with pytest.raises(ValueError, match="float32"):
        stft_cuda.stft_log_mel(torch.zeros(2, 1000, dtype=torch.float64, device=cuda),
                               FrontendConfig())
    with pytest.raises(ValueError, match="win_length"):
        stft_cuda.stft_log_mel(torch.zeros(2, 5000, device=cuda),
                               FrontendConfig(n_fft=256, win_length=400))
    cfg = FrontendConfig(n_fft=2048, win_length=400)
    audio = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 5000))
                             .astype(np.float32)).to(cuda)
    build.reset_launches()
    got = stft_cuda.stft_log_mel(audio, cfg)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["stft_log_mel_dft"], build.LAUNCHES["stft_log_mel"]) == (1, 0)
    torch.testing.assert_close(got, _float64_log_mel(audio, cfg), rtol=0, atol=STFT_EXACT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [400, 401, 2048])
def test_stft_dft_form_matches_float64(cuda, n_fft):
    """K1's DFT form (an n_fft with no FFT plan; odd included) against a
    float64 DFT at 2e-5 and the plain version at its tolerance, on
    speech-band noise that falls silent; its trace's phases in order."""
    cfg = FrontendConfig(n_fft=n_fft)
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((3, 24000)) * 0.1
    x[:, 16000:] *= 1e-4
    audio = torch.from_numpy(x.astype(np.float32)).to(cuda)
    trace = torch.zeros((9, 8), dtype=torch.int64, device=cuda)
    build.reset_launches()
    got = stft_cuda.stft_log_mel(audio, cfg, trace)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["stft_log_mel_dft"], build.LAUNCHES["stft_log_mel"]) == (1, 0)
    torch.testing.assert_close(got, _float64_log_mel(audio, cfg), rtol=0, atol=STFT_EXACT_TOL)
    torch.testing.assert_close(got, stft_cuda.stft_log_mel_plain(audio, cfg),
                               rtol=STFT_TOL, atol=STFT_TOL)
    rows = trace[trace[:, 0] != 0].cpu()
    assert len(rows) >= 1 and bool((rows[:, 2:7] >= rows[:, 1:6]).all())


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


def _bwd_case(device, B, T, D, H, dtype, res_dtype, reverse, seed=12):
    """K3's backward inputs at width H: residuals from the training forward,
    lengths T, 0, past T, 1 and in between, and a random upstream gradient."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = t(rng.standard_normal((B, T, D)) * 0.5).to(dtype)
    wih = t(rng.standard_normal((D, 4 * H)) / np.sqrt(D)).to(dtype)
    whh = t(rng.standard_normal((H, 4 * H)) / np.sqrt(H))
    bias = t(rng.standard_normal(4 * H) * 0.1)
    lengths = torch.tensor(([T, 0, T + 5, 1] + [2 + 7 * i % (T - 2) for i in range(B)])[:B],
                           dtype=torch.int32, device=device)
    _, acts, ct = lstm_cuda.lstm_seq_train_fwd(x, wih, whh, bias, lengths, reverse, dtype,
                                               res_dtype)
    gy = t(rng.standard_normal((B, T, H)))
    return gy, x, wih, whh, lengths, acts, ct, reverse


@pytest.mark.cuda
@pytest.mark.parametrize("H,B", [(384, 8), (512, 16), (640, 32)])
def test_lstm_backward_grid_equals_the_per_utterance_kernel(cuda, H, B):
    """K3's backward recurrence on the grid, at config 1's, 2's and 5's
    widths and batches (config 5 stages its utterances in groups), equals
    the per-utterance kernel bit for bit in dgates, hprev, dx, dwih, dwhh and
    db: both directions, float32 and bf16 residuals (bf16 x with them)."""
    for reverse in (False, True):
        for dtype, res in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
            bargs = _bwd_case(cuda, B, 24, 64, H, dtype, res, reverse)
            grid_scratch, wide_scratch = {}, {}
            build.reset_launches()
            grid = lstm_cuda.backward_grid(H, B)
            got = lstm_cuda.backward_on_route(grid, *bargs, scratch=grid_scratch)
            torch.cuda.synchronize()
            assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_bwd": 1}
            build.reset_launches()
            want = lstm_cuda.backward_on_route(None, *bargs, scratch=wide_scratch)
            torch.cuda.synchronize()
            assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_bwd_wide": 1}
            for name in ("dgates", "hprev"):
                assert torch.equal(grid_scratch[name], wide_scratch[name]), (name, reverse, res)
            for name, g, w in zip(("dx", "dwih", "dwhh", "db"), got, want):
                assert torch.equal(g, w), (name, reverse, res)
            # Zero outside the windows: row 1 has length 0.
            assert not grid_scratch["dgates"][1].any() and not got[0][1].any()


@pytest.mark.cuda
def test_lstm_backward_route_forced_wide_gives_the_same_bits(cuda, monkeypatch):
    """The op takes the per-utterance kernel where ``backward_route`` says
    None (forced here at config 1's width), with the grid's bits, counted as
    ``lstm_seq_bwd_wide``; on the grids of cards with fewer SMs (4 and 8
    units a CTA) the bits hold too."""
    bargs = _bwd_case(cuda, 8, 40, 96, 384, torch.bfloat16, torch.bfloat16, True)
    build.reset_launches()
    want = lstm_cuda.lstm_seq_bwd(*bargs)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_bwd": 1}
    for sms in (96, 48):
        grid = lstm_cuda.backward_grid(384, 8, sms)
        assert grid.units == 384 // sms
        assert all(torch.equal(g, w) for g, w in zip(
            lstm_cuda.backward_on_route(grid, *bargs), want))
    monkeypatch.setattr(lstm_cuda, "backward_route", lambda *args, **kwargs: None)
    build.reset_launches()
    got = lstm_cuda.lstm_seq_bwd(*bargs)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_bwd_wide": 1}
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_lstm_backward_grid_trace_and_a_grid_that_cannot_launch(cuda):
    """A trace records CTA 0's steps in order; a grid of more CTAs than the
    card holds at once (384 CTAs of a whole block's shared memory each, one
    an SM) fails its cooperative launch and raises."""
    B, T, H = 4, 20, 384
    bargs = _bwd_case(cuda, B, T, 32, H, torch.float32, torch.float32, False)
    trace = torch.zeros((T, 5), dtype=torch.int64, device=cuda)
    rule = lstm_cuda.backward_grid(H, B)
    lstm_cuda.backward_on_route(rule, *bargs, trace=trace)
    steps = int(bargs[4].clamp(max=T).max())
    tr = trace[:steps].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:] >= tr[:, 1:4]).all())
    too_many = rule._replace(ctas=H, units=1, smem=lstm_cuda.SMEM_PER_BLOCK)
    with pytest.raises(RuntimeError, match="lstm_seq_bwd"):
        lstm_cuda.backward_on_route(too_many, *bargs)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_lstm_autograd_at_config_1_runs_the_grid_backward(cuda):
    """Autograd through ``LSTMSeq`` at config 1's layer shape (B 8, D 768,
    H 384) launches the grid backward, never the wide one, and matches the
    plain walk over the same residuals."""
    H, B, T, D = 384, 8, 48, 768
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    params = [t(rng.standard_normal((B, T, D)) * 0.5).bfloat16(),
              t(rng.standard_normal((D, 4 * H)) / np.sqrt(D)).bfloat16(),
              t(rng.standard_normal((H, 4 * H)) / np.sqrt(H)),
              t(rng.standard_normal(4 * H) * 0.1)]
    params = [p.requires_grad_(True) for p in params]
    lengths = torch.tensor([T, 44, 40, 37, 30, 29, 20, 10], dtype=torch.int32, device=cuda)
    build.reset_launches()
    out = lstm_cuda.lstm_seq(*params, lengths, False, torch.bfloat16)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_train_fwd": 1,
                                                              "lstm_seq_bwd": 1}
    x, wih, whh, bias = (p.detach() for p in params)
    _, acts, ct = lstm_cuda.lstm_seq_train_fwd(x, wih, whh, bias, lengths, False,
                                               torch.bfloat16)
    want = lstm_cuda.lstm_seq_bwd_plain(2 * out.detach().float(), x, wih, whh, lengths,
                                        acts, ct)
    for name, p, w in zip(("dx", "dwih", "dwhh", "db"), params, want):
        assert _rel_err(p.grad, w) <= BF16_TOL, name


def _ctc_lattice(device, shape):
    """A case's (alpha args, plain (alphas, final), beta args, label_len):
    the beta fed the plain alphas."""
    B, T, V, L = shape
    logits, logit_len, labels, label_len = _ctc_case(device, B, T, V, L)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, lens)
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (lens > 0)
    bargs = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, logp_tbs.shape[2]),
             torch.where(feasible, lens, 0).to(torch.int32), torch.where(feasible, logz, 0.0))
    return (logp_tbs, skip, lens), (ref_alphas, ref_final), bargs


def _held_to_plain(alphas, final, w, ref, bargs) -> None:
    torch.testing.assert_close(alphas, ref[0], rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(final, ref[1], rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(w, ctc.posteriors_plain(*bargs), rtol=CTC_GRAD_RTOL,
                               atol=CTC_GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 90, 9, 30), (2, 1100, 5, 520)])
def test_ctc_kernels_match_plain(cuda, shape):
    """K4's alpha and beta kernels on the same lattice as the plain
    recursions; the second shape has S = 1041 states, more than a block's
    threads."""
    aargs, ref, bargs = _ctc_lattice(cuda, shape)
    assert ctc_cuda.lane_plan(aargs[0].shape[2]).form == "lanes"
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha(*aargs)
    w = ctc_cuda.ctc_beta(*bargs)
    torch.cuda.synchronize()
    _held_to_plain(alphas, final, w, ref, bargs)
    assert build.LAUNCHES["ctc_alpha"] == build.LAUNCHES["ctc_beta"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2300, 30, 2048), (3, 12000, 30, 10000)])
def test_ctc_kernels_past_the_registers_run_the_wide_form(cuda, shape):
    """S 4097 and 20001, past the register form: the wide form, counted
    apart, against the plain recursions; a row of no frames and an
    infeasible row give posteriors 0."""
    aargs, ref, bargs = _ctc_lattice(cuda, shape)
    S = aargs[0].shape[2]
    assert S > ctc_cuda.MAX_LANE_STATES and ctc_cuda.lane_plan(S).form == "wide"
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha(*aargs)
    w = ctc_cuda.ctc_beta(*bargs)
    torch.cuda.synchronize()
    counts = {k: v for k, v in build.LAUNCHES.items() if v}
    assert counts == {"ctc_alpha_wide": 1, "ctc_beta_wide": 1}
    _held_to_plain(alphas, final, w, ref, bargs)
    assert bargs[4][0] > 0 and not w[:, 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape, k", [((6, 90, 9, 30), 1), ((2, 1100, 5, 520), 2),
                                      ((2, 2200, 30, 1500), 4)])
def test_ctc_every_plan_gives_the_routes_bits(cuda, shape, k):
    """The register form at each of its states a lane (1, 2 and 4, the
    route's at S 61, 1041 and 3001) and the wide form forced by ``wide``
    give the same alphas and posteriors bit for bit: the same operands in
    the same order, from other places."""
    aargs, ref, bargs = _ctc_lattice(cuda, shape)
    plan = ctc_cuda.lane_plan(aargs[0].shape[2])
    assert plan.form == "lanes" and plan.k == k
    alphas, final = ctc_cuda.ctc_alpha(*aargs)
    w = ctc_cuda.ctc_beta(*bargs)
    _held_to_plain(alphas, final, w, ref, bargs)
    build.reset_launches()
    got, got_final = ctc_cuda.ctc_alpha(*aargs, wide=True)
    assert torch.equal(got, alphas) and torch.equal(got_final, final)
    assert torch.equal(ctc_cuda.ctc_beta(*bargs, wide=True), w)
    assert {n: c for n, c in build.LAUNCHES.items() if c} == {"ctc_alpha_wide": 1,
                                                              "ctc_beta_wide": 1}


@pytest.mark.cuda
def test_ctc_trace_records_each_recursed_frame(cuda):
    """The register form's trace: a row for each frame block 0 recurses
    (frames 1 .. len - 1 forward, 0 .. len - 2 backward), its clocks in
    phase order; the wide form refuses a trace."""
    aargs, _, bargs = _ctc_lattice(cuda, (6, 90, 9, 30))
    T = aargs[0].shape[0]
    for call, rows in ((lambda tr: ctc_cuda.ctc_alpha(*aargs, trace=tr), range(1, T)),
                       (lambda tr: ctc_cuda.ctc_beta(*bargs, trace=tr), range(0, T - 1))):
        trace = torch.zeros((T, 8), dtype=torch.int64, device=cuda)
        call(trace)
        tr = trace.cpu()
        assert (tr[:, 0] != 0).nonzero().flatten().tolist() == list(rows)
        live = tr[tr[:, 0] != 0]
        assert bool((live[:, 2:7] >= live[:, 1:6]).all()) and bool((live[:, 7] >= live[:, 0]).all())
    with pytest.raises(ValueError, match="trace"):
        ctc_cuda.ctc_beta(*bargs, trace=torch.zeros((T, 8), dtype=torch.int64, device=cuda),
                          wide=True)


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


def _beam_case(device, seed, B=4, T=60, V=31, planted=True, gain=4.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    if planted:
        path = rng.integers(0, V, size=(B, T))
        for b in range(B):
            logits[b, np.arange(T), path[b]] += gain
    lens = np.array(([T, T - 13, 0, T // 3] * -(-B // 4))[:B], np.int32)
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
@pytest.mark.parametrize("K,A", [(400, 0), (1100, 0), (1100, 4)])
def test_prefix_beam_search_past_a_block_runs_in_scratch(cuda, K, A):
    """Beam 400 over the char vocab needs more shared memory than a block
    has, and beam 1100 (K7, or K8 over each frame's top 4) more picks than
    a block has threads: the kernel runs with its working set in a device
    scratch, counted under its wide name, and equals the plain search bit
    for bit."""
    logits, lens, _ = _beam_case(cuda, 12, B=2, T=30)
    kw = dict(beam_size=K, max_len=24, ext_top_a=A)
    assert not beam_cuda.fits(K, A or 31, 31)
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    name = "prefix_beam_topa_wide" if A else "prefix_beam_wide"
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {name: 1}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("rnn", [False, True])
def test_prefix_beam_scratch_form_gives_the_shared_forms_bits(cuda, monkeypatch, A, rnn):
    """At beam 8, where both run, K7/K8 (with a dense table) and K9's block
    kernel (its grid route forced off) with their working set in a device
    scratch (forced) equal the shared form bit for bit, scores included:
    the same code in the same order."""
    logits, lens, table = _beam_case(cuda, 3)
    kw = dict(beam_size=8, max_len=32, ext_top_a=A, lm_alpha=0.5, lm_beta=1.0)
    kw.update(dict(rnn_lm=_rnn_lm(cuda, 2), sos_id=29) if rnn else dict(lm_table=table))
    name = ("prefix_beam_rnn" if rnn else "prefix_beam") + ("_topa" if A else "")
    monkeypatch.setattr(beam_cuda, "rnn_grid_route", lambda *args, **kwargs: None)
    build.reset_launches()
    shared = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        name + ("_block" if rnn else ""): 1}
    monkeypatch.setattr(beam_cuda, "fits", lambda *args, **kwargs: False)
    build.reset_launches()
    scratch = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {f"{name}_wide": 1}
    assert all(torch.equal(a, b) for a, b in zip(scratch, shared))


@pytest.mark.cuda
def test_prefix_beam_kernel_rejects_what_it_does_not_take(cuda):
    logp = torch.zeros(1, 2, 4096, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="beam_size"):
        beam_cuda.prefix_beam(logp, lens, 0, 8)
    with pytest.raises(ValueError, match="int32"):
        beam_cuda.prefix_beam(logp, lens.long(), 4, 8)
    with pytest.raises(ValueError, match="top_val"):
        beam_cuda.prefix_beam(logp, lens, 4, 8, top_idx=torch.zeros(
            1, 2, 3, dtype=torch.int32, device=cuda))


def _rnn_lm(device, nl: int, E: int = 16, H: int = 32, seed: int = 11) -> CharRNNLM:
    """An LM whose rows are far from uniform: the drawn weights scaled up
    and random biases."""
    lm = CharRNNLM(RNNLMConfig(embed_dim=E, hidden_dim=H, num_layers=nl), 31, seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lm.parameters():
            p.mul_(3.0).add_(0.3 * torch.randn(p.shape, generator=g))
    return lm.to(device).requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [1, 2])
@pytest.mark.parametrize("A", [0, 8])
def test_prefix_beam_rnn_kernel_matches_plain(cuda, A, nl):
    """K9 over all chars (A = 0) and each frame's top-8, with 1 and 2 LM
    layers, against the plain search on the card: planted-path logits,
    ragged rows and an empty one."""
    logits, lens, _ = _beam_case(cuda, 3)
    kw = dict(beam_size=8, max_len=32, ext_top_a=A, rnn_lm=_rnn_lm(cuda, nl), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    build.reset_launches()
    toks, n, score = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["prefix_beam_rnn_topa" if A else "prefix_beam_rnn"] == 1
    assert sum(build.LAUNCHES.values()) == 1
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    torch.testing.assert_close(n, want[1], rtol=0, atol=0)
    torch.testing.assert_close(toks, want[0], rtol=0, atol=0)
    torch.testing.assert_close(score, want[2], rtol=RNN_RTOL, atol=RNN_ATOL)
    assert n[2] == 0 and score[2] == 0 and n[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("E,H,nl,K", [(128, 256, 2, 16), (64, 384, 1, 16)])
def test_prefix_beam_rnn_kernel_at_full_lm_width(cuda, E, H, nl, K):
    """The default LM (E 128, H 256, 2 layers) at beam 16, whose LM step
    takes the block's 1024 threads, and H 384, whose step loops over 1536
    (unit, beam group) items."""
    logits, lens, _ = _beam_case(cuda, 4, B=3, T=40)
    kw = dict(beam_size=K, max_len=24, rnn_lm=_rnn_lm(cuda, nl, E, H), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    for A in (0, 8):
        got = prefix_beam.prefix_beam_search(logits, lens, ext_top_a=A, **kw)
        want = prefix_beam.prefix_beam_search_plain(logits, lens, ext_top_a=A, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
def test_prefix_beam_rnn_kernel_rejects_what_it_does_not_take(cuda):
    logits, lens, _ = _beam_case(cuda, 5, B=2, T=20)
    logp = torch.log_softmax(logits, -1)
    lm = _rnn_lm(cuda, 1)
    h0, c0, lmp0 = prefix_beam.primed_lm_state(lm, 29)
    with pytest.raises(ValueError, match="h0"):
        beam_cuda.prefix_beam_rnn(logp, lens, 4, 8, lm, h0.double(), c0, lmp0, 0.5, 1.0)
    with pytest.raises(ValueError, match="lmp0"):
        beam_cuda.prefix_beam_rnn(logp, lens, 4, 8, lm, h0, c0, lmp0[:-1], 0.5, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("A", [0, 8])
def test_prefix_beam_rnn_kernel_takes_a_deep_lm(cuda, monkeypatch, A, grid):
    """K9 with a 10-layer char LM (E 32, H 64), its layers' weights by the
    kernel's device table, over all chars and the top 8, on its grid and
    (the route forced to None) its block kernel, against the plain search:
    tokens and lengths exact, scores within RNN_RTOL / RNN_ATOL."""
    logits, lens, _ = _beam_case(cuda, 25, B=4, T=40, gain=8.0)
    lm = _rnn_lm(cuda, 10, E=32, H=64)
    route = beam_cuda.rnn_grid_route(4, 8, A or 31, 31, 10, 32, 64, build.sm_count(0))
    assert route is not None
    if not grid:
        monkeypatch.setattr(beam_cuda, "rnn_grid_route", lambda *args, **kwargs: None)
    kw = dict(beam_size=8, max_len=48, ext_top_a=A, rnn_lm=lm, sos_id=29, lm_alpha=0.5,
              lm_beta=1.0)
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    name = ("prefix_beam_rnn_topa" if A else "prefix_beam_rnn") + ("" if grid else "_block")
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {name: 1}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)
    assert got[1][0] > 0 and got[1][2] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("E,H,nl,K", [(128, 512, 2, 16), (128, 256, 3, 16), (128, 256, 2, 32)])
def test_prefix_beam_rnn_kernel_past_shared_memory(cuda, E, H, nl, K):
    """LMs whose state does not fit a block's shared memory beside the
    search (H 512, 3 layers, beam 32 with the default widths): K9 runs on
    the grid where its route fits (3 layers, beam 32), else its block kernel
    keeps the state in a device scratch (H 512); both match the plain search
    on planted paths."""
    assert beam_cuda.rnn_smem_bytes(K, 31, 31, nl, E, H) > beam_cuda.MAX_SMEM
    logits, lens, _ = _beam_case(cuda, 6, B=3, T=40)
    kw = dict(beam_size=K, max_len=24, rnn_lm=_rnn_lm(cuda, nl, E, H), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    for A in (0, 8):
        grid = beam_cuda.rnn_grid_route(3, K, A or 31, 31, nl, E, H, build.sm_count(0))
        assert (grid is None) == (H == 512)
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(logits, lens, ext_top_a=A, **kw)
        torch.cuda.synchronize()
        name = ("prefix_beam_rnn_topa" if A else "prefix_beam_rnn") + (
            "_block" if grid is None else "")
        assert {k: v for k, v in build.LAUNCHES.items() if v} == {name: 1}
        want = prefix_beam.prefix_beam_search_plain(logits, lens, ext_top_a=A, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
def test_prefix_beam_rnn_search_past_a_block_runs_in_scratch(cuda, A):
    """K9 at beam 64 with an LM of H 512: the LM step's packed inputs alone
    pass a block's shared memory, so the kernel runs with its whole working
    set in a device scratch, counted under its wide name, and matches the
    plain search: tokens and lengths exact, scores to RNN_RTOL."""
    logits, lens, _ = _beam_case(cuda, 13, B=2, T=20)
    kw = dict(beam_size=64, max_len=16, ext_top_a=A, rnn_lm=_rnn_lm(cuda, 2, 128, 512),
              sos_id=29, lm_alpha=0.5, lm_beta=1.0)
    assert not beam_cuda.fits(64, A or 31, 31, (2, 128, 512))
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    name = "prefix_beam_rnn_topa_wide" if A else "prefix_beam_rnn_wide"
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {name: 1}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("B", [1, 16, 33])
def test_prefix_beam_rnn_grid_matches_plain(cuda, B, A, nl):
    """K9 on the co-resident grid (an LM of H 32: runs of 32 CTAs of one
    unit) against the plain search: B 1, 16 and 33 (past one run's CTAs),
    1-3 layers, over all chars and
    the top 8, planted paths, ragged rows and an empty one: tokens and
    lengths exact, scores within RNN_RTOL / RNN_ATOL.  The inputs are made
    decisive, as the exactness needs: max_len is above the frames (beams at
    max_len only stay, their candidates tie to the last ulps, and the LM's
    rounding would decide), and the path is planted at +8 (at +4 one of the
    33 rows over the top 8 is a selection that a float64 search decides by
    4e-7, below float32's resolution: the next test holds +4 to that)."""
    logits, lens, _ = _beam_case(cuda, 21, B=B, T=40, gain=8.0)
    lens[-1] = 0 if B > 1 else lens[-1]
    lm = _rnn_lm(cuda, nl)
    grid = beam_cuda.rnn_grid_route(B, 8, A or 31, 31, nl, 16, 32, build.sm_count(0))
    assert grid is not None and grid.per_cta == (2 if B > grid.ctas else 1)
    kw = dict(beam_size=8, max_len=48, ext_top_a=A, rnn_lm=lm, sos_id=29, lm_alpha=0.5,
              lm_beta=1.0)
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "prefix_beam_rnn_topa" if A else "prefix_beam_rnn": 1}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)
    if B > 1:
        assert got[1][-1] == 0 and got[2][-1] == 0
    assert got[1][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("B,L", [(1, 24), (33, 24), (33, 48)])
def test_prefix_beam_rnn_grid_parts_from_a_float64_search_only_at_a_near_tie(cuda, B, L, A,
                                                                            nl):
    """The inputs of ``test_prefix_beam_rnn_grid_matches_plain`` with the
    path planted at +4 only: a row where the grid's tokens or lengths differ
    from the plain search run in float64 (``scripts/rnn_grid_witness.py``)
    must be one where that search kept a candidate over the first one cut
    by a margin below float32's resolution at these scores (an ulp of 32 is
    3.8e-6) at some frame: a near-tie, not a wrong step."""
    from pytorch_asr_tpu_torch.scripts import rnn_grid_witness as witness

    logits, lens = witness.case_inputs(B, 4.0, cuda)
    lm = witness.case_lm(nl, cuda)
    got = prefix_beam.prefix_beam_search(logits, lens, beam_size=witness.K, max_len=L,
                                         ext_top_a=A, rnn_lm=lm, sos_id=witness.SOS,
                                         lm_alpha=witness.ALPHA, lm_beta=witness.BETA)
    want = witness.plain64(logits, lens, A, L, lm)
    differ = witness.rows_differing(got, want)
    same = [r for r in range(B) if r not in differ]
    torch.testing.assert_close(got[2][same].double(), want[2][same], rtol=RNN_RTOL,
                               atol=RNN_ATOL)
    for r in differ:
        with witness.margins_recorded() as margins:
            witness.plain64(logits[r:r + 1], lens[r:r + 1], A, L, lm)
        smallest = torch.stack(margins)[: int(lens[r]), 0].min().item()
        assert smallest < 3.8e-6, (r, smallest)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
def test_prefix_beam_rnn_grid_at_the_default_lm(cuda, A):
    """The default LM's widths (E 128, H 256, 2 layers: 128 CTAs of 2
    units) at beam 16 on 16 planted rows."""
    logits, lens, _ = _beam_case(cuda, 22, B=16, T=48)
    lm = _rnn_lm(cuda, 2, 128, 256)
    assert beam_cuda.rnn_grid_route(16, 16, A or 31, 31, 2, 128, 256, build.sm_count(0)) is not None
    kw = dict(beam_size=16, max_len=64, ext_top_a=A, rnn_lm=lm, sos_id=29, lm_alpha=0.5,
              lm_beta=1.0)
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
def test_prefix_beam_rnn_grid_at_a_width_not_a_multiple_of_4(cuda):
    """H 30 (E 12, 2 layers): the grid stages its rows by 4-byte copies."""
    logits, lens, _ = _beam_case(cuda, 27, B=5, T=40, gain=8.0)
    kw = dict(beam_size=8, max_len=48, rnn_lm=_rnn_lm(cuda, 2, 12, 30), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    assert beam_cuda.rnn_grid_route(5, 8, 31, 31, 2, 12, 30, build.sm_count(0)) is not None
    build.reset_launches()
    got = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"prefix_beam_rnn": 1}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
def test_prefix_beam_rnn_block_kernel_forced_gives_the_grids_tokens(cuda, monkeypatch, A):
    """With the route forced to None, K9 runs its block kernel, counted as
    ``prefix_beam_rnn_block``, and gives the grid's tokens and lengths."""
    logits, lens, _ = _beam_case(cuda, 23, B=8, T=40)
    kw = dict(beam_size=8, max_len=48, ext_top_a=A, rnn_lm=_rnn_lm(cuda, 2), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    grid = prefix_beam.prefix_beam_search(logits, lens, **kw)
    monkeypatch.setattr(beam_cuda, "rnn_grid_route", lambda *args, **kwargs: None)
    build.reset_launches()
    block = prefix_beam.prefix_beam_search(logits, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "prefix_beam_rnn_topa_block" if A else "prefix_beam_rnn_block": 1}
    assert all(torch.equal(a, b) for a, b in zip(block[:2], grid[:2]))
    torch.testing.assert_close(block[2], grid[2], rtol=RNN_RTOL, atol=RNN_ATOL)


def _rnn_args(device, B=4, T=30, K=8, nl=2, E=16, H=32):
    logits, lens, _ = _beam_case(device, 24, B=B, T=T)
    lm = _rnn_lm(device, nl, E, H)
    logp = torch.log_softmax(logits, -1).contiguous()
    return (logp, lens, K, 48, lm, *prefix_beam.primed_lm_state(lm, 29), 0.5, 1.0)


@pytest.mark.cuda
def test_prefix_beam_rnn_grid_trace_and_a_grid_that_cannot_launch(cuda):
    """The trace records CTA 0's frames in order; a grid of more CTAs than
    the card holds at once (256 CTAs of a whole block's shared memory) fails
    its cooperative launch and raises, and leaves no error behind: the next
    launch runs and gives the route's result."""
    args = _rnn_args(cuda, nl=2, E=16, H=256)
    logp, lens, K, L, lm = args[:5]
    route = beam_cuda.rnn_grid_route(4, K, 31, 31, 2, 16, 256, build.sm_count(0))
    trace = torch.zeros((logp.shape[1], 11), dtype=torch.int64, device=cuda)
    want = beam_cuda.rnn_on_route(route, *args, trace=trace)
    torch.cuda.synchronize()
    frames = int(lens.max())
    tr = trace[:frames].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:] >= tr[:, 1:-1]).all())
    assert not trace[frames:].any()
    too_many = route._replace(ctas=256, units=1, smem=beam_cuda.MAX_SMEM)
    with pytest.raises(RuntimeError, match="prefix_beam_rnn"):
        beam_cuda.rnn_on_route(too_many, *args)
        torch.cuda.synchronize()
    got = beam_cuda.prefix_beam_rnn(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_prefix_beam_trace_runs(cuda):
    """Block 0's trace of each frame: the global clock rises frame to frame
    and each frame's phase clocks rise in order."""
    logits, lens, table = _beam_case(cuda, 26)
    logp = torch.log_softmax(logits, -1).contiguous()
    trace = torch.zeros((logp.shape[1], 7), dtype=torch.int64, device=cuda)
    beam_cuda.prefix_beam(logp, lens, 16, 24, table, 0.5, 1.0, trace=trace)
    torch.cuda.synchronize()
    tr = trace[: int(lens[0])].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:] >= tr[:, 1:-1]).all())


def _merge_case(device, P: int, frames: int, table: bool, seed: int = 7, K: int = 16,
                V: int = 8):
    """One frame's candidates gathered from P beam shards (``parent_offset``)
    of a state the plain search advanced ``frames`` frames, on logits whose
    chars 3 and 4 are equal at every frame (exact ties from identical
    operations, the table's columns too); row 2 has no frames: its V live
    candidates leave K - V dead picks."""
    B, T = 4, frames + 1
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    logits[..., 4] = logits[..., 3]
    lens = torch.tensor([T, T, 0, T - 1], device=device)
    tab = rng.standard_normal((V * V, V)).astype(np.float32)
    tab -= np.log(np.exp(tab).sum(1, keepdims=True))
    tab[..., 4] = tab[..., 3]
    tab = torch.from_numpy(tab).to(device)
    lm = tab if table else None
    logp = torch.log_softmax(torch.from_numpy(logits).to(device), -1)
    kw = dict(blank=0, vocab=V, lm_table=lm, lm_alpha=0.5 if table else 0.0,
              lm_beta=1.0 if table else 0.0, L=24)
    state = prefix_beam._init_state(B, K, 24, device)
    for t in range(frames):
        state, _ = prefix_beam._step(state, logp[:, t], t < lens, K=K, **kw)
    kl, shards = K // P, []
    for p in range(P):
        sl = slice(p * kl, (p + 1) * kl)
        local = prefix_beam.BeamState(state.tokens, *(f[:, sl] for f in state[1:]))
        rows = lm[local.ctx.long()] if lm is not None else None
        shards.append(prefix_beam._build_candidates(local, logp[:, frames], lm_rows=rows, K=kl,
                                                    parent_offset=p * kl, **kw))
    stay = {k: torch.cat([s[0][k] for s in shards], 1).contiguous() for k in shards[0][0]}
    ext = {k: torch.cat([s[1][k] for s in shards], 1).contiguous() for k in shards[0][1]}
    return stay, ext, K


def _assert_merge_equal(score, got, want_score, want):
    assert torch.equal(score, want_score)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("frames", [1, 9])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_merge_topk_kernel_matches_plain(cuda, P, frames, table, K):
    """K10 against the plain merge, every field bit for bit, dead picks too:
    beam 16 (the merge tree) and 64 (past 32: the ranks); with block 0's
    trace, whose clocks rise phase by phase."""
    stay, ext, K = _merge_case(cuda, P, frames, table, K=K)
    trace = torch.zeros(7, dtype=torch.int64, device=cuda)
    build.reset_launches()
    score, got = beam_cuda.merge_topk(stay, ext, K, trace=trace)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"merge_topk": 1}
    _assert_merge_equal(score, got, *prefix_beam._merge_topk(stay, ext, K))
    assert (score[2] <= prefix_beam.NEG_INF / 2).any()     # dead picks were compared
    tr = trace.cpu()
    assert bool((tr[2:6] >= tr[1:5]).all()) and tr[6] >= tr[0] > 0


@pytest.mark.cuda
def test_merge_topk_past_a_block_runs_in_scratch(cuda):
    """K10 at Ks 640 over 30 chars (262,912 bytes a block: past shared
    memory) keeps its working set in a device scratch, counted as
    ``merge_topk_wide``, and equals the plain merge bit for bit."""
    stay, ext, K = _merge_case(cuda, 2, 9, True, K=640, V=31)
    assert not beam_cuda.merge_fits(640, 30) and beam_cuda.merge_smem_bytes(640, 30) == 262912
    build.reset_launches()
    score, got = beam_cuda.merge_topk(stay, ext, K)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"merge_topk_wide": 1}
    _assert_merge_equal(score, got, *prefix_beam._merge_topk(stay, ext, K))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_merge_topk_scratch_form_gives_the_shared_forms_bits(cuda, monkeypatch, P):
    """The in-scratch form forced at the sharded search's shape (Ks 16 over
    30 chars) equals the shared form and the plain merge."""
    stay, ext, K = _merge_case(cuda, P, 9, True, K=16, V=31)
    shared = beam_cuda.merge_topk(stay, ext, K)
    monkeypatch.setattr(beam_cuda, "merge_fits", lambda *args: False)
    build.reset_launches()
    score, got = beam_cuda.merge_topk(stay, ext, K)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"merge_topk_wide": 1}
    _assert_merge_equal(score, got, *shared)
    _assert_merge_equal(score, got, *prefix_beam._merge_topk(stay, ext, K))


@pytest.mark.cuda
def test_merge_topk_kernel_rejects_what_it_does_not_take(cuda):
    stay, ext, K = _merge_case(cuda, 2, 1, False)
    with pytest.raises(ValueError, match="trace"):
        beam_cuda.merge_topk(stay, ext, K, trace=torch.zeros(6, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="ctx"):
        beam_cuda.merge_topk({**stay, "ctx": stay["ctx"][..., None]}, ext, K)
    with pytest.raises(ValueError, match="contiguous"):
        beam_cuda.merge_topk({**stay, "pb": stay["pb"].t().contiguous().t()}, ext, K)
    with pytest.raises(ValueError, match="int32"):
        beam_cuda.merge_topk(stay, {**ext, "hash": ext["hash"].long()}, K)


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
    T = 9 is shorter than the conv's reach 2 d (K // 2) for d >= 4.  Each
    (3xTF32 on tensor cores, any split-K summed in a fixed order, no
    atomics) gives the same bits on a second call."""
    x, p = _tcn_case(cuda, T=T)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(dilation)).to(cuda)
    build.reset_launches()
    out = tcn_cuda.tcn_block(x, *p, dilation)
    y, xn = tcn_cuda.tcn_block_train_fwd(x, *p, dilation)
    grads = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], dilation)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["tcn_block"], build.LAUNCHES["tcn_block_train_fwd"],
            build.LAUNCHES["tcn_block_bwd"]) == (1, 1, 1)
    again = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], dilation)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert torch.equal(out, tcn_cuda.tcn_block(x, *p, dilation))
    assert all(torch.equal(a, b) for a, b in zip((y, xn),
                                                  tcn_cuda.tcn_block_train_fwd(x, *p, dilation)))
    want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *p, dilation)
    want = (tcn_cuda.tcn_block_plain(x, *p, dilation), want_y, want_xn,
            *tcn_cuda.tcn_block_bwd_plain(want_xn, dy, p[2], p[3], p[4], dilation))
    for name, g, w in zip(("out", "y", "xn", "dxn", "dwc", "dbc", "dwp", "dbp"),
                          (out, y, xn, *grads), want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TCN_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("C", [30, 32, 384])
def test_tcn_backward_at_other_widths(cuda, C):
    """The backward and both forwards at C 30 (4-byte copies: rows are not
    16-byte aligned), C 32 (16-byte copies, one tile of channel pairs) and
    config 3's C 384 (tiles that do not cross a tap), against the plain
    versions."""
    x, p = _tcn_case(cuda, B=2, T=61, C=C)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(C)).to(cuda)
    xn = tcn_cuda.layer_norm(x, p[0], p[1]).contiguous()
    got = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], 2)
    want = tcn_cuda.tcn_block_bwd_plain(xn, dy, p[2], p[3], p[4], 2)
    for name, g, w in zip(("dxn", "dwc", "dbc", "dwp", "dbp"), got, want):
        assert _rel_err(g, w) <= TCN_TOL, name
    got = (tcn_cuda.tcn_block(x, *p, 2), *tcn_cuda.tcn_block_train_fwd(x, *p, 2))
    want = (tcn_cuda.tcn_block_plain(x, *p, 2), *tcn_cuda.tcn_block_train_fwd_plain(x, *p, 2))
    for name, g, w in zip(("out", "y", "xn"), got, want):
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


# ---------------------------------------------------------------- K11: bilstm_seq


def _bilstm_case(device, dtype, B=5, T=70, D=40, H=48):
    """K11's inputs and the two directions' own: (x, wih (2, D, 4H), whh,
    bias, lengths), rows as ``_lstm_case``'s."""
    x, wf, uf, bf, lengths = _lstm_case(device, dtype, B, T, D, H)
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    wb = t(rng.standard_normal((D, 4 * H)) * 0.3).to(dtype)
    ub = t(rng.standard_normal((H, 4 * H)) * 0.2)
    bb = t(rng.standard_normal(4 * H) * 0.1)
    return (x, torch.stack([wf, wb]), torch.stack([uf, ub]), torch.stack([bf, bb]), lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_kernel_equals_two_lstm_launches(cuda, dtype):
    """K11's inference forward (the dual grid) is bit for bit K2 forward |
    K2 reverse and the per-utterance oracle, and agrees with its plain
    version as K2 does; the op never launches the oracle."""
    x, wih, whh, bias, lengths = _bilstm_case(cuda, dtype)
    build.reset_launches()
    got = lstm_cuda.bilstm_seq(x, wih, whh, bias, lengths, dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bilstm_seq"] == 1 and build.LAUNCHES["lstm_seq"] == 0
    assert build.LAUNCHES["bilstm_seq_per_utterance"] == 0
    pair = torch.cat([lstm_cuda.lstm_seq(x, wih[d], whh[d], bias[d], lengths, bool(d), dtype)
                      for d in (0, 1)], dim=-1)
    assert got.dtype == dtype and torch.equal(got, pair)
    assert torch.equal(got, lstm_cuda._bilstm_seq_per_utterance(x, wih, whh, bias, lengths,
                                                                dtype))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), lstm_cuda.bilstm_seq_plain(
        x, wih, whh, bias, lengths, dtype).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_training_pair_equals_k3(cuda, dtype, res_dtype):
    """K11's training forward (output and residuals) and backward against
    K3 once a direction, bit for bit, and against the plain versions."""
    x, wih, whh, bias, lengths = _bilstm_case(cuda, dtype)
    H = whh.shape[1]
    build.reset_launches()
    out, acts, ct = lstm_cuda.bilstm_seq_train_fwd(x, wih, whh, bias, lengths, dtype, res_dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bilstm_seq_per_utterance"] == 0
    pair = [lstm_cuda.lstm_seq_train_fwd(x, wih[d], whh[d], bias[d], lengths, bool(d), dtype,
                                         res_dtype) for d in (0, 1)]
    assert torch.equal(out, torch.cat([pair[0][0], pair[1][0]], -1))
    assert torch.equal(acts, torch.stack([pair[0][1], pair[1][1]]))
    assert torch.equal(ct, torch.stack([pair[0][2], pair[1][2]]))
    oracle = lstm_cuda._bilstm_seq_per_utterance(x, wih, whh, bias, lengths, dtype, res_dtype)
    assert all(torch.equal(a, b) for a, b in zip((out, acts, ct), oracle))
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32)).to(cuda)
    got = lstm_cuda.bilstm_seq_bwd(gy, x, wih, whh, lengths, acts, ct)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["bilstm_seq_train_fwd"], build.LAUNCHES["bilstm_seq_bwd"]) == (1, 1)
    k3 = [lstm_cuda.lstm_seq_bwd(gy[..., d * H:(d + 1) * H].contiguous(), x, wih[d], whh[d],
                                 lengths, acts[d], ct[d], bool(d)) for d in (0, 1)]
    assert torch.equal(got[0], k3[0][0] + k3[1][0])
    for i in (1, 2, 3):
        assert torch.equal(got[i], torch.stack([k3[0][i], k3[1][i]]))
    want = lstm_cuda.bilstm_seq_bwd_plain(gy, x, wih, whh, lengths, acts, ct)
    for name, g, w in zip(("dx", "dwih", "dwhh", "db"), got, want):
        assert g.dtype == w.dtype, name
        assert _rel_err(g, w) <= (BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL), name


@pytest.mark.cuda
def test_bilstm_autograd_launches_the_training_pair(cuda):
    x, wih, whh, bias, lengths = _bilstm_case(cuda, torch.bfloat16)
    params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
    build.reset_launches()
    out = lstm_cuda.bilstm_seq(*params, lengths, torch.bfloat16)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (build.LAUNCHES["bilstm_seq_train_fwd"], build.LAUNCHES["bilstm_seq_bwd"],
            build.LAUNCHES["bilstm_seq"]) == (1, 1, 0)
    assert all(p.grad is not None and torch.isfinite(p.grad.float()).all() for p in params)


@pytest.mark.cuda
def test_bilstm_kernel_rejects_what_it_does_not_take(cuda):
    x, wih, whh, bias, lengths = _bilstm_case(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="stacked"):
        lstm_cuda.bilstm_seq(x, wih[0], whh[0], bias[0], lengths)
    with pytest.raises(ValueError, match="lengths"):
        lstm_cuda.bilstm_seq(x, wih, whh, bias, lengths.long())


def _bilstm_bwd_case(device, B, T, D, H, dtype, res_dtype, seed=14):
    """K11's backward inputs at width H: residuals from its training
    forward, lengths T, 0, past T, 1 and in between (``_bwd_case``'s), and
    a random upstream gradient (B, T, 2H)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = t(rng.standard_normal((B, T, D)) * 0.5).to(dtype)
    wih = t(rng.standard_normal((2, D, 4 * H)) / np.sqrt(D)).to(dtype)
    whh = t(rng.standard_normal((2, H, 4 * H)) / np.sqrt(H))
    bias = t(rng.standard_normal((2, 4 * H)) * 0.1)
    lengths = torch.tensor(([T, 0, T + 5, 1] + [2 + 7 * i % (T - 2) for i in range(B)])[:B],
                           dtype=torch.int32, device=device)
    _, acts, ct = lstm_cuda.bilstm_seq_train_fwd(x, wih, whh, bias, lengths, dtype, res_dtype)
    gy = t(rng.standard_normal((B, T, 2 * H)))
    return gy, x, wih, whh, lengths, acts, ct


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 8, 16])
@pytest.mark.parametrize("H", [384, 512, 640])
def test_bilstm_backward_grid_equals_the_oracle_and_two_k3_launches(cuda, H, B):
    """K11's backward on its dual grid (half the SMs a direction) equals the
    per-utterance dual oracle and two K3 backward launches bit for bit in
    all six outputs (dgates, hprev, dx, dwih, dwhh, db), at config 1's,
    config 2's and config 5's widths, float32 and bf16 residuals (x of
    their type); row 1, where B > 1, has length 0."""
    for dtype in (torch.float32, torch.bfloat16):
        bargs = _bilstm_bwd_case(cuda, B, 24, 64, H, dtype, dtype)
        gy, x, wih, whh, lengths, acts, ct = bargs
        grid = lstm_cuda.backward_grid(H, B, build.sm_count(0), directions=2)
        assert grid.directions == 2 and grid.ctas <= build.sm_count(0) // 2
        assert grid == lstm_cuda.backward_route(H, B, build.sm_count(0), directions=2)
        got_s, want_s = {}, {}
        build.reset_launches()
        got = lstm_cuda.bilstm_backward_on_route(grid, *bargs, scratch=got_s)
        torch.cuda.synchronize()
        assert {k: v for k, v in build.LAUNCHES.items() if v} == {"bilstm_seq_bwd": 1}
        build.reset_launches()
        want = lstm_cuda._bilstm_seq_bwd_per_utterance(*bargs, scratch=want_s)
        torch.cuda.synchronize()
        assert {k: v for k, v in build.LAUNCHES.items() if v} == {
            "bilstm_seq_bwd_per_utterance": 1}
        for name in ("dgates", "hprev"):
            assert torch.equal(got_s[name], want_s[name]), (name, dtype)
        for name, g, w in zip(("dx", "dwih", "dwhh", "db"), got, want):
            assert torch.equal(g, w), (name, dtype)
        k3, k3_s = [], [{}, {}]
        for d in (0, 1):
            k3.append(lstm_cuda.backward_on_route(
                lstm_cuda.backward_route(H, B, build.sm_count(0)),
                gy[..., d * H:(d + 1) * H].contiguous(), x, wih[d], whh[d], lengths, acts[d],
                ct[d], bool(d), scratch=k3_s[d]))
        for name in ("dgates", "hprev"):
            assert torch.equal(got_s[name], torch.stack([k3_s[0][name], k3_s[1][name]])), name
        assert torch.equal(got[0], k3[0][0] + k3[1][0])
        for i in (1, 2, 3):
            assert torch.equal(got[i], torch.stack([k3[0][i], k3[1][i]])), i
        if B > 1:
            assert not got_s["dgates"][:, 1].any() and not got[0][1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [384, 512, 640])
def test_bilstm_autograd_runs_the_dual_backward_grid(cuda, monkeypatch, H):
    """Autograd through ``bilstm_seq`` at those widths launches the dual
    backward grid once and its wide route never; with ``backward_route``
    forced to None the op takes the per-utterance kernel, counted as
    ``bilstm_seq_bwd_wide``, with the same bits.  A trace records CTA (0,
    0)'s steps in order."""
    B, T, D = 8, 20, 48
    bargs = _bilstm_bwd_case(cuda, B, T, D, H, torch.bfloat16, torch.bfloat16, seed=15)
    gy, x, wih, whh, lengths = bargs[:5]
    bias = torch.zeros((2, 4 * H), device=cuda)
    params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
    build.reset_launches()
    out = lstm_cuda.bilstm_seq(*params, lengths, torch.bfloat16)
    out.float().backward(gy)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"bilstm_seq_train_fwd": 1,
                                                              "bilstm_seq_bwd": 1}
    grid = lstm_cuda.backward_route(H, B, build.sm_count(0), directions=2)
    trace = torch.zeros((T, 5), dtype=torch.int64, device=cuda)
    want = lstm_cuda.bilstm_backward_on_route(grid, *bargs, trace=trace)
    torch.cuda.synchronize()
    steps = int(lengths.clamp(max=T).max())
    tr = trace[:steps].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:] >= tr[:, 1:4]).all())
    monkeypatch.setattr(lstm_cuda, "backward_route", lambda *args, **kwargs: None)
    build.reset_launches()
    got = lstm_cuda.bilstm_seq_bwd(*bargs)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"bilstm_seq_bwd_wide": 1}
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("H,B", [(384, 8), (512, 16), (640, 4)])
def test_lstm_grid_kernels_equal_the_per_utterance_kernel(cuda, H, B):
    """K2 and K3's forward on the co-resident grid, and K11's forward and
    training forward on its dual grid, at config 1's, config 2's and config
    5's widths, equal the per-utterance oracle (K11's old forward) bit for
    bit: the same dot order and cell update.  Short T; rows of length T, 0,
    past T and in between; both directions."""
    T, D = 24, 64
    x, wih, whh, bias, _ = _bilstm_case(cuda, torch.bfloat16, B, T, D, H)
    lengths = torch.tensor(([T, 0, T + 5, 1] + [2 + 7 * i % (T - 2) for i in range(B)])[:B],
                           dtype=torch.int32, device=cuda)
    build.reset_launches()
    oracle = lstm_cuda._bilstm_seq_per_utterance(x, wih, whh, bias, lengths, torch.bfloat16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bilstm_seq_per_utterance"] == 1
    build.reset_launches()
    k11 = lstm_cuda.bilstm_seq_infer(x, wih, whh, bias, lengths, torch.bfloat16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bilstm_seq"] == 1 and build.LAUNCHES["bilstm_seq_per_utterance"] == 0
    assert torch.equal(k11, oracle)
    for d in (0, 1):
        args = (x, wih[d], whh[d], bias[d], lengths, bool(d), torch.bfloat16)
        build.reset_launches()
        got = lstm_cuda.lstm_seq_infer(*args)
        torch.cuda.synchronize()
        assert build.LAUNCHES["lstm_seq"] == 1
        assert torch.equal(got, oracle[..., d * H:(d + 1) * H])
    for res in (torch.float32, torch.bfloat16):
        want = lstm_cuda._bilstm_seq_per_utterance(x, wih, whh, bias, lengths, torch.bfloat16,
                                                   res)
        build.reset_launches()
        dual = lstm_cuda.bilstm_seq_train_fwd(x, wih, whh, bias, lengths, torch.bfloat16, res)
        torch.cuda.synchronize()
        assert build.LAUNCHES["bilstm_seq_train_fwd"] == 1
        assert all(torch.equal(a, b) for a, b in zip(dual, want))
        out, acts, ct = want
        for d in (0, 1):
            build.reset_launches()
            got = lstm_cuda.lstm_seq_train_fwd(x, wih[d], whh[d], bias[d], lengths, bool(d),
                                               torch.bfloat16, res)
            torch.cuda.synchronize()
            assert build.LAUNCHES["lstm_seq_train_fwd"] == 1
            assert torch.equal(got[0], out[..., d * H:(d + 1) * H])
            assert torch.equal(got[1], acts[d]) and torch.equal(got[2], ct[d])


def _wide_case(device, B, T, D, H, seed=21):
    """bf16 x and wih (2, D, 4H), fp32 whh and bias at a scale that keeps the
    gates off saturation at any H; lengths T, 0 and in between."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = t(rng.standard_normal((B, T, D)) * 0.5).bfloat16()
    wih = t(rng.standard_normal((2, D, 4 * H)) / np.sqrt(D)).bfloat16()
    whh = t(rng.standard_normal((2, H, 4 * H)) / np.sqrt(H))
    bias = t(rng.standard_normal((2, 4 * H)) * 0.1)
    lengths = torch.tensor(([T, 0, 1, T - 3] + [2 + 5 * i % (T - 2) for i in range(B)])[:B],
                           dtype=torch.int32, device=device)
    return x, wih, whh, bias, lengths


def _forced_wide(monkeypatch):
    """Route every forward of the ops to the per-utterance kernel."""
    monkeypatch.setattr(lstm_cuda, "forward_route", lambda *args, **kwargs: None)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(4, 24), (8, 400)])
def test_wide_route_gives_the_grids_bits(cuda, monkeypatch, B, T):
    """At H 640, where both routes run, the per-utterance route of K2, K3's
    forward and K11 (forced) equals the grid's, bit for bit, counted under
    the wide names; the grid's own calls count none of them.  A short T,
    and a config's T 400 at B 8, where rows end long before T (lengths 0,
    1, 397 and in between) and the reverse direction fills their residuals
    past the window."""
    H = 640
    x, wih, whh, bias, lengths = _wide_case(cuda, B, T, 64, H)
    res = torch.bfloat16
    calls = {
        "lstm_seq": lambda d: lstm_cuda.lstm_seq_infer(x, wih[d], whh[d], bias[d], lengths,
                                                       bool(d), torch.bfloat16),
        "lstm_seq_train_fwd": lambda d: lstm_cuda.lstm_seq_train_fwd(
            x, wih[d], whh[d], bias[d], lengths, bool(d), torch.bfloat16, res),
        "bilstm_seq": lambda d: lstm_cuda.bilstm_seq_infer(x, wih, whh, bias, lengths,
                                                           torch.bfloat16),
        "bilstm_seq_train_fwd": lambda d: lstm_cuda.bilstm_seq_train_fwd(
            x, wih, whh, bias, lengths, torch.bfloat16, res)}
    wide = {"lstm_seq": "lstm_seq_wide", "lstm_seq_train_fwd": "lstm_seq_train_wide",
            "bilstm_seq": "bilstm_seq_wide", "bilstm_seq_train_fwd": "bilstm_seq_train_wide"}
    grid = {}
    for name, call in calls.items():
        for d in ((0, 1) if name.startswith("lstm") else (0,)):
            build.reset_launches()
            grid[name, d] = call(d)
            torch.cuda.synchronize()
            assert {k: v for k, v in build.LAUNCHES.items() if v} == {name: 1}, name
    _forced_wide(monkeypatch)
    for (name, d), want in grid.items():
        build.reset_launches()
        got = calls[name](d)
        torch.cuda.synchronize()
        assert {k: v for k, v in build.LAUNCHES.items() if v} == {wide[name]: 1}, name
        want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, d)


@pytest.mark.cuda
def test_wide_route_past_the_grid(cuda):
    """H 1536 at B 8 fits neither grid: K2, K3's training pair (its backward
    too) and K11's forwards run the per-utterance kernel under their wide
    counts, and hold to the plain versions (K3's gradients too)."""
    H, B, T, D = 1536, 8, 16, 48
    assert lstm_cuda.forward_route(H, B) is None
    assert lstm_cuda.forward_route(H, B, directions=2) is None
    x, wih, whh, bias, lengths = _wide_case(cuda, B, T, D, H)
    build.reset_launches()
    k2 = lstm_cuda.lstm_seq_infer(x, wih[1], whh[1], bias[1], lengths, True, torch.bfloat16)
    k11 = lstm_cuda.bilstm_seq_infer(x, wih, whh, bias, lengths, torch.bfloat16)
    k11t = lstm_cuda.bilstm_seq_train_fwd(x, wih, whh, bias, lengths, torch.bfloat16,
                                          torch.float32)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "lstm_seq_wide": 1, "bilstm_seq_wide": 1, "bilstm_seq_train_wide": 1}
    torch.testing.assert_close(k2.float(), lstm_cuda.lstm_seq_plain(
        x, wih[1], whh[1], bias[1], lengths, True, torch.bfloat16).float(),
        rtol=BF16_TOL, atol=BF16_TOL)
    want = lstm_cuda.bilstm_seq_plain(x, wih, whh, bias, lengths, torch.bfloat16)
    torch.testing.assert_close(k11.float(), want.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(k11t[0], k11)
    plain_t = lstm_cuda.bilstm_seq_train_plain(x, wih, whh, bias, lengths, torch.bfloat16,
                                               torch.float32)
    for name, g, w in zip(("acts", "ct"), k11t[1:], plain_t[1:]):
        assert _rel_err(g, w) <= F32_TOL * 10, name
    # K3's training pair under autograd: the wide forward, then the backward.
    params = [t.clone().requires_grad_(True) for t in (x, wih[0], whh[0], bias[0])]
    build.reset_launches()
    out = lstm_cuda.lstm_seq(*params, lengths, False, torch.bfloat16, torch.float32)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "lstm_seq_train_wide": 1, "lstm_seq_bwd_wide": 1}
    _, acts, ct = lstm_cuda.lstm_seq_train_plain(x, wih[0], whh[0], bias[0], lengths, False,
                                                 torch.bfloat16, torch.float32)
    want = lstm_cuda.lstm_seq_bwd_plain(2 * out.detach().float(), x, wih[0], whh[0], lengths,
                                        acts, ct)
    for name, p, w in zip(("dx", "dwih", "dwhh", "db"), params, want):
        assert _rel_err(p.grad, w) <= BF16_TOL, name


@pytest.mark.cuda
def test_dual_grid_trace_and_other_grids(cuda):
    """K11 on grids of fewer CTAs a direction than the rule's equals the
    rule's bit for bit; a trace records CTA (0, 0)'s steps in order."""
    B, T, D, H = 4, 20, 32, 384
    x, wih, whh, bias, _ = _bilstm_case(cuda, torch.float32, B, T, D, H)
    lengths = torch.tensor([T, 11, 0, 3], dtype=torch.int32, device=cuda)
    want = lstm_cuda.bilstm_seq_infer(x, wih, whh, bias, lengths)
    for units in (8, 12):
        grid = lstm_cuda.recurrence_grid(H, B, units=units, directions=2)
        assert torch.equal(lstm_cuda.bilstm_on_grid(grid, x, wih, whh, bias, lengths), want)
    trace = torch.zeros((T, 5), dtype=torch.int64, device=cuda)
    lstm_cuda.bilstm_on_grid(None, x, wih, whh, bias, lengths, trace=trace)
    tr = trace[:T].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:] >= tr[:, 1:4]).all())
    with pytest.raises(ValueError, match="direction"):
        lstm_cuda.bilstm_on_grid(lstm_cuda.recurrence_grid(H, B), x, wih, whh, bias, lengths)


# ---------------------------------------------------------------- the paired CTC alpha


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 91, 9, 30), (2, 1100, 5, 520)])
def test_ctc_paired_alpha_matches_plain(cuda, shape):
    """The paired alpha kernel against its plain version and K4's alphas;
    an odd T, a row of no frames, an infeasible row, and S past a warp's
    lanes (k 2 at S 1041)."""
    B, T, V, L = shape
    logits, logit_len, labels, label_len = _ctc_case(cuda, B, T, V, L)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ctc_alpha_paired"] == 1 and build.LAUNCHES["ctc_alpha"] == 0
    ref_alphas, ref_final = ctc.alphas_paired_plain(logp_tbs, skip, lens)
    torch.testing.assert_close(alphas, ref_alphas, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(final, ref_final, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    k4, k4_final = ctc_cuda.ctc_alpha(logp_tbs, skip, lens)
    live = k4 > ctc.NEG_INF / 2
    assert torch.equal(live, alphas > ctc.NEG_INF / 2)
    torch.testing.assert_close(alphas[live], k4[live], rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)


@pytest.mark.cuda
def test_ctc_paired_alpha_past_the_registers(cuda):
    """S 4097, past the register form: the paired alpha's wide form, counted
    apart, against the plain paired recursion."""
    B, T, V, L = 3, 2301, 30, 2048
    logits, logit_len, labels, label_len = _ctc_case(cuda, B, T, V, L)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    assert ctc_cuda.lane_plan(logp_tbs.shape[2]).form == "wide"
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"ctc_alpha_paired_wide": 1}
    ref_alphas, ref_final = ctc.alphas_paired_plain(logp_tbs, skip, lens)
    torch.testing.assert_close(alphas, ref_alphas, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(final, ref_final, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, k", [((6, 91, 9, 30), 1), ((2, 1100, 5, 520), 2),
                                      ((2, 2200, 30, 1500), 4)])
def test_ctc_paired_wide_form_gives_the_register_forms_bits(cuda, shape, k):
    """The paired alpha's register form at each of its states a lane (1, 2
    and 4: S 61, 1041 and 3001) gives the bits of its wide form, forced by
    ``wide``: the same arithmetic, the carried row from device memory."""
    B, T, V, L = shape
    logits, logit_len, labels, label_len = _ctc_case(cuda, B, T, V, L)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    plan = ctc_cuda.lane_plan(logp_tbs.shape[2])
    assert plan.form == "lanes" and plan.k == k
    build.reset_launches()
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens)
    wide, wide_final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens, wide=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in build.LAUNCHES.items() if c} == {"ctc_alpha_paired": 1,
                                                              "ctc_alpha_paired_wide": 1}
    assert torch.equal(wide, alphas) and torch.equal(wide_final, final)


@pytest.mark.cuda
def test_ctc_paired_alpha_rows_longer_than_t(cuda):
    """Lengths past an odd T end at T: the last pair's output is its single
    step, so the final row is alphas[T - 1], as in the plain version and
    the wide form (bit for bit)."""
    logits, logit_len, labels, label_len = _ctc_case(cuda, T=91)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.clone()
    lens[0], lens[3] = 200, 92
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens)
    ref_alphas, ref_final = ctc.alphas_paired_plain(logp_tbs, skip, lens)
    torch.testing.assert_close(alphas, ref_alphas, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    torch.testing.assert_close(final, ref_final, rtol=CTC_RTOL, atol=CTC_ALPHA_ATOL)
    assert torch.equal(final, alphas[-1])
    wide, wide_final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens, wide=True)
    assert torch.equal(wide, alphas) and torch.equal(wide_final, final)


@pytest.mark.cuda
def test_ctc_paired_trace_records_each_recursed_pair(cuda):
    """The paired alpha's trace: a row at the first frame of each pair t > 0
    that block 0 recurses (t = 2, 4, .. below its length), its clocks in
    phase order, and the same alphas as the untraced launch; the wide form
    refuses a trace."""
    logits, logit_len, labels, label_len = _ctc_case(cuda, T=91)
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    T = logp_tbs.shape[0]
    trace = torch.zeros((T, 8), dtype=torch.int64, device=cuda)
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens, trace=trace)
    want, want_final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens)
    assert torch.equal(alphas, want) and torch.equal(final, want_final)
    tr = trace.cpu()
    assert (tr[:, 0] != 0).nonzero().flatten().tolist() == list(range(2, int(lens[0]), 2))
    live = tr[tr[:, 0] != 0]
    assert bool((live[:, 2:8] >= live[:, 1:7]).all())
    with pytest.raises(ValueError, match="trace"):
        ctc_cuda.ctc_alpha_paired(logp_tbs, skip, lens, trace=trace, wide=True)


@pytest.mark.cuda
def test_ctc_loss_through_the_paired_alpha(cuda, monkeypatch):
    """``PAIRED_FWD`` routes the loss's alpha to the paired kernel; loss and
    gradient as K4's, as the JAX package holds its paired kernel."""
    logits, logit_len, labels, label_len = _ctc_case(cuda, T=91)
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    monkeypatch.setattr(ctc_cuda, "PAIRED_FWD", True)
    build.reset_launches()
    loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
    loss.sum().backward()
    torch.cuda.synchronize()
    assert (build.LAUNCHES["ctc_alpha_paired"], build.LAUNCHES["ctc_alpha"],
            build.LAUNCHES["ctc_beta"]) == (1, 0, 1)
    monkeypatch.setattr(ctc_cuda, "PAIRED_FWD", False)
    ref = ctc_cuda.ctc_loss(b, logit_len, labels, label_len)
    ref.sum().backward()
    torch.testing.assert_close(loss, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a.grad, b.grad, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------- K12, K13


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["prefix_beam_fused", "prefix_beam_stepwise"])
@pytest.mark.parametrize("planted", [True, False])
def test_study_beam_kernels_match_plain(cuda, kernel, planted):
    """K13 and K12 against the plain search with no LM on the card, bit for
    bit, the empty row included; K12 launches once a frame."""
    logits, lens, _ = _beam_case(cuda, 3, planted=planted)
    fn = (beam_cuda.prefix_beam_fused if kernel == "prefix_beam_fused"
          else beam_cuda.prefix_beam_lanes_stepwise)
    build.reset_launches()
    got = fn(logits, lens, beam_size=8, max_len=32)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel] == (1 if kernel == "prefix_beam_fused" else logits.shape[1])
    want = prefix_beam.prefix_beam_search_plain(logits, lens, beam_size=8, max_len=32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[1][2] == 0 and got[2][2] == 0


@pytest.mark.cuda
def test_study_beam_kernels_take_more_lanes_than_threads(cuda):
    """K (V - 1) = 16 * 95 = 1520 lanes: threads loop over lanes."""
    logits, lens, _ = _beam_case(cuda, 5, V=96)
    want = prefix_beam.prefix_beam_search_plain(logits, lens, beam_size=16, max_len=24)
    for fn in (beam_cuda.prefix_beam_fused, beam_cuda.prefix_beam_lanes_stepwise):
        got = fn(logits, lens, beam_size=16, max_len=24)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_stepwise_state_equals_the_plain_frames_every_frame(cuda):
    """K12 against the plain frames with L 12, so beams fill: the pointers of
    every frame, and the state after every frame (from a run cut after that
    frame), every field bit for bit, dead beams included."""
    logits, lens, _ = _beam_case(cuda, 4, planted=False)
    logp = torch.log_softmax(logits, -1).contiguous()
    B, T, _ = logp.shape
    K, L = 8, 12
    want = prefix_beam.prefix_beam_stepwise_plain(logp, lens, K, L)
    got = {}
    beam_cuda.prefix_beam_lanes_stepwise(logits, lens, K, 0, L, scratch=got)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    for t in range(1, T):
        cut = {}
        beam_cuda.prefix_beam_lanes_stepwise(logits[:, :t], lens, K, 0, L, scratch=cut)
        want = prefix_beam.prefix_beam_stepwise_plain(logp[:, :t], lens, K, L)
        for name in ("pb", "pnb", "hash", "last", "length"):
            assert torch.equal(cut[name], want[name]), (t, name)


@pytest.mark.cuda
def test_study_beam_kernels_reject_what_they_do_not_take(cuda):
    """Past a block's shared memory both run (in a scratch); they refuse an
    empty beam, another blank, and shapes past their int32 indices."""
    logits, lens, _ = _beam_case(cuda, 3)
    with pytest.raises(ValueError, match="beam_size"):
        beam_cuda.prefix_beam_lanes_stepwise(logits, lens, beam_size=0)
    with pytest.raises(ValueError, match="int32"):
        beam_cuda.prefix_beam_fused(logits, lens, beam_size=2, max_len=2 ** 30)
    with pytest.raises(ValueError, match="int32"):
        beam_cuda.prefix_beam_lanes_stepwise(logits, lens, beam_size=2 ** 31 // 31 + 1)
    with pytest.raises(ValueError, match="blank"):
        beam_cuda.prefix_beam_fused(logits, lens, blank=3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,V,L", [("prefix_beam_fused", 31, 1024),
                                        ("prefix_beam_stepwise", 1024, 24)])
def test_study_beam_kernels_past_a_block_run_in_scratch(cuda, kernel, V, L):
    """K13 at beam 32 with max_len 1024 (token buffers of 256 KB) and K12 at
    beam 32 over 1024 chars (frame arrays of ~420 KB) pass a block's shared
    memory: the kernel runs with its working set in a device scratch,
    counted under its wide name, and equals the plain search bit for bit
    (K12's pointers and last state too)."""
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.standard_normal((4, 40, V)).astype(np.float32) * 2).to(cuda)
    lens = torch.tensor([40, 27, 0, 13], dtype=torch.int32, device=cuda)
    fused = kernel == "prefix_beam_fused"
    assert not (beam_cuda.study_fits(32, V, L) if fused else beam_cuda.study_fits(32, V))
    got_steps = {}
    build.reset_launches()
    got = (beam_cuda.prefix_beam_fused(logits, lens, 32, 0, L) if fused
           else beam_cuda.prefix_beam_lanes_stepwise(logits, lens, 32, 0, L, scratch=got_steps))
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        f"{kernel}_wide": 1 if fused else logits.shape[1]}
    want = prefix_beam.prefix_beam_search_plain(logits, lens, beam_size=32, max_len=L)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if not fused:
        logp = torch.log_softmax(logits, -1).contiguous()
        for name, w in prefix_beam.prefix_beam_stepwise_plain(logp, lens, 32, L).items():
            assert torch.equal(got_steps[name], w), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["prefix_beam_fused", "prefix_beam_stepwise"])
def test_study_beam_scratch_form_gives_the_shared_forms_bits(cuda, monkeypatch, kernel):
    """At K7's row shape (K 16 over 31 chars, L 256), where both run, the
    in-scratch form (forced) equals the shared form bit for bit: the same
    code in the same order.  L 24 fills beams (full-beam fillers)."""
    logits, lens, _ = _beam_case(cuda, 14, B=16, T=120)
    fn = (beam_cuda.prefix_beam_fused if kernel == "prefix_beam_fused"
          else beam_cuda.prefix_beam_lanes_stepwise)
    for L in (256, 24):
        shared_steps = {}
        build.reset_launches()
        shared = fn(logits, lens, 16, 0, L, **({"scratch": shared_steps}
                                               if kernel == "prefix_beam_stepwise" else {}))
        torch.cuda.synchronize()
        assert not build.LAUNCHES[f"{kernel}_wide"] and build.LAUNCHES[kernel]
        with monkeypatch.context() as m:
            m.setattr(beam_cuda, "study_fits", lambda *args, **kwargs: False)
            wide_steps = {}
            build.reset_launches()
            wide = fn(logits, lens, 16, 0, L, **({"scratch": wide_steps}
                                                 if kernel == "prefix_beam_stepwise" else {}))
            torch.cuda.synchronize()
            assert not build.LAUNCHES[kernel] and build.LAUNCHES[f"{kernel}_wide"]
        assert all(torch.equal(a, b) for a, b in zip(wide, shared))
        assert all(torch.equal(wide_steps[k], shared_steps[k]) for k in shared_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,cols", [("prefix_beam_fused", 8), ("prefix_beam_stepwise", 9)])
def test_study_beam_trace_runs(cuda, kernel, cols):
    """Block 0's trace of each frame: the global clock rises frame to frame,
    each frame's phase clocks rise in order, and tracing changes no bit."""
    logits, lens, _ = _beam_case(cuda, 27)
    fn = (beam_cuda.prefix_beam_fused if kernel == "prefix_beam_fused"
          else beam_cuda.prefix_beam_lanes_stepwise)
    trace = torch.zeros((logits.shape[1], cols), dtype=torch.int64, device=cuda)
    got = fn(logits, lens, 16, 0, 24, trace=trace)
    want = fn(logits, lens, 16, 0, 24)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tr = trace[: int(lens[0])].cpu()
    assert bool((tr[1:, 0] >= tr[:-1, 0]).all()) and bool((tr[:, 2:8] >= tr[:, 1:7]).all())
    if kernel == "prefix_beam_stepwise":
        assert bool((tr[:, 8] >= tr[:, 0]).all())
    assert not trace[int(lens[0]):].any()


def _stream_case(device, dtype, B=5, T=13, D=40, H=48, seed=20):
    """lstm_seq_stream's inputs: rows of length T, 0, past T, 1 and between,
    and a carried state (h0, c0) float32."""
    x, wih, whh, bias, _ = _lstm_case(device, dtype, B, T, D, H)
    lengths = torch.tensor([T, 0, T + 4, 1, T // 2][:B], dtype=torch.int32, device=device)
    g = torch.Generator().manual_seed(seed)
    h0, c0 = ((torch.randn(B, H, generator=g) * 0.3).to(device) for _ in range(2))
    return x, wih, whh, bias, lengths, h0, c0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [48, 384])
def test_lstm_stream_matches_plain(cuda, dtype, H):
    """K2 from a carried state against ``lstm_seq_plain`` with the carry: the
    output, and the state after each row's last valid step (a row of no
    steps hands on h0 and c0 as they are)."""
    args = _stream_case(cuda, dtype, H=H)
    build.reset_launches()
    out, hT, cT = lstm_cuda.lstm_seq_stream(*args, dtype)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_stream": 1}
    want = lstm_cuda.lstm_seq_plain(*args[:5], False, dtype, *args[5:])
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol, atol=tol)
    for got, ref in zip((hT, cT), want[1:]):
        torch.testing.assert_close(got, ref, rtol=F32_TOL, atol=F32_TOL)
    assert torch.equal(hT[1], args[5][1]) and torch.equal(cT[1], args[6][1])
    assert not out[1].any() and not out[3, 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("H,B,T", [(48, 5, 6), (384, 8, 4), (384, 1, 12)])
def test_lstm_stream_chunks_equal_one_launch(cuda, H, B, T):
    """Chunks of T steps carrying (h, c) give the bits of one K2 launch over
    their frames (from zeros), and of one carried launch (from (h0, c0)),
    the final state too."""
    n = 5
    x, wih, whh, bias, _, h0, c0 = _stream_case(cuda, torch.bfloat16, B, n * T, 64, H)
    seq = torch.tensor(([n * T, 0, 2 * T + 1, n * T - 1, 3] + [n * T] * B)[:B],
                       dtype=torch.int32, device=cuda)
    one_k2 = lstm_cuda.lstm_seq_infer(x, wih, whh, bias, seq, False, torch.bfloat16)
    one = lstm_cuda.lstm_seq_stream(x, wih, whh, bias, seq, h0, c0, torch.bfloat16)
    zeros = torch.zeros_like(h0)
    for start, whole in (((zeros, zeros), (one_k2,)), ((h0, c0), one)):
        parts, (h, c) = [], start
        for i in range(n):
            part = torch.clamp(seq - i * T, 0, T).int()
            o, h, c = lstm_cuda.lstm_seq_stream(x[:, i * T:(i + 1) * T].contiguous(), wih, whh,
                                                bias, part, h, c, torch.bfloat16)
            parts.append(o)
        assert torch.equal(torch.cat(parts, dim=1), whole[0])
        if len(whole) == 3:
            assert torch.equal(h, whole[1]) and torch.equal(c, whole[2])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [48, 384])
def test_lstm_stream_wide_form_equals_the_grid(cuda, H):
    """The per-utterance form (``stream_on_route(None, ...)``, counted
    ``lstm_seq_stream_wide``) gives the grid's bits; past the grid the op
    takes it (forced here by a route of None)."""
    args = _stream_case(cuda, torch.bfloat16, H=H)
    grid = lstm_cuda.forward_route(H, 5, build.sm_count(cuda.index or 0))
    assert grid is not None
    build.reset_launches()
    on_grid = lstm_cuda.stream_on_route(grid, *args, torch.bfloat16)
    wide = lstm_cuda.stream_on_route(None, *args, torch.bfloat16)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"lstm_seq_stream": 1,
                                                               "lstm_seq_stream_wide": 1}
    assert all(torch.equal(a, b) for a, b in zip(on_grid, wide))


@pytest.mark.cuda
def test_lstm_stream_refuses_what_it_does_not_take(cuda):
    x, wih, whh, bias, lengths, h0, c0 = _stream_case(cuda, torch.float32)
    with pytest.raises(ValueError, match="h0"):
        lstm_cuda.lstm_seq_stream(x, wih, whh, bias, lengths, h0[:2], c0)
    with pytest.raises(ValueError, match="c0"):
        lstm_cuda.lstm_seq_stream(x, wih, whh, bias, lengths, h0, c0.double())
    with pytest.raises(ValueError, match="forward only"):
        lstm_cuda.lstm_seq_stream(x, wih, whh, bias, lengths, h0, c0, reverse=True)


# The carried forms of K7, K8 and K9: a chunk of a stream from a BeamState.
CARRY_FORMS = {  # form: (ext_top_a, LM, route forced off, working set forced into a scratch)
    "k7": (0, None, False, False), "k7_dense": (0, "dense", False, False),
    "k8_dense": (8, "dense", False, False), "k9_grid": (0, "rnn", False, False),
    "k9_topa_grid": (8, "rnn", False, False), "k9_block": (0, "rnn", True, False),
    "k9_topa_block": (8, "rnn", True, False), "k7_wide": (0, "dense", False, True),
    "k9_wide": (8, "rnn", True, True)}
CARRY_CUTS = (1, 7, 12, 20)


def _carry_name(A: int, lm, block: bool, wide: bool) -> str:
    base = "prefix_beam_rnn" if lm == "rnn" else "prefix_beam"
    name = base + ("_topa" if A else "") + "_carry"
    return name + ("_wide" if wide else "_block" if lm == "rnn" and block else "")


def _carry_case(device, lm, K: int = 8, L: int = 24):
    """Planted logits (4 rows of 40, 27, 0 and 13 frames), the fusion
    keywords and the initial LMCarry."""
    logits, lens, table = _beam_case(device, 31, B=4, T=40, gain=8.0)
    kw = {} if lm is None else dict(lm_alpha=0.5, lm_beta=1.0)
    carry = None
    if lm == "dense":
        kw["lm_table"] = table
    elif lm == "rnn":
        kw["rnn_lm"] = _rnn_lm(device, 2)
        carry = prefix_beam.rnn_lm_carry_init(kw["rnn_lm"], 4, K, 29)
    return logits, lens, kw, carry


def _carry_chunks(logp, lens, state, carry, kw, cuts=CARRY_CUTS):
    """The carried search over ``cuts`` of the frames: (state, carry, best)."""
    t0, best = 0, None
    for n in cuts:
        part = torch.clamp(lens - t0, 0, n).to(torch.int32)
        state, carry, best = prefix_beam.prefix_beam_continue_best(
            state, logp[:, t0:t0 + n].contiguous(), part, lm_carry=carry, **kw)
        t0 += n
    return state, carry, best


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(CARRY_FORMS))
def test_carried_search_over_chunks_equals_the_kernel_offline(cuda, monkeypatch, form):
    """Chunks of 1, 7, 12 and 20 frames through a carried form give the bits
    of the same form in one launch over all 40 frames on every beam (each
    BeamState and LMCarry field, dead beams included), and the best beam's
    tokens, length and score of the offline kernel on that route; one launch
    a chunk, counted under the form's name.  L 24 lets beams fill."""
    A, lm, block, wide = CARRY_FORMS[form]
    if block:
        monkeypatch.setattr(beam_cuda, "rnn_grid_route", lambda *args, **kwargs: None)
    if wide:
        monkeypatch.setattr(beam_cuda, "fits", lambda *args, **kwargs: False)
    K, L = 8, 24
    logits, lens, kw, carry0 = _carry_case(cuda, lm, K, L)
    kw["ext_top_a"] = A
    logp = torch.log_softmax(logits, dim=-1)
    init = prefix_beam.prefix_beam_init(4, K, L, cuda)
    whole = prefix_beam.prefix_beam_continue_best(init, logp, lens, lm_carry=carry0, **kw)
    build.reset_launches()
    got = _carry_chunks(logp, lens, init, carry0, kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        _carry_name(A, lm, block, wide): len(CARRY_CUTS)}
    for name, a, b in zip(prefix_beam.BeamState._fields, got[0], whole[0]):
        assert torch.equal(a, b), name
    if lm == "rnn":
        for name, a, b in zip(prefix_beam.LMCarry._fields, got[1], whole[1]):
            assert torch.equal(a, b), name
    offline = prefix_beam.prefix_beam_search(logits, lens, beam_size=K, max_len=L, sos_id=29,
                                             **kw)
    for a, b, c in zip(got[2], whole[2], offline):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(got[0].length.max()) >= L and got[2][1][2] == 0   # beams fill; the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("lm", [None, "dense", "rnn"])
def test_carried_search_matches_the_plain_carried_search(cuda, A, lm):
    """After each chunk, the carried kernel's live beams (in the same
    places as the plain search's: live candidates rank alike in both lane
    layouts) against ``continue_plain`` on the card: K7 and K8 bit for bit,
    K9 with its int fields, and its tokens below each beam's length, exact
    and its scores and LM state within RNN_RTOL / RNN_ATOL (max_len above
    the frames, as K9's tests keep it: full beams only stay and tie to the
    last ulps).  Dead fillers may differ (K7's lanes include the blank's)."""
    K, L = 8, 48 if lm == "rnn" else 24
    logits, lens, kw, carry = _carry_case(cuda, lm, K, L)
    logp = torch.log_softmax(logits, dim=-1)
    state = plain = prefix_beam.prefix_beam_init(4, K, L, cuda)
    plain_carry, t0 = carry, 0
    for n in CARRY_CUTS:
        part = torch.clamp(lens - t0, 0, n).to(torch.int32)
        chunk = logp[:, t0:t0 + n].contiguous()
        state, carry, _ = prefix_beam.prefix_beam_continue_best(state, chunk, part,
                                                                lm_carry=carry, ext_top_a=A, **kw)
        top = prefix_beam.top_a(chunk, A) if A else (None, None)
        plain, plain_carry = prefix_beam.continue_plain(
            plain, chunk, part, kw.get("lm_table"), kw.get("lm_alpha", 0.0),
            kw.get("lm_beta", 0.0), *top, rnn_lm=kw.get("rnn_lm"), lm_carry=plain_carry)
        t0 += n
        live = prefix_beam._lse(plain.pb, plain.pnb) > prefix_beam.NEG_INF / 2
        assert torch.equal(prefix_beam._lse(state.pb, state.pnb) > prefix_beam.NEG_INF / 2, live)
        below = (torch.arange(L, device=cuda) < plain.length[..., None]) & live[..., None]
        assert torch.equal(torch.where(below, state.tokens, 0), torch.where(below, plain.tokens, 0))
        for name in ("length", "hash", "ctx", "last"):
            assert torch.equal(getattr(state, name)[live], getattr(plain, name)[live]), name
        for name in ("pb", "pnb", "lm_s"):
            got, want = getattr(state, name)[live], getattr(plain, name)[live]
            if lm == "rnn":
                torch.testing.assert_close(got, want, rtol=RNN_RTOL, atol=RNN_ATOL)
            else:
                assert torch.equal(got, want), name
        if lm == "rnn":
            for a, b in zip(carry, plain_carry):
                torch.testing.assert_close(a[:, live] if a.dim() == 4 else a[live],
                                           b[:, live] if b.dim() == 4 else b[live],
                                           rtol=RNN_RTOL, atol=RNN_ATOL)


@pytest.mark.cuda
def test_carried_search_hands_on_a_row_with_no_frames_unchanged(cuda):
    """A chunk in which no row has a valid frame (K9's grid then runs no
    step) and a chunk of no frames hand every field and LM state on as
    they were."""
    K, L = 8, 24
    logits, lens, kw, carry = _carry_case(cuda, "rnn", K, L)
    logp = torch.log_softmax(logits, dim=-1)
    state, carry, _ = _carry_chunks(logp, lens, prefix_beam.prefix_beam_init(4, K, L, cuda),
                                    carry, kw, (9,))
    no_frames = torch.zeros(4, dtype=torch.int32, device=cuda)
    for chunk, n_valid in ((logp[:, :5], no_frames), (logp[:, :0], lens)):
        for lm_kw in ({}, kw):
            c = carry if lm_kw else None
            new, new_carry, _ = prefix_beam.prefix_beam_continue_best(
                state, chunk.contiguous(), n_valid, lm_carry=c, **lm_kw)
            assert all(torch.equal(a, b) for a, b in zip(new, state))
            if lm_kw:
                assert all(torch.equal(a, b) for a, b in zip(new_carry, carry))


@pytest.mark.cuda
def test_carried_search_refuses_what_it_does_not_take(cuda):
    K, L = 8, 24
    logits, lens, kw, carry = _carry_case(cuda, "rnn", K, L)
    logp = torch.log_softmax(logits, dim=-1)
    state = prefix_beam.prefix_beam_init(4, K, L, cuda)
    with pytest.raises(ValueError, match="state.pb"):
        beam_cuda.prefix_beam_carry(state._replace(pb=state.pb.double()), logp, lens)
    with pytest.raises(ValueError, match="state.tokens"):
        beam_cuda.prefix_beam_carry(state._replace(tokens=state.tokens[:2]), logp, lens)
    with pytest.raises(ValueError, match="lm_carry.h"):
        beam_cuda.prefix_beam_rnn_carry(state, carry._replace(h=carry.h[:1]), logp, lens,
                                        kw["rnn_lm"], 0.5, 1.0)


# ------------------------------------------------ the hashed n-gram LM (K7, K8, K10)

HASHED_FORMS = {"K7": (0, 0), "K7_lm_top_k": (0, 24), "K8": (16, 0)}


def _hashed_case(device, B: int = 4, T: int = 60, seed: int = 3):
    """The synthetic BPE vocab's piece 4-gram as hashed tables on ``device``
    and planted log-probs (B, T, 135): each row's transcript a piece every
    other frame, blanks between; ragged lengths with an empty row."""
    from pytorch_asr_tpu_torch.data.bpe import train_bpe
    from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
    from pytorch_asr_tpu_torch.decoding import lm as lm_mod
    from pytorch_asr_tpu_torch.decoding.lm_hashed import build_hashed_lm

    texts = synthetic_texts(512)
    tok = train_bpe(texts, 256)
    hash_lm = build_hashed_lm(lm_mod.train_char_ngram_kn(texts, 4, tokenizer=tok),
                              tok.vocab_size, device)
    g = np.random.default_rng(seed)
    logits = g.standard_normal((B, T, tok.vocab_size)).astype(np.float32)
    for b in range(B):
        ids = tok.encode(texts[7 * b] + " " + texts[7 * b + 1])
        for t in range(T):
            logits[b, t, ids[t // 2] if t % 2 == 0 and t // 2 < len(ids) else 0] += 6.0
    logp = torch.log_softmax(torch.from_numpy(logits), -1).to(device).contiguous()
    lens = torch.tensor([T, T - 10, T // 2, 0][:B], dtype=torch.int32, device=device)
    return hash_lm, logp, lens


def _hashed_tops(logp, A: int, k: int):
    tv, ti = prefix_beam.top_a(logp, A) if A else (None, None)
    return tv, ti, (prefix_beam.top_a(logp, k)[1] if k else None)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("form", sorted(HASHED_FORMS))
def test_hashed_search_matches_the_plain_search(cuda, monkeypatch, form, wide):
    """K7 (over all pieces, and with lm_top_k's exact set) and K8 with the
    hashed tables, in shared memory and (``fits`` forced off) in scratch:
    the plain hashed search's tokens, lengths and scores bit for bit, one
    launch each under its name."""
    hash_lm, logp, lens = _hashed_case(cuda)
    A, k = HASHED_FORMS[form]
    tv, ti, ex = _hashed_tops(logp, A, k)
    if wide:
        monkeypatch.setattr(beam_cuda, "fits", lambda *a, **kw: False)
    build.reset_launches()
    got = beam_cuda.prefix_beam(logp, lens, 16, 40, None, 0.8, 1.0, tv, ti, hash_lm=hash_lm,
                                exact_idx=ex)
    torch.cuda.synchronize()
    name = ("prefix_beam_topa" if A else "prefix_beam") + "_hashed" + ("_wide" if wide else "")
    assert {n: c for n, c in build.LAUNCHES.items() if c} == {name: 1}
    want = prefix_beam.beam_scan_plain(logp, lens, 16, 40, None, 0.8, 1.0, tv, ti,
                                       hash_lm=hash_lm, exact_idx=ex)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1][0]) > 5 and int(got[1][3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(HASHED_FORMS))
def test_hashed_carried_search_matches_the_plain_carried_search(cuda, form):
    """The hashed carried form over three chunks from zero windows: after
    each chunk the live beams' fields (windows included) are the plain
    carried search's bit for bit, and the best beam the offline kernel's."""
    hash_lm, logp, lens = _hashed_case(cuda)
    A, k = HASHED_FORMS[form]
    state = plain = prefix_beam.prefix_beam_init(4, 16, 40, cuda, ctx_width=3)
    build.reset_launches()
    for t0 in range(0, logp.shape[1], 20):
        blk = logp[:, t0:t0 + 20].contiguous()
        nv = torch.clamp(lens - t0, 0, 20).to(torch.int32)
        tv, ti, ex = _hashed_tops(blk, A, k)
        state, best = beam_cuda.prefix_beam_carry(state, blk, nv, None, 0.8, 1.0, tv, ti,
                                                  hash_lm=hash_lm, exact_idx=ex)
        plain, _ = prefix_beam.continue_plain(plain, blk, nv, None, 0.8, 1.0, tv, ti,
                                              hash_lm=hash_lm, exact_idx=ex)
        live = prefix_beam._lse(plain.pb, plain.pnb) > prefix_beam.NEG_INF / 2
        for f in ("length", "pb", "pnb", "lm_s", "hash", "ctx", "last"):
            assert torch.equal(getattr(state, f)[live], getattr(plain, f)[live]), f
    name = ("prefix_beam_topa" if A else "prefix_beam") + "_hashed_carry"
    assert {n: c for n, c in build.LAUNCHES.items() if c} == {name: 3}
    tv, ti, ex = _hashed_tops(logp, A, k)
    offline = beam_cuda.prefix_beam(logp, lens, 16, 40, None, 0.8, 1.0, tv, ti, hash_lm=hash_lm,
                                    exact_idx=ex)
    for a, b in zip(best, offline):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_merge_window_form_matches_the_plain_merge(cuda, monkeypatch, wide):
    """K10 with (B, Ks, 3) and (B, Ks, V-1, 3) windows over twelve frames of
    the hashed search: every pick, dead fillers included, and every field
    (the windows' columns too) equal the plain merge's."""
    hash_lm, logp, lens = _hashed_case(cuda)
    if wide:
        monkeypatch.setattr(beam_cuda, "merge_fits", lambda *a: False)
    B, K, L, V = logp.shape[0], 16, 40, logp.shape[-1]
    state = prefix_beam._init_state(B, K, L, cuda, 3)
    build.reset_launches()
    for t in range(12):
        rows = prefix_beam.hashed_rows(hash_lm, state.ctx)
        stay, ext = prefix_beam._build_candidates(state, logp[:, t], blank=0, vocab=V,
                                                  lm_table=None, lm_rows=rows, lm_alpha=0.8,
                                                  lm_beta=1.0, K=K, L=L)
        stay = {n: v.contiguous() for n, v in stay.items()}
        ext = {n: v.contiguous() for n, v in ext.items()}
        score, got = beam_cuda.merge_topk(stay, ext, K)
        want_score, want = prefix_beam._merge_topk(stay, ext, K)
        assert torch.equal(score, want_score)
        for n in got:
            assert torch.equal(got[n], want[n].to(got[n].dtype)), n
        assert got["ctx"].shape == (B, K, 3)
        state = prefix_beam._finish_step(state, want, t < lens, L)
    assert {n: c for n, c in build.LAUNCHES.items() if c} == {
        "merge_topk_wide" if wide else "merge_topk": 12}
