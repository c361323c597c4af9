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
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
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
# K9: its LM products are fp32 sums in another order than torch.matmul's, so
# the fused scores drift by a few ulps a frame; planted-path inputs keep the
# search decisive (tokens and lengths exact), and the scores are held as the
# JAX package holds its own K9 on hardware (tests/test_tpu_parity.py).
RNN_RTOL, RNN_ATOL = 2e-3, 1e-3
# TCN block: fp32 products (FMA in k order in the forward, 3xTF32 on tensor
# cores in the backward) against cuBLAS's blocked sums, the JAX package's
# 2e-4 (relative to each tensor's largest entry);
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
    # Beam 64 at H 512: the LM step's packed inputs alone (64 x 1024 floats)
    # pass a block's shared memory, wherever the state lives.
    big = _rnn_lm(cuda, 1, 128, 512)
    with pytest.raises(ValueError, match="shared memory"):
        beam_cuda.prefix_beam_rnn(logp, lens, 64, 8, big, *prefix_beam.primed_lm_state(big, 29),
                                  0.5, 1.0)
    lm = _rnn_lm(cuda, 1)
    h0, c0, lmp0 = prefix_beam.primed_lm_state(lm, 29)
    with pytest.raises(ValueError, match="h0"):
        beam_cuda.prefix_beam_rnn(logp, lens, 4, 8, lm, h0.double(), c0, lmp0, 0.5, 1.0)
    with pytest.raises(ValueError, match="lmp0"):
        beam_cuda.prefix_beam_rnn(logp, lens, 4, 8, lm, h0, c0, lmp0[:-1], 0.5, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("E,H,nl,K", [(128, 512, 2, 16), (128, 256, 3, 16), (128, 256, 2, 32)])
def test_prefix_beam_rnn_kernel_past_shared_memory(cuda, E, H, nl, K):
    """LMs whose state does not fit a block's shared memory beside the
    search (H 512, 3 layers, beam 32 with the default widths): K9 keeps it
    in a device scratch and matches the plain search on planted paths."""
    assert beam_cuda.rnn_smem_bytes(K, 31, 31, nl, E, H) > beam_cuda.MAX_SMEM
    logits, lens, _ = _beam_case(cuda, 6, B=3, T=40)
    kw = dict(beam_size=K, max_len=24, rnn_lm=_rnn_lm(cuda, nl, E, H), sos_id=29,
              lm_alpha=0.5, lm_beta=1.0)
    for A in (0, 8):
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(logits, lens, ext_top_a=A, **kw)
        torch.cuda.synchronize()
        assert build.LAUNCHES["prefix_beam_rnn_topa" if A else "prefix_beam_rnn"] == 1
        want = prefix_beam.prefix_beam_search_plain(logits, lens, ext_top_a=A, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL)


def _merge_case(device, P: int, frames: int, table: bool, seed: int = 7):
    """One frame's candidates gathered from P beam shards (``parent_offset``)
    of a state the plain search advanced ``frames`` frames, on logits whose
    chars 3 and 4 are equal at every frame (exact ties from identical
    operations, the table's columns too); row 2 has no frames: its V live
    candidates leave K - V dead picks."""
    B, T, V, K = 4, frames + 1, 8, 16
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


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("frames", [1, 9])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_merge_topk_kernel_matches_plain(cuda, P, frames, table):
    """K10 against the plain merge, every field bit for bit, dead picks too."""
    stay, ext, K = _merge_case(cuda, P, frames, table)
    build.reset_launches()
    score, got = beam_cuda.merge_topk(stay, ext, K)
    torch.cuda.synchronize()
    assert build.LAUNCHES["merge_topk"] == 1
    want_score, want = prefix_beam._merge_topk(stay, ext, K)
    assert torch.equal(score, want_score)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert (want_score[2] <= prefix_beam.NEG_INF / 2).any()     # dead picks were compared


@pytest.mark.cuda
def test_merge_topk_kernel_rejects_what_it_does_not_take(cuda):
    stay, ext, K = _merge_case(cuda, 2, 1, False)
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
    T = 9 is shorter than the conv's reach 2 d (K // 2) for d >= 4.  The
    backward (3xTF32 on tensor cores, split-K summed in a fixed order, no
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
    want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *p, dilation)
    want = (tcn_cuda.tcn_block_plain(x, *p, dilation), want_y, want_xn,
            *tcn_cuda.tcn_block_bwd_plain(want_xn, dy, p[2], p[3], p[4], dilation))
    for name, g, w in zip(("out", "y", "xn", "dxn", "dwc", "dbc", "dwp", "dbp"),
                          (out, y, xn, *grads), want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= TCN_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("C", [30, 384])
def test_tcn_backward_at_other_widths(cuda, C):
    """The backward at C 30 (4-byte copies: rows are not 16-byte aligned)
    and at config 3's C 384 (tiles that do not cross a tap), against the
    plain version."""
    x, p = _tcn_case(cuda, B=2, T=61, C=C)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(C)).to(cuda)
    xn = tcn_cuda.layer_norm(x, p[0], p[1]).contiguous()
    got = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], 2)
    want = tcn_cuda.tcn_block_bwd_plain(xn, dy, p[2], p[3], p[4], 2)
    for name, g, w in zip(("dxn", "dwc", "dbc", "dwp", "dbp"), got, want):
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
    an odd T, a row of no frames, an infeasible row, and S past the threads."""
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
    logits, lens, _ = _beam_case(cuda, 3)
    with pytest.raises(ValueError, match="shared memory"):
        beam_cuda.prefix_beam_fused(logits, lens, beam_size=64, max_len=1024)
    with pytest.raises(ValueError, match="beam_size"):
        beam_cuda.prefix_beam_lanes_stepwise(logits, lens, beam_size=2048)
    with pytest.raises(ValueError, match="blank"):
        beam_cuda.prefix_beam_fused(logits, lens, blank=3)
