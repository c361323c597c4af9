"""Chip smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which must pass (any failure exits non-zero before the
result line):
  1. print the card (``nvidia-smi`` name and power limit) and the versions;
     build the CUDA kernels from ``pytorch_asr_tpu_torch/csrc`` (set-up);
  2. hold each kernel against its plain PyTorch version at the full shapes
     of the serving and training paths: the STFT log-mel (K1), the LSTM
     inference forward (K2), the LSTM training forward and backward (K3)
     and the CTC alpha and beta recursions (K4); time kernel, plain version
     and a PyTorch library yardstick with CUDA events (median of repeated
     runs of queued calls, after warm-up); K2 also at config 2's layer
     shape; print the co-resident grid of K2's and K3's forward recurrence
     and its µs a step (profiler), and sweep the grid's CTAs;
  3. run the model at float32 on one synthetic batch on the CPU and on the
     card with the same seeded weights; compare logits and greedy tokens;
     then one float32 train step, card vs CPU: loss, gradients, and the
     parameters after one AdamW step;
  4. drive the serving path, ``pytorch_asr_tpu_torch.decode.main``, and the
     training path, ``pytorch_asr_tpu_torch.train.main``, with
     ``ctc_bilstm_dev1h`` at full width in bf16 on 10-16 s utterances, each
     with the launch counters set to 0 just before and read just after;
  5. train the tiny config of the JAX package's end-to-end test to a low
     WER on the card, then beam-decode it with the LM: no worse than greedy;
  6. profile one decode batch and one train step: device time by kernel;
  7. config 2's serving path, ``ctc_bilstm_beam_lm``: build a 4-gram LM with
     the port's ``train_ngram`` (set-up); hold the prefix beam search kernels
     K7 and K8 against the plain search on the card at the path's shapes
     (planted and model log-probs, with and without the LM) and time them;
     drive ``decode.main`` with ``decode.lm_path`` at full width, once over
     all chars (K7) and once with ``decode.ext_top_a=8`` (K8), counting
     launches; profile one of its batches;
  8. config 2 with the char RNN LM: train the LM at its default widths
     (E 128, H 256, 2 layers) with the port's ``train_lm`` on the card
     (set-up); hold K9, the search fused with the LM, against the plain
     search on the card over all chars and the top 8 (config 2's model
     logits for 16 utterances of 10-16 s with each row's transcript
     planted, one row of no frames) and time it; drive ``decode.main`` with
     ``decode.lm_path=<lm.npz>`` at full width, once over all chars and once
     with ``decode.ext_top_a=8``, counting launches; beam-decode the
     learned tiny model with the RNN LM; profile one of its batches;
  9. config 3, ``tcn_ctc_devclean``: hold the TCN block kernels, K5 and the
     K6 forward and backward (3xTF32 on the tensor cores; two calls
     bit-equal), against their plain versions at B 16, T' 400 and a ragged
     397, C 384, K 5, every dilation of the cycle, and K5 on bf16 input, and
     time them beside a composite of torch calls (the backward with its
     3xTF32 and fp32 bounds); run the
     model and one train step at float32 on the CPU and on the card; drive
     ``decode.main`` (prefix beam K 16, no LM, its 14-bucket decode ladder)
     and ``train.main`` (batch 16, one bucket) at full width in bf16 with
     launch counts; profile one decode batch and one train step;
  10. config 2's beam decode across ranks: hold K10, the beam-sharded
     search's per-frame merge and top-K, against the plain merge on the card
     bit for bit (candidates of 2 and 4 beam shards at config 2's shapes,
     with and without the 4-gram, early and late frames) and time it; K9
     past a block's shared memory (an LM of H 512 x 2 layers, and beam 32);
     then ``decode.main ... decode.shard_beams=true`` in ranks spawned on
     the one card over gloo, each with its launch counters set to 0 just
     before and read just after: 2 ranks at model axis 2 and 4 ranks at
     data 2 x model 2 with the 4-gram (hypotheses equal to the one-rank
     decode's), 4 ranks at model axis 4 with the RNN LM; and the sharded
     search with the RNN LM in 4 ranks against the plain search;
  11. the last four kernels, none of which a model path runs: K11, both
     directions of a BiLSTM layer in one launch (its forward on the dual
     grid), at config 1's layer shape (inference, and training forward and
     backward) and config 2's (inference), bit-equal to two K2 (K3)
     launches and to the per-utterance oracle, its gradients within K3's
     tolerances, timed beside them, the oracle and cuDNN's bidirectional
     LSTM, with the dual grid's step split and a sweep of 32, 48 and 64 CTAs
     a direction, then driven through ``lstm_cuda.bilstm_seq`` with counts
     (no oracle launch, no plain version); the paired CTC
     alpha at K4's shape against its plain version and K4, then
     ``train.main`` with ``ops.ctc_cuda.PAIRED_FWD`` set, with counts; K13
     and K12, the search with its tokens in the block and the search as a
     launch a frame, bit for bit against the plain search at K7's shape and
     at the scripts' (K12's pointers and state too), timed beside K7; then
     the ported benchmark scripts
     ``bench_prefix_beam fused=1`` and ``bench_beam_compile stepwise=1`` at
     their default widths, with counts;
  12. check that no path launched the per-utterance oracle; print the
     kernels line, the card line, and ``{"ok": true, ...}`` last.
Whether it passes or fails, the script ends every process it started (the
ranks, multiprocessing's resource tracker, and anything they left) before it
exits.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from multiprocessing import resource_tracker

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_asr_tpu_torch import decode, train, train_lm, train_ngram
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import (
    BiLSTMEncoderConfig,
    DataConfig,
    DecodeConfig,
    FrontendConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from pytorch_asr_tpu_torch.data import BucketedDataset, build_dataset, get_tokenizer
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus
from pytorch_asr_tpu_torch.decoding import driver, prefix_beam, prefix_beam_sharded
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.evaluate import build_model, eval_step, model_outputs
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.models import encoder_bilstm
from pytorch_asr_tpu_torch.models.encoder_bilstm import conv_out_len, set_residual_dtype
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import (
    beam_cuda, build, ctc, ctc_cuda, lstm_cuda, stft_cuda, tcn_cuda)
from pytorch_asr_tpu_torch.parallel import distributed, launch
from pytorch_asr_tpu_torch.parallel.mesh import make_mesh
from pytorch_asr_tpu_torch.runtime import resolve_device, set_fp32_math
from pytorch_asr_tpu_torch.scripts import _timing, bench_beam_compile, bench_prefix_beam
from pytorch_asr_tpu_torch.training import state as train_state
from pytorch_asr_tpu_torch.training.trainer import Trainer

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12          # CUDA cores
PEAK_BF16_S = 989e12         # tensor cores
PEAK_TF32_S = 495e12         # tensor cores
B, AUDIO = 8, 256000         # 8 utterances of 16 s: the serving batch at its longest
T_LSTM, H = 400, 384         # conv output frames of 16 s; ctc_bilstm_dev1h width
# log-mel: the kernel's fp64 FFT against the plain version's fp32 cuFFT,
# whose own error near log_floor (a band's power a small remainder of large
# terms) is up to ~1e-3 in the log; against a float64 DFT the kernel is held
# to fp32 rounding of its power, mel sum and log (a few 1e-6).
STFT_TOL = 2e-3
STFT_EXACT_TOL = 2e-5
LSTM_TOL = 1e-2              # bf16 output: one bf16 step below 1 (2^-8) + fp32 order
SLICE_TOL = 1e-3             # float32 slice, card vs CPU: FFT, conv and dot orders
DECODE_BATCHES = 4
LAYERS = 3
LSTM_LENGTHS = [T_LSTM, 371, 352, 330, 310, 290, 260, 250]
# K3, relative to each tensor's largest entry.  float32 residuals and
# gradients: 400-step fp32 recurrences and sums over B*T rows taken in other
# orders.  bf16 outputs, residuals and dx / dwih: one bf16 step (2^-8
# relative) where the two sides' fp32 values straddle a rounding boundary.
K3_F32_TOL = 1e-3
K3_BF16_TOL = 1e-2
# K4: float32 log-space recursions, as the JAX package holds its Pallas CTC
# kernels to its scan; alphas are log values of up to ~T' log V.
CTC_RTOL, CTC_ALPHA_ATOL = 1e-5, 1e-4
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-4, 1e-5
V = 31                       # char vocabulary
# One float32 train step at full width, card vs CPU: the slice's FFT, conv
# and dot orders again, through the backward.  Gradients are held relative
# to each tensor's largest entry; after one AdamW step a coordinate moves by
# about lr * sign(g), and where |g| is at float32 noise the two devices may
# move it in opposite directions, so the parameters are held to 2 lr.
# The conv weights see the log-mel directly, and the card's K1 and the CPU's
# fp32 rfft differ by up to STFT_TOL in bands near log_floor: on the CPU a
# one-ulp change of the audio already moves the conv gradients by ~7e-4 of
# their largest entry (H 128, 3 layers), the LSTM ones by ~2e-6.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-4
STEP_CONV_GRAD_TOL = 5e-3
TRAIN_STEPS = 20             # the training main path: steps of full batches of 8
TRAIN_UTTS = 64              # 8 full batches an epoch, and 8 full eval batches
EVAL_BATCHES = 8             # train.main evaluates 8 batches after each chunk
LEARN_STEPS = (10, 290)      # the JAX package's end-to-end test: 300 steps
CARD = torch.device("cuda")
# Config 2's serving path: ctc_bilstm_beam_lm, BiLSTM H 512 x 4 layers,
# batch 16, beam 16, max_len 256, LM alpha 0.5 / beta 1.0; K8 with A = 8.
CFG2, CFG2_LAYERS, BEAM_B, BEAM_K, BEAM_L, BEAM_A = "ctc_bilstm_beam_lm", 4, 16, 16, 256, 8
# The kernel repeats the plain search's float32 operations in their order
# (no FMA on the fusion line): tokens and lengths equal, scores to rounding.
BEAM_RTOL = 1e-5
# Config 2 with the char LSTM LM at RNNLMConfig's default widths (E 128,
# H 256, 2 layers), trained by train_lm on the synthetic texts: 300 steps
# (the CLI's default is 500) keep the run short.
LM_STEPS = 300
# K9's LM products are fp32 sums in another order than torch.matmul's, so
# its scores drift from the plain search's by a few ulps a frame: tokens and
# lengths exact on planted-path logits, scores held as the JAX package holds
# its own K9 on hardware (tests/test_tpu_parity.py).
RNN_RTOL, RNN_ATOL = 2e-3, 1e-3
# Config 3's paths: tcn_ctc_devclean, TCN C 384 x 10 blocks, K 5, dilations
# 1-16, batch 16, prefix beam K 16 without an LM.
CFG3, TCN_B, TCN_T, TCN_RAGGED_T, TCN_C, TCN_K = "tcn_ctc_devclean", 16, 400, 397, 384, 5
TCN_BLOCKS, TCN_DILATIONS = 10, (1, 2, 4, 8, 16)
# K5 and K6 against their plain versions, relative to each tensor's largest
# entry: fp32 FMA sums in k order against cuBLAS's blocked sums (a few 1e-6
# at these shapes), held to the JAX package's 2e-4 for its own kernel.  K5's
# bf16 output: one bf16 step (2^-8) where the fp32 sums straddle a rounding
# boundary.
TCN_TOL = 2e-4
TCN_BF16_TOL = 1e-2
TCN_TRAIN_UTTS = 64          # 4 full batches of 16 an epoch, and 4 eval batches
# The paired CTC alpha against K4: the JAX study's tolerances for its paired
# kernel (tests/test_ctc_pallas.py), the composed step summing in another
# order; its main path, train.main with PAIRED_FWD set: a few full steps.
PAIRED_LOSS_TOL, PAIRED_GRAD_TOL = 1e-4, 2e-3
PAIRED_STEPS, PAIRED_UTTS = 4, 32
# Config 2 across ranks: 2 decode batches a run (each rank decodes its rows
# of both); K10 is checked at frames 0 and 1 (most beams dead) and 150.
SHARD_BATCHES, MERGE_FRAMES = 2, (0, 1, 150)
RANK_TIMEOUT = 300.0         # a spawned decode: ~8 s to the card, then its work
# K9 past shared memory: an LM of H 512 x 2 layers (random weights from a
# seed) at beam 16, and the trained default LM at beam 32.
WIDE_LM, WIDE_BEAM = RNNLMConfig(embed_dim=128, hidden_dim=512, num_layers=2), 32


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans (Linux
    ``PR_SET_CHILD_SUBREAPER``), so that ``stop_descendants`` finds every
    process the run started, even one whose parent has ended."""
    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0, f"prctl(PR_SET_CHILD_SUBREAPER): {ctypes.get_errno()}")


def descendants() -> dict[int, str]:
    """{pid: command line} of every live process below this one."""
    children, cmd = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd[int(entry)] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            out[pid] = cmd.get(pid, "?")
            todo.append(pid)
    return out


def stop_descendants() -> None:
    """End every process the run started, so that the script ends alone.

    The spawned ranks share multiprocessing's resource tracker, a child of
    this process that outlives them; it is closed through its own call, so
    that it releases what it tracks.  Anything else still running here (a
    rank that outlived its job, or a process one left behind) is named on
    stderr and sent SIGTERM, then SIGKILL; ended children are reaped."""
    tracker = resource_tracker._resource_tracker
    for sig in (signal.SIGTERM, signal.SIGKILL):
        stray = {p: c for p, c in descendants().items() if p != tracker._pid}
        if not stray:
            break
        print(f"chip_smoke: {sig.name} to processes still running: {stray}", file=sys.stderr)
        for pid in stray:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 5.0
        while set(descendants()) - {tracker._pid} and time.monotonic() < deadline:
            time.sleep(0.05)
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0] > 0:
                    pass
    with contextlib.suppress(ChildProcessError):  # it may have been reaped above
        tracker._stop()
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0] > 0:
            pass


def time_ms(fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back calls
    of ``fn`` between two CUDA events, over ``inner``: the calls queue up, so
    the host's launch cost hides behind the device's work (L2 stays warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """Least time in ms: the larger of bytes over memory rate and operation time."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def exact_log_mel(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The log-mel function in float64: direct DFT of the windowed frames."""
    n_freq = cfg.n_fft // 2 + 1
    T = features.max_frames(audio.shape[1], cfg)
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)[:, :T]
    n = torch.arange(cfg.win_length, dtype=torch.float64, device=audio.device)
    k = torch.arange(n_freq, dtype=torch.float64, device=audio.device)
    ang = 2 * torch.pi * torch.remainder(n[:, None] * k[None, :], cfg.n_fft) / cfg.n_fft
    win = torch.from_numpy(features.hann_window(cfg.win_length)).double().to(audio.device)
    frames = frames * win
    power = (frames @ torch.cos(ang)).square() + (frames @ torch.sin(ang)).square()
    mel = torch.from_numpy(features.mel_filterbank(cfg)).double().to(audio.device)
    return torch.log(torch.clamp(power @ mel, min=cfg.log_floor)).float()


def stft_phase() -> dict:
    cfg = FrontendConfig()
    rng_audio = np.zeros((B, AUDIO), np.float32)
    for b, (a, _) in enumerate(synthetic_corpus(B, cfg.sample_rate, seed=1,
                                                min_sec=16.0, max_sec=17.0)):
        rng_audio[b, : min(len(a), AUDIO)] = a[:AUDIO]
    audio = torch.from_numpy(rng_audio).cuda()
    got = stft_cuda.stft_log_mel(audio, cfg)
    torch.cuda.synchronize()
    want = stft_cuda.stft_log_mel_plain(audio, cfg)
    err, rel = errors(got, want)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), "stft: bad output")
    check(err <= STFT_TOL, f"stft_log_mel disagrees with its plain version: {err}")
    exact = exact_log_mel(audio, cfg)
    exact_err, _ = errors(got, exact)
    check(exact_err <= STFT_EXACT_TOL, f"stft_log_mel vs a float64 DFT: {exact_err}")
    plain_exact_err, _ = errors(want, exact)

    # Yardstick: torch.stft with the 400-sample window padded to n_fft on the
    # right and the audio padded by n_fft - win, which frames exactly as
    # center=False over win samples; then the same mel product and log.
    n_freq = cfg.n_fft // 2 + 1
    window = torch.zeros(cfg.n_fft, device=audio.device)
    window[: cfg.win_length] = torch.hann_window(cfg.win_length, device=audio.device)
    mel = torch.from_numpy(features.mel_filterbank(cfg)).cuda()
    padded = torch.nn.functional.pad(audio, (0, cfg.n_fft - cfg.win_length))

    def library():
        spec = torch.stft(padded, cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                          center=False, return_complex=True)
        return torch.log(torch.clamp(spec.abs().square().transpose(1, 2) @ mel,
                                     min=cfg.log_floor))

    lib_err, _ = errors(library(), want)
    check(lib_err <= STFT_TOL, f"stft yardstick computes another function: {lib_err}")
    # What the function needs a frame: the window product, a real FFT of
    # n_fft points (2.5 n log2 n), the power, the mel product over the bank's
    # nonzeros (it is sparse: triangles), and the log.
    T = features.max_frames(AUDIO, cfg)
    nnz = int((mel != 0).sum())
    ops = B * T * (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_freq
                   + cfg.n_mels) + B * T * 2 * nnz
    nbytes = 4 * (B * AUDIO + B * T * cfg.n_mels + cfg.win_length + n_freq * cfg.n_mels)
    b_ms, b_by = bound(nbytes, ops / PEAK_FP32_S)
    return {"name": "stft_log_mel", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/stft_log_mel.cu",
            "replaces": "pytorch_asr_tpu/ops/stft_pallas.py:189",
            "shape": f"audio ({B}, {AUDIO}) f32 -> ({B}, {T}, {cfg.n_mels}) f32",
            "max_abs_err": err, "max_rel_err": rel, "tol": STFT_TOL,
            "max_abs_err_vs_fp64": exact_err, "tol_vs_fp64": STFT_EXACT_TOL,
            "plain_max_abs_err_vs_fp64": plain_exact_err,
            "ms": time_ms(lambda: stft_cuda.stft_log_mel(audio, cfg)),
            "plain_ms": time_ms(lambda: stft_cuda.stft_log_mel_plain(audio, cfg)),
            "library_ms": time_ms(library), "library": "torch.stft + mel matmul + log",
            "bound_ms": b_ms, "bound_by": b_by}


def grid_record(args: tuple, b: int, steps: int, residual_dtype=None, dual: bool = False) -> dict:
    """K2's (K3's forward, with ``residual_dtype``) grid for ``args``, or with
    ``dual`` K11's grid of both directions, the device time a step of its
    recurrence (lstm_grid_kernel alone, from the profiler), and where a step
    goes: CTA 0's median cycles from staging h, through the dot chains and
    the cell updates, to the grid barrier (the trace of ``forward_on_grid``
    or ``bilstm_on_grid``), in µs at the clock the trace saw."""
    H = args[2].shape[-2]
    launch = lstm_cuda.bilstm_on_grid if dual else lstm_cuda.forward_on_grid
    rec = {"grid": lstm_cuda.recurrence_grid(H, b, torch.cuda.get_device_properties(0)
                                             .multi_processor_count,
                                             directions=2 if dual else 1)._asdict(),
           "recurrence_ms": device_ms_per_call(
               lambda: launch(None, *args, residual_dtype=residual_dtype),
               "lstm_grid_kernel", 5)}
    rec["us_per_step"] = rec["recurrence_ms"] / steps * 1e3
    trace = torch.zeros((args[0].shape[1], 5), dtype=torch.int64, device=CARD)
    launch(None, *args, residual_dtype=residual_dtype, trace=trace)
    tr = trace[:steps].cpu().numpy().astype(np.float64)
    ghz = (tr[-1, 1] - tr[0, 1]) / (tr[-1, 0] - tr[0, 0])
    cycles = {"stage": tr[:-1, 2] - tr[:-1, 1], "chains": tr[:-1, 3] - tr[:-1, 2],
              "cells": tr[:-1, 4] - tr[:-1, 3], "barrier": tr[1:, 1] - tr[:-1, 4]}
    rec["step_us_median"] = {k: float(np.median(v)) / ghz / 1e3 for k, v in cycles.items()}
    rec["trace_clock_ghz"] = ghz
    return rec


def lstm_phase() -> dict:
    """K2 at config 1's layer shapes (B 8, H 384; D 768 and 640) and config
    2's (B 16, D 1024, H 512), both directions, against its plain version and
    timed beside cuDNN's LSTM; its grid and µs a step of the recurrence are
    printed; then the sweep of the grid's CTAs."""
    g = torch.Generator().manual_seed(2)
    cases = []
    cfg2_lengths = np.linspace(T_LSTM, 250, BEAM_B).astype(int).tolist()
    for tag, b, D, Hd, lengths in (("config 1", B, 2 * H, H, LSTM_LENGTHS),
                                   ("config 1", B, 640, H, LSTM_LENGTHS),
                                   ("config 2", BEAM_B, 1024, 512, cfg2_lengths)):
        G = 4 * Hd
        x = (torch.randn(b, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(Hd, G, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(G, generator=g) * 0.1).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        for reverse in (False, True):
            args = (x, wih, whh, bias, lens, reverse, torch.bfloat16)
            got = lstm_cuda.lstm_seq(*args)
            torch.cuda.synchronize()
            want = lstm_cuda.lstm_seq_plain(*args)
            err, rel = errors(got, want)
            check(bool(torch.isfinite(got.float()).all()), "lstm_seq: non-finite output")
            check(err <= LSTM_TOL, f"lstm_seq {tag} D={D} reverse={reverse} disagrees: {err}")
            case = {"layer": tag, "x": [b, T_LSTM, D], "H": Hd, "reverse": reverse,
                    "max_abs_err": err, "max_rel_err": rel,
                    "ms": time_ms(lambda: lstm_cuda.lstm_seq(*args)),
                    "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(*args), reps=5, inner=1,
                                        warmup=1)}
            # Yardstick: cuDNN's fp32 LSTM, same weights, every length = T.
            ref = cudnn_lstm(D, wih, whh, bias)
            xf = x.float()
            with torch.no_grad():
                case["library_ms"] = time_ms(lambda: ref(xf))
            if not reverse:
                case.update(grid_record(args, b, max(lengths)))
                print(f"lstm_seq grid, {tag} D {D}: {json.dumps(case['grid'])}, "
                      f"recurrence {case['recurrence_ms']:.4f} ms, "
                      f"{case['us_per_step']:.3f} us a step of {max(lengths)} "
                      f"{json.dumps(case['step_us_median'])}, "
                      f"call {case['ms']:.4f} ms, cuDNN {case['library_ms']:.4f} ms")
            valid = int(sum(lengths))
            ops_bf16 = 2 * D * G * valid
            ops_f32 = 2 * Hd * G * valid
            nbytes = (2 * b * T_LSTM * D + 2 * D * G + 4 * Hd * G + 4 * G
                      + 4 * b + 2 * b * T_LSTM * Hd)
            case["bound_ms"], case["bound_by"] = bound(
                nbytes, ops_bf16 / PEAK_BF16_S + ops_f32 / PEAK_FP32_S)
            cases.append(case)
    sweep = lstm_grid_sweep()
    print("lstm_grid_sweep:", json.dumps(sweep))
    head = cases[0]
    return {"name": "lstm_seq", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:280",
            "shape": f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}; "
                     f"also D 640, and x ({BEAM_B}, {T_LSTM}, 1024), H 512",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases), "tol": LSTM_TOL,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
            "library": "torch.nn.LSTM (cuDNN, fp32, all lengths = T)",
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "cases": cases,
            "grid_sweep": sweep}


def lstm_grid_sweep() -> dict:
    """K2 at config 1's (B 8, D 768, H 384) and config 2's (B 16, D 1024,
    H 512) shapes on grids of fewer CTAs than the rule's (more units a CTA:
    shorter barriers, more chains a CTA), each held to the rule's output bit
    for bit and timed: {layer: {CTAs: ms}}, the rule's grid marked."""
    g = torch.Generator().manual_seed(9)
    out = {}
    for tag, b, D, Hd in (("config 1", B, 2 * H, H), ("config 2", BEAM_B, 1024, 512)):
        x = (torch.randn(b, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, 4 * Hd, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(Hd, 4 * Hd, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(4 * Hd, generator=g) * 0.1).cuda()
        lens = torch.full((b,), T_LSTM, dtype=torch.int32).cuda()
        args = (x, wih, whh, bias, lens, False, torch.bfloat16)
        rule = lstm_cuda.recurrence_grid(Hd, b)
        want = lstm_cuda.lstm_seq(*args)
        times = {}
        for units in (rule.units, rule.units + 1, 2 * rule.units, 4 * rule.units):
            grid = lstm_cuda.recurrence_grid(Hd, b, units=units)
            check(torch.equal(lstm_cuda.forward_on_grid(grid, *args), want),
                  f"lstm_seq on {grid}: differs from the rule's grid")
            times[grid.ctas] = time_ms(lambda: lstm_cuda.forward_on_grid(grid, *args), 5, 4, 1)
        out[tag] = {"rule_ctas": rule.ctas, "ms_by_ctas": times,
                    "fastest_ctas": min(times, key=times.get)}
    return out


def dual_grid_sweep(args: tuple, b: int, want: torch.Tensor) -> dict:
    """K11's forward on dual grids of 32, 48 and 64 CTAs a direction (the
    rule's is 64 at H 384 and 512), each held to ``want`` bit for bit and
    timed: {"ms_by_ctas": {CTAs a direction: ms}, "fastest_ctas": ...}."""
    H = args[2].shape[-2]
    times = {}
    for ctas in (32, 48, 64):
        grid = lstm_cuda.recurrence_grid(H, b, units=-(-H // ctas), directions=2)
        check(torch.equal(lstm_cuda.bilstm_on_grid(grid, *args), want),
              f"bilstm_seq on {grid}: differs from the rule's grid")
        times[grid.ctas] = time_ms(lambda: lstm_cuda.bilstm_on_grid(grid, *args), 5, 4, 1)
    return {"ms_by_ctas": times, "fastest_ctas": min(times, key=times.get)}


def cudnn_lstm(D: int, wih, whh, bias) -> torch.nn.LSTM:
    """cuDNN's fp32 LSTM with the same weights (the library yardstick); with
    weights stacked (2, ...) as [forward, reverse], the bidirectional one."""
    dual = wih.dim() == 3
    ref = torch.nn.LSTM(D, whh.shape[-2], batch_first=True, bidirectional=dual).cuda()
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse") if dual else ("",)):
            w_ih, w_hh, b = (wih[d], whh[d], bias[d]) if dual else (wih, whh, bias)
            getattr(ref, f"weight_ih_l0{sfx}").copy_(w_ih.float().T)
            getattr(ref, f"weight_hh_l0{sfx}").copy_(w_hh.T)
            getattr(ref, f"bias_ih_l0{sfx}").copy_(b)
            getattr(ref, f"bias_hh_l0{sfx}").zero_()
    return ref


def lstm_train_phase() -> list[dict]:
    """K3 at the training path's shapes: the training forward's output and
    residuals, then the backward over those residuals for a fixed upstream
    gradient, each against its plain version; with float32 residuals and with
    bf16 residuals as on the path (the bf16 cases are also timed)."""
    g = torch.Generator().manual_seed(3)
    lengths = torch.tensor(LSTM_LENGTHS, dtype=torch.int32)
    valid = int(lengths.sum())
    G = 4 * H
    cases = []
    for D in (2 * H, 640):
        x = (torch.randn(B, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(H, G, generator=g) / H ** 0.5).cuda()
        bias = (torch.randn(G, generator=g) * 0.1).cuda()
        gy = torch.randn(B, T_LSTM, H, generator=g).cuda()
        lens = lengths.cuda()
        for reverse in (False, True):
            for res in (torch.float32, torch.bfloat16):
                args = (x, wih, whh, bias, lens, reverse, torch.bfloat16, res)
                got = lstm_cuda.lstm_seq_train_fwd(*args)
                torch.cuda.synchronize()
                want = lstm_cuda.lstm_seq_train_plain(*args)
                case = {"D": D, "reverse": reverse, "residuals": str(res).split(".")[1]}
                bargs = (gy, x, wih, whh, lens, got[1], got[2], reverse)
                dgot = lstm_cuda.lstm_seq_bwd(*bargs)
                torch.cuda.synchronize()
                dwant = lstm_cuda.lstm_seq_bwd_plain(*bargs)
                for name, a, b in zip(("out", "acts", "ct", "dx", "dwih", "dwhh", "db"),
                                      (*got, *dgot), (*want, *dwant)):
                    check(a.dtype == b.dtype and bool(torch.isfinite(a.float()).all()),
                          f"K3 {name}: non-finite or of type {a.dtype}, not {b.dtype}")
                    err, rel = errors(a, b)
                    tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
                    check(rel <= tol, f"K3 {name} D={D} reverse={reverse} {res}: "
                                      f"{rel} > {tol} of its largest entry")
                    case[name] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
                if res == torch.bfloat16:
                    ref = cudnn_lstm(D, wih, whh, bias)
                    xf = x.float().requires_grad_(True)
                    ref_out, _ = ref(xf)
                    ref_in = [xf, *ref.parameters()]
                    case.update(
                        fwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_train_fwd(*args), 5, 4, 1),
                        bwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_bwd(*bargs), 5, 4, 1),
                        plain_fwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_train_plain(*args),
                                             3, 1, 1),
                        plain_bwd_ms=time_ms(lambda: lstm_cuda.lstm_seq_bwd_plain(*bargs),
                                             3, 1, 1),
                        library_fwd_ms=time_ms(lambda: ref(xf), 5, 4, 1),
                        library_bwd_ms=time_ms(lambda: torch.autograd.grad(
                            ref_out, ref_in, gy, retain_graph=True), 5, 4, 1))
                    if not reverse:
                        rec = grid_record(args[:7], B, T_LSTM, res)
                        case.update({f"fwd_{k}": v for k, v in rec.items()})
                        print(f"lstm_seq_train_fwd grid, D {D}: {json.dumps(rec['grid'])}, "
                              f"recurrence {rec['recurrence_ms']:.4f} ms, "
                              f"{rec['us_per_step']:.3f} us a step of {T_LSTM} "
                              f"{json.dumps(rec['step_us_median'])}, call "
                              f"{case['fwd_ms']:.4f} ms, cuDNN {case['library_fwd_ms']:.4f} ms")
                    rb = 2
                    fwd_bytes = (2 * B * T_LSTM * D + 2 * D * G + 4 * H * G + 4 * G + 4 * B
                                 + 2 * B * T_LSTM * H + rb * T_LSTM * B * (G + H))
                    # The residuals hold the gates of every step, so the
                    # projection covers all B*T rows; the recurrent product
                    # runs at the valid steps and once more for the held state.
                    case["fwd_bound_ms"], case["fwd_bound_by"] = bound(
                        fwd_bytes, 2 * D * G * B * T_LSTM / PEAK_BF16_S
                        + 2 * H * G * (valid + B) / PEAK_FP32_S)
                    bwd_bytes = (4 * B * T_LSTM * H + 2 * B * T_LSTM * D + 2 * D * G + 4 * H * G
                                 + 4 * B + rb * T_LSTM * B * (G + H) + 2 * B * T_LSTM * D
                                 + 2 * D * G + 4 * H * G + 4 * G)
                    # dgates is 0 off the valid steps: the dh recurrence and
                    # the dx, dwih, dwhh, db products over the valid rows, in
                    # float32 as the JAX package computes them.
                    bwd_ops = valid * (2 * G * H + 2 * G * D + 2 * G * D + 2 * G * H + G)
                    case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
                        bwd_bytes, bwd_ops / PEAK_FP32_S)
                cases.append(case)
    head = next(c for c in cases if "fwd_ms" in c)
    shape = (f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}, "
             f"bf16 residuals")
    out = []
    for name, outs, stem, line, what in (
            ("lstm_seq_train_fwd", ("out", "acts", "ct"), "fwd", 395, "forward"),
            ("lstm_seq_bwd", ("dx", "dwih", "dwhh", "db"), "bwd", 403,
             "backward (autograd.grad, graph kept)")):
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
            "replaces": f"pytorch_asr_tpu/ops/lstm_pallas.py:{line}", "shape": shape,
            "max_abs_err": max(c[o]["max_abs_err"] for c in cases for o in outs),
            "max_rel_err": max(c[o]["max_rel_err"] for c in cases for o in outs),
            "tol": {"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
            "ms": head[f"{stem}_ms"], "plain_ms": head[f"plain_{stem}_ms"],
            "library_ms": head[f"library_{stem}_ms"],
            "library": f"torch.nn.LSTM (cuDNN, fp32, all lengths = T) {what}",
            "bound_ms": head[f"{stem}_bound_ms"], "bound_by": head[f"{stem}_bound_by"],
            "cases": [{k: v for k, v in c.items() if k in ("D", "reverse", "residuals")
                       or k.startswith(stem) or k.startswith(f"plain_{stem}")
                       or k.startswith(f"library_{stem}") or k in outs} for c in cases]})
    return out


def ctc_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
              atol: float, kernel: str = "K4") -> float:
    """Check ``got`` against ``want``; returns the largest absolute error over
    the entries above the NEG_INF sentinel."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{kernel} {name}: {m}")
    live = want > ctc.NEG_INF / 2
    return float((got - want).detach().abs()[live].max()) if bool(live.any()) else 0.0


def ctc_case():
    """K4's inputs at the training path's shapes: labels of a batch of 10-16
    s synthetic utterances over T' = 400 frames, with one row of
    ``logit_len == 0`` and one infeasible row: (logits, labels, logit_len,
    label_len, T), on the card."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": str(B),
                                            "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    enc = cfg.model.encoder
    logit_len = features.num_frames(torch.from_numpy(batch["audio_len"]), cfg.frontend)
    for _ in enc.conv_channels:
        logit_len = conv_out_len(logit_len, enc.conv_kernel[0], enc.conv_stride[0])
    label_len = torch.from_numpy(batch["token_len"]).to(torch.int32)
    logit_len = logit_len.to(torch.int32)
    logit_len[B - 2] = 0                                     # a row with no frames
    logit_len[B - 1] = label_len[B - 1] // 2                 # infeasible
    T = int(logit_len.max())
    g = torch.Generator().manual_seed(4)
    logits = (torch.randn(B, T, V, generator=g) * 2).cuda()
    labels = torch.from_numpy(batch["tokens"]).cuda()
    return logits, labels, logit_len.cuda(), label_len.cuda(), T


def ctc_phase() -> list[dict]:
    """K4 at the training path's shapes (``ctc_case``)."""
    logits, labels, logit_len, label_len, T = ctc_case()
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    S = logp_tbs.shape[2]
    alphas, final = ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, logit_len)
    alpha_err = max(ctc_close("alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL),
                    ctc_close("final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL))
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (logit_len > 0)
    check(feasible.tolist() == [True] * (B - 2) + [False, False],
          f"K4: feasible rows {feasible.tolist()}")
    bargs = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, S), torch.where(feasible, logit_len, 0).to(torch.int32),
             torch.where(feasible, logz, 0.0))
    w = ctc_cuda.ctc_beta(*bargs)
    torch.cuda.synchronize()
    beta_err = ctc_close("posteriors", w, ctc.posteriors_plain(*bargs), CTC_GRAD_RTOL,
                         CTC_GRAD_ATOL)

    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    loss, ref = ctc_cuda.ctc_loss(a, logit_len, labels, label_len), ctc.ctc_loss(
        b, logit_len, labels, label_len)
    loss.sum().backward()
    ref.sum().backward()
    loss_err = ctc_close("loss", loss, ref, CTC_RTOL, CTC_RTOL)
    grad_err = ctc_close("gradient", a.grad, b.grad, CTC_GRAD_RTOL, CTC_GRAD_ATOL)
    check(not loss[B - 2:].any() and not a.grad[B - 2:].any(),
          "K4: empty and infeasible rows must give loss 0 and gradient 0")

    # Yardstick: torch's CTC with zero_infinity, forward; its backward with
    # the graph kept (log-probabilities in, as F.ctc_loss takes them).
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_(True)
    lib = lambda: F.ctc_loss(lp, labels.long(), logit_len.long(), label_len.long(),  # noqa: E731
                             reduction="none", zero_infinity=True)
    lib_loss = lib()
    frames = int(logit_len.sum())
    # log-sum-exp of three terms: 3 exp, 1 log and ~8 adds and maxima a state
    # and frame (the beta adds the posterior's add, subtract and exp).
    alpha_bytes = 4 * T * B * S + B * S + 4 * B + 4 * T * B * S + 4 * B * S
    beta_bytes = 2 * 4 * T * B * S + B * S + 4 * B * S + 8 * B + 4 * T * B * S
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/ctc_alpha_beta.cu",
              "shape": f"logp_tbs ({T}, {B}, {S}) f32, V {V}, "
                       f"label_len {label_len.tolist()}, logit_len {logit_len.tolist()}",
              "loss_max_abs_err": loss_err, "grad_max_abs_err": grad_err}
    alpha = {"name": "ctc_alpha", **common, "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:279",
             "max_abs_err": alpha_err, "tol": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL},
             "ms": time_ms(lambda: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)),
             "plain_ms": time_ms(lambda: ctc.alphas_plain(logp_tbs, skip, logit_len), 3, 1, 1),
             "library_ms": time_ms(lib), "library": "F.ctc_loss forward (zero_infinity)"}
    alpha["bound_ms"], alpha["bound_by"] = bound(alpha_bytes, 12 * S * frames / PEAK_FP32_S)
    beta = {"name": "ctc_beta", **common, "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:312",
            "max_abs_err": beta_err, "tol": {"rtol": CTC_GRAD_RTOL, "atol": CTC_GRAD_ATOL},
            "ms": time_ms(lambda: ctc_cuda.ctc_beta(*bargs)),
            "plain_ms": time_ms(lambda: ctc.posteriors_plain(*bargs), 3, 1, 1),
            "library_ms": time_ms(lambda: torch.autograd.grad(lib_loss.sum(), lp,
                                                              retain_graph=True)),
            "library": "F.ctc_loss backward (autograd.grad, graph kept)"}
    beta["bound_ms"], beta["bound_by"] = bound(beta_bytes, 15 * S * frames / PEAK_FP32_S)
    return [alpha, beta]


def bilstm_phase() -> tuple[list[dict], dict]:
    """K11, both directions of a BiLSTM layer in one launch, at config 1's
    layer shape (x (8, 400, 768) bf16, H 384, lengths 400 down to 250) and
    config 2's (x (16, 400, 1024) bf16, H 512), forward; at config 1's also
    the training forward and backward with bf16 and float32 residuals.  The
    forwards (and the residuals) run on the dual grid and must equal two K2
    (K3) launches and the per-utterance oracle bit for bit, the gradients
    K3's pair within K3's tolerances (bit-equality is reported); everything
    is also held to the plain versions.  Timed beside two K2 (K3) launches
    back to back, the oracle and cuDNN's bidirectional LSTM; the dual
    grid's µs a step and its split (``grid_record``), and a sweep of 32, 48
    and 64 CTAs a direction.  Then the op's own path:
    ``lstm_cuda.bilstm_seq`` without gradients and under autograd, with the
    counters set to 0 before and read after: no oracle launch, no plain
    version."""
    g = torch.Generator().manual_seed(5)
    out, cases, path_launches = [], [], None
    shapes = (("config 1", B, T_LSTM, 2 * H, H, LSTM_LENGTHS),
              ("config 2", BEAM_B, T_LSTM, 1024, 512,
               np.linspace(T_LSTM, 250, BEAM_B).astype(int).tolist()))
    for tag, b, T, D, Hd, lengths in shapes:
        G = 4 * Hd
        x = (torch.randn(b, T, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(2, D, G, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(2, Hd, G, generator=g) / Hd ** 0.5).cuda()
        bias = (torch.randn(2, G, generator=g) * 0.1).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32).cuda()
        args = (x, wih, whh, bias, lens, torch.bfloat16)
        got = lstm_cuda.bilstm_seq_infer(*args)
        torch.cuda.synchronize()
        pair = [(x, wih[d], whh[d], bias[d], lens, bool(d), torch.bfloat16) for d in (0, 1)]
        two_k2 = torch.cat([lstm_cuda.lstm_seq_infer(*p) for p in pair], dim=-1)
        check(torch.equal(got, two_k2), f"K11 {tag}: forward differs from two K2 launches")
        check(torch.equal(got, lstm_cuda._bilstm_seq_per_utterance(*args)),
              f"K11 {tag}: forward differs from the per-utterance oracle")
        err, rel = errors(got, lstm_cuda.bilstm_seq_plain(*args))
        check(err <= LSTM_TOL, f"K11 {tag}: forward disagrees with its plain version: {err}")
        valid = int(sum(lengths))
        nbytes = (2 * b * T * D + 2 * (2 * D * G + 4 * Hd * G + 4 * G) + 4 * b
                  + 2 * b * T * 2 * Hd)
        ops_s = 2 * (2 * D * G * valid / PEAK_BF16_S + 2 * Hd * G * valid / PEAK_FP32_S)
        case = {"layer": tag, "x": [b, T, D], "H": Hd, "bit_equal_two_k2": True,
                "bit_equal_oracle": True, "max_abs_err": err, "max_rel_err": rel,
                "ms": time_ms(lambda: lstm_cuda.bilstm_seq_infer(*args), 5, 4, 1),
                "two_k2_ms": time_ms(lambda: [lstm_cuda.lstm_seq_infer(*p) for p in pair],
                                     5, 4, 1),
                "one_k2_ms": time_ms(lambda: lstm_cuda.lstm_seq_infer(*pair[0]), 5, 4, 1),
                "oracle_ms": time_ms(lambda: lstm_cuda._bilstm_seq_per_utterance(*args),
                                     5, 4, 1),
                "plain_ms": time_ms(lambda: lstm_cuda.bilstm_seq_plain(*args), 3, 1, 1)}
        ref = cudnn_lstm(D, wih, whh, bias)
        xf = x.float()
        with torch.no_grad():
            case["library_ms"] = time_ms(lambda: ref(xf), 5, 4, 1)
        case["bound_ms"], case["bound_by"] = bound(nbytes, ops_s)
        case.update(grid_record(args, b, max(lengths), dual=True))
        case["grid_sweep"] = dual_grid_sweep(args, b, got)
        print(f"bilstm_seq dual grid, {tag}: {json.dumps(case['grid'])}, "
              f"recurrence {case['recurrence_ms']:.4f} ms, {case['us_per_step']:.3f} us a "
              f"step of {max(lengths)} {json.dumps(case['step_us_median'])}, call "
              f"{case['ms']:.4f} ms, two K2 {case['two_k2_ms']:.4f} ms, oracle "
              f"{case['oracle_ms']:.4f} ms, cuDNN {case['library_ms']:.4f} ms, sweep "
              f"{json.dumps(case['grid_sweep'])}")
        cases.append(case)
        if tag != "config 1":
            continue
        train = {}
        gy = torch.randn(b, T, 2 * Hd, generator=g).cuda()
        for res in (torch.float32, torch.bfloat16):
            targs = (*args, res)
            fwd = lstm_cuda.bilstm_seq_train_fwd(*targs)
            torch.cuda.synchronize()
            k3 = [lstm_cuda.lstm_seq_train_fwd(*p, res) for p in pair]
            check(torch.equal(fwd[0], torch.cat([k3[0][0], k3[1][0]], -1))
                  and torch.equal(fwd[1], torch.stack([k3[0][1], k3[1][1]]))
                  and torch.equal(fwd[2], torch.stack([k3[0][2], k3[1][2]])),
                  f"K11 training forward ({res}): differs from two K3 launches")
            oracle = lstm_cuda._bilstm_seq_per_utterance(*targs)
            check(all(torch.equal(a, o) for a, o in zip(fwd, oracle)),
                  f"K11 training forward ({res}): differs from the per-utterance oracle")
            bargs = (gy, x, wih, whh, lens, fwd[1], fwd[2])
            grads = lstm_cuda.bilstm_seq_bwd(*bargs)
            torch.cuda.synchronize()
            k3b = [lstm_cuda.lstm_seq_bwd(gy[..., d * Hd:(d + 1) * Hd].contiguous(), x, wih[d],
                                          whh[d], lens, fwd[1][d], fwd[2][d], bool(d))
                   for d in (0, 1)]
            k3g = (k3b[0][0] + k3b[1][0], *(torch.stack([k3b[0][i], k3b[1][i]])
                                            for i in (1, 2, 3)))
            want = (*lstm_cuda.bilstm_seq_train_plain(*targs),
                    *lstm_cuda.bilstm_seq_bwd_plain(*bargs))
            rec = {"grads_bit_equal_k3": all(torch.equal(a, c) for a, c in zip(grads, k3g))}
            for name, a, w, c in zip(("out", "acts", "ct", "dx", "dwih", "dwhh", "db"),
                                     (*fwd, *grads), want, (None, None, None, *k3g)):
                tol = K3_BF16_TOL if a.dtype == torch.bfloat16 else K3_F32_TOL
                check(a.dtype == w.dtype and bool(torch.isfinite(a.float()).all()),
                      f"K11 {name} ({res}): non-finite or of type {a.dtype}")
                err, rel = errors(a, w)
                check(rel <= tol, f"K11 {name} ({res}): {rel} > {tol} of the plain version's")
                if c is not None:
                    k3_rel = errors(a, c)[1]
                    check(k3_rel <= tol, f"K11 {name} ({res}): {k3_rel} > {tol} of K3's pair")
                rec[name] = {"max_abs_err": err, "max_rel_err": rel, "tol": tol}
            train[str(res).split(".")[1]] = rec
        res = torch.bfloat16
        targs = (*args, res)
        fwd = lstm_cuda.bilstm_seq_train_fwd(*targs)
        bargs = (gy, x, wih, whh, lens, fwd[1], fwd[2])
        k3_fwd = [(*p, res) for p in pair]
        k3_bwd = [(gy[..., d * Hd:(d + 1) * Hd].contiguous(), x, wih[d], whh[d], lens,
                   fwd[1][d], fwd[2][d], bool(d)) for d in (0, 1)]
        xg = xf.clone().requires_grad_(True)
        ref_out, _ = ref(xg)
        ref_in = [xg, *ref.parameters()]
        rb = 2
        fwd_bytes = (2 * b * T * D + 2 * (2 * D * G + 4 * Hd * G + 4 * G) + 4 * b
                     + 2 * b * T * 2 * Hd + 2 * rb * T * b * (G + Hd))
        bwd_bytes = (4 * b * T * 2 * Hd + 2 * b * T * D + 2 * (2 * D * G + 4 * Hd * G) + 4 * b
                     + 2 * rb * T * b * (G + Hd) + 2 * b * T * D
                     + 2 * (2 * D * G + 4 * Hd * G + 4 * G))
        timed = {
            "fwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_fwd(*targs), 5, 4, 1),
            "fwd_two_k3_ms": time_ms(lambda: [lstm_cuda.lstm_seq_train_fwd(*p)
                                              for p in k3_fwd], 5, 4, 1),
            "fwd_oracle_ms": time_ms(lambda: lstm_cuda._bilstm_seq_per_utterance(*targs),
                                     5, 4, 1),
            "bwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_bwd(*bargs), 5, 4, 1),
            "bwd_two_k3_ms": time_ms(lambda: [lstm_cuda.lstm_seq_bwd(*p) for p in k3_bwd],
                                     5, 4, 1),
            "plain_fwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_train_plain(*targs), 3, 1, 1),
            "plain_bwd_ms": time_ms(lambda: lstm_cuda.bilstm_seq_bwd_plain(*bargs), 3, 1, 1),
            "library_fwd_ms": time_ms(lambda: ref(xg), 5, 4, 1),
            "library_bwd_ms": time_ms(lambda: torch.autograd.grad(
                ref_out, ref_in, gy, retain_graph=True), 5, 4, 1)}
        timed["fwd_bound_ms"], timed["fwd_bound_by"] = bound(
            fwd_bytes, 2 * (2 * D * G * b * T / PEAK_BF16_S + 2 * Hd * G * (valid + b)
                            / PEAK_FP32_S))
        timed["bwd_bound_ms"], timed["bwd_bound_by"] = bound(
            bwd_bytes, 2 * valid * (2 * G * Hd + 2 * G * D + 2 * G * D + 2 * G * Hd + G)
            / PEAK_FP32_S)
        timed["fwd_grid"] = grid_record(args, b, T, res, dual=True)
        print(f"bilstm_seq_train_fwd dual grid, {tag}: {json.dumps(timed['fwd_grid'])}")
        # The op's own path: without gradients, then under autograd.
        params = [t.clone().requires_grad_(True) for t in (x, wih, whh, bias)]
        plain = [(lstm_cuda, n) for n in ("bilstm_seq_plain", "bilstm_seq_train_plain",
                                          "bilstm_seq_bwd_plain")]
        torch.cuda.synchronize()
        build.reset_launches()
        with plain_calls_of(*plain) as plain_calls:
            with torch.no_grad():
                lstm_cuda.bilstm_seq(*args)
            y = lstm_cuda.bilstm_seq(*params, lens, torch.bfloat16)
            y.float().square().sum().backward()
            torch.cuda.synchronize()
        path_launches = {k: v for k, v in build.LAUNCHES.items() if v}
        check(path_launches == {"bilstm_seq": 1, "bilstm_seq_train_fwd": 1, "bilstm_seq_bwd": 1},
              f"bilstm_seq path launches {path_launches}")
        check(not plain_calls, f"a plain version ran on the bilstm_seq path: {plain_calls}")
        check(all(p.grad is not None and bool(torch.isfinite(p.grad.float()).all())
                  for p in params), "bilstm_seq path: non-finite gradients")
    head, shape = cases[0], (f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {LSTM_LENGTHS}; "
                             f"also x ({BEAM_B}, {T_LSTM}, 1024), H 512, forward")
    common = {"route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
              "shape": shape}
    out.append({"name": "bilstm_seq", **common,
                "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:703",
                "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": LSTM_TOL,
                "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
                "library": "torch.nn.LSTM(bidirectional=True) (cuDNN, fp32, all lengths = T)",
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "cases": cases})
    for name, outs, stem, line, what in (
            ("bilstm_seq_train_fwd", ("out", "acts", "ct"), "fwd", 722, "forward"),
            ("bilstm_seq_bwd", ("dx", "dwih", "dwhh", "db"), "bwd", 822,
             "backward (autograd.grad, graph kept)")):
        out.append({
            "name": name, **common, "replaces": f"pytorch_asr_tpu/ops/lstm_pallas.py:{line}",
            "max_abs_err": max(r[o]["max_abs_err"] for r in train.values() for o in outs),
            "tol": {"float32": K3_F32_TOL, "bfloat16": K3_BF16_TOL},
            "ms": timed[f"{stem}_ms"], "two_k3_ms": timed[f"{stem}_two_k3_ms"],
            **({"oracle_ms": timed["fwd_oracle_ms"], "grid": timed["fwd_grid"]}
               if stem == "fwd" else {}),
            "plain_ms": timed[f"plain_{stem}_ms"], "library_ms": timed[f"library_{stem}_ms"],
            "library": f"torch.nn.LSTM(bidirectional=True) (cuDNN, fp32) {what}",
            "bound_ms": timed[f"{stem}_bound_ms"], "bound_by": timed[f"{stem}_bound_by"],
            "residuals": {r: {o: v[o] for o in outs} | {"grads_bit_equal_k3":
                                                        v["grads_bit_equal_k3"]}
                          for r, v in train.items()}})
    return out, path_launches


def ctc_paired_phase() -> dict:
    """The paired alpha recursion at K4's shape (``ctc_case``: a row of no
    frames and an infeasible row), against its plain version and K4's
    alphas; the loss and gradient through it against K4's; timed beside
    K4's forward and ``F.ctc_loss``."""
    logits, labels, logit_len, label_len, T = ctc_case()
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    S = logp_tbs.shape[2]
    alphas, final = ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len)
    torch.cuda.synchronize()
    ref_alphas, ref_final = ctc.alphas_paired_plain(logp_tbs, skip, logit_len)
    err = max(ctc_close("alphas", alphas, ref_alphas, CTC_RTOL, CTC_ALPHA_ATOL, "paired"),
              ctc_close("final alpha", final, ref_final, CTC_RTOL, CTC_ALPHA_ATOL, "paired"))
    k4, _ = ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)
    live = k4 > ctc.NEG_INF / 2
    check(torch.equal(live, alphas > ctc.NEG_INF / 2), "paired: live states differ from K4's")
    k4_err = ctc_close("alphas vs K4", alphas[live], k4[live], CTC_RTOL, CTC_ALPHA_ATOL,
                       "paired")
    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    ref = ctc_cuda.ctc_loss(b, logit_len, labels, label_len)
    ref.sum().backward()
    ctc_cuda.PAIRED_FWD = True
    try:
        loss = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
        loss.sum().backward()
    finally:
        ctc_cuda.PAIRED_FWD = False
    loss_err = ctc_close("loss vs K4", loss, ref, PAIRED_LOSS_TOL, PAIRED_LOSS_TOL, "paired")
    grad_err = ctc_close("gradient vs K4", a.grad, b.grad, PAIRED_GRAD_TOL, PAIRED_GRAD_TOL,
                         "paired")
    lp = torch.log_softmax(logits, -1).transpose(0, 1).detach()
    frames = int(logit_len.sum())
    nbytes = 4 * T * B * S + B * S + 4 * B + 4 * T * B * S + 4 * B * S
    # A pair of frames a state: the single step (~12 operations), the five
    # emission weights (~20) and the 5-term log-sum-exp (~14).
    return {"name": "ctc_alpha_paired", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/ctc_alpha_beta.cu",
            "replaces": "pytorch_asr_tpu/ops/ctc_pallas.py:139",
            "shape": f"logp_tbs ({T}, {B}, {S}) f32, label_len {label_len.tolist()}, "
                     f"logit_len {logit_len.tolist()}",
            "max_abs_err": err, "max_abs_err_vs_k4": k4_err, "loss_max_abs_err_vs_k4": loss_err,
            "grad_max_abs_err_vs_k4": grad_err,
            "tol": {"rtol": CTC_RTOL, "atol": CTC_ALPHA_ATOL, "loss_vs_k4": PAIRED_LOSS_TOL,
                    "grad_vs_k4": PAIRED_GRAD_TOL},
            "ms": time_ms(lambda: ctc_cuda.ctc_alpha_paired(logp_tbs, skip, logit_len)),
            "k4_ms": time_ms(lambda: ctc_cuda.ctc_alpha(logp_tbs, skip, logit_len)),
            "plain_ms": time_ms(lambda: ctc.alphas_paired_plain(logp_tbs, skip, logit_len),
                                3, 1, 1),
            "library_ms": time_ms(lambda: F.ctc_loss(lp, labels.long(), logit_len.long(),
                                                     label_len.long(), reduction="none",
                                                     zero_infinity=True)),
            "library": "F.ctc_loss forward (zero_infinity)",
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 23 * S * frames / PEAK_FP32_S)))}


def train_paired_phase() -> dict:
    """The paired alpha's main path: ``train.main ctc_bilstm_dev1h`` at full
    width for a few steps with ``ops.ctc_cuda.PAIRED_FWD`` set in this
    process (restored after), as the JAX package's switch is set; every step
    launches the paired alpha and K4's beta, and no unpaired alpha."""
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={PAIRED_UTTS}", "data.auto_buckets=1",
                f"steps={PAIRED_STEPS}", f"train.eval_every={PAIRED_STEPS}",
                f"train.log_every={PAIRED_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        ctc_cuda.PAIRED_FWD = True
        try:
            build.reset_launches()
            t0 = time.perf_counter()
            result = train.main(argv)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
        finally:
            ctc_cuda.PAIRED_FWD = False
    last = result["train"]
    check(launches.get("ctc_alpha_paired") == PAIRED_STEPS
          and launches.get("ctc_beta") == PAIRED_STEPS and "ctc_alpha" not in launches,
          f"paired train launches {launches}")
    check(last.get("step") == PAIRED_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"paired train: bad record {last}")
    return {"record": last, "wall_s": wall, "launches": launches}


def study_beam_phase() -> list[dict]:
    """K13 (tokens carried) and K12 (a launch a frame), K 16, L 256, at two
    shapes: K7's row shape, config 2's random-weight model logits for 16
    utterances of 10-16 s, with each row's transcript planted and as they
    are, the last row cut to no frames; and the benchmark scripts' shape,
    their seed's (16, 1000, 32) logits, where the best beams fill L (the
    full-buffer path: appends dropped, dead fillers from full beams, the
    backtrace capped at L).  Tokens, lengths and scores bit for bit against
    the plain search, and K12's pointers of every frame and its last state
    against the plain frames.  Timed beside K7 on the model's logits; K12
    also by the profiler's device time of its frame kernel."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    B2, T, V2 = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B2, T, 1), 4.0, device=CARD))
    ragged = lens.clone().to(torch.int32)
    ragged[B2 - 1] = 0
    bench = bench_beam_compile.DEFAULTS
    _, bench_logits, bench_lens = _timing.random_logits(
        int(bench["batches"].split(",")[0]), int(bench["T"]), int(bench["V"]), CARD)
    kw = dict(beam_size=BEAM_K, max_len=BEAM_L)
    fns = {"prefix_beam_fused": beam_cuda.prefix_beam_fused,
           "prefix_beam_stepwise": beam_cuda.prefix_beam_lanes_stepwise}
    cases = {name: [] for name in fns}
    for which, lg, ln in (("planted", planted, ragged), ("model", logits, ragged),
                          ("bench_scripts", bench_logits, bench_lens)):
        want = prefix_beam.prefix_beam_search_plain(lg, ln, **kw)
        k7 = prefix_beam.prefix_beam_search(lg, ln, **kw)
        check(all(torch.equal(a, w) for a, w in zip(k7, want)), f"K7 {which}: differs")
        full = int((want[1] == BEAM_L).sum())
        check(which != "bench_scripts" or full > 0, "bench_scripts: no best beam fills L")
        scratch = {}
        for name, fn in fns.items():
            build.reset_launches()
            got = fn(lg, ln, **kw, **({"scratch": scratch} if name == "prefix_beam_stepwise"
                                      else {}))
            torch.cuda.synchronize()
            n = {k: v for k, v in build.LAUNCHES.items() if v}
            check(n == {name: 1 if name == "prefix_beam_fused" else lg.shape[1]},
                  f"{name}: launches {n}")
            for part, a, w in zip(("tokens", "lengths", "scores"), got, want):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"{name} {which}: {part} differ from the plain search")
            if which != "bench_scripts":
                check(got[1][B2 - 1] == 0 and got[2][B2 - 1] == 0, f"{name}: the empty row")
            cases[name].append({"logits": which, "shape": list(lg.shape),
                                "mean_len": got[1].float().mean().item(), "rows_full": full,
                                "bit_equal": True})
        steps = prefix_beam.prefix_beam_stepwise_plain(
            torch.log_softmax(lg.float(), -1), ln, BEAM_K, BEAM_L)
        for f, w in steps.items():
            g = scratch[f]
            if not torch.equal(g, w):
                bad = (g != w).reshape(g.shape[0], -1, BEAM_K).any(2).any(0).nonzero()
                check(False, f"K12 {which}: {f} differs from the plain frames"
                             + (f" from frame {int(bad[0])}" if f in ("parent", "append")
                                else " after the last frame"))
        cases["prefix_beam_stepwise"][-1]["pointers_and_state_bit_equal"] = True
    logp = torch.log_softmax(logits.float(), -1).contiguous()
    frames, C = int(ragged.sum()), V2 - 1
    lens32 = ragged.contiguous()
    search_ops = frames * (12 * BEAM_K * C + 3 * BEAM_K ** 2
                           + (BEAM_K + BEAM_K * C) * math.log2(BEAM_K))
    outputs = 4 * B2 * BEAM_L + 8 * B2
    k7_ms = time_ms(lambda: prefix_beam.prefix_beam_search(logits, ragged, **kw), 5, 4, 1)
    plain_ms = time_ms(lambda: prefix_beam.beam_scan_plain(logp, lens32, BEAM_K, BEAM_L),
                       3, 1, 1)
    out = []
    for name, line, nbytes, ops in (
            # K13 reads logp once; its K x L token copy a frame moves shared
            # memory and is no operation.
            ("prefix_beam_fused", 313, 4 * V2 * frames + outputs, search_ops),
            # K12 also reads and writes its 5 state fields a frame and writes
            # the (B, T, K) pointers.
            ("prefix_beam_stepwise", 905, 4 * V2 * frames + 40 * BEAM_K * frames
             + 8 * B2 * T * BEAM_K + outputs, search_ops)):
        fn = fns[name]
        ms = time_ms(lambda fn=fn: fn(logits, ragged, **kw), 5, 4, 1)
        entry = {"name": name, "route": "cuda",
                 "source": "pytorch_asr_tpu_torch/csrc/prefix_beam_study.cu",
                 "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
                 "shape": f"logp ({B2}, {T}, {V2}) f32, lengths {ragged.tolist()}, K {BEAM_K}, "
                          f"L {BEAM_L}, no LM",
                 "max_abs_err": 0.0, "tol": "tokens, lengths and scores bit-equal",
                 "ms": ms, "k7_ms": k7_ms, "plain_ms": plain_ms, "library_ms": None,
                 "library": "none: no PyTorch call computes a prefix beam search",
                 **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops / PEAK_FP32_S))),
                 "cases": cases[name]}
        if name == "prefix_beam_stepwise":
            entry["ms_per_frame"] = ms / T
            entry["frame_kernel_device_ms"] = device_ms_per_call(
                lambda: fn(logits, ragged, **kw), "beam_step_kernel", calls=3) / T
        out.append(entry)
    return out


def bench_scripts_phase() -> dict:
    """K13's and K12's main paths: the ported benchmark scripts in this
    process at their default widths (B 16, T 1000, K 16, V 32) with one
    timed call an arm, ``bench_prefix_beam fused=1 hashed=0`` and
    ``bench_beam_compile stepwise=1 batches=16``, each with the counters set
    to 0 just before and read just after: K13 once a call, K12 T a call.
    ``study_beam_phase`` holds both kernels to the plain search on the
    scripts' own logits."""
    out = {}
    for name, main, argv, kernel, per_frame in (
            ("bench_prefix_beam", bench_prefix_beam.main, ["fused=1", "iters=1", "hashed=0"],
             "prefix_beam_fused", False),
            ("bench_beam_compile", bench_beam_compile.main,
             ["stepwise=1", "batches=16", "iters=1"], "prefix_beam_stepwise", True)):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = main(argv)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        want = res["calls_per_arm"] * (res["T"] if per_frame else 1)
        check(launches.get(kernel) == want,
              f"{name}: {kernel} launched {launches.get(kernel)} times, not {want}")
        check(all(math.isfinite(a["ms"]) and a["ms"] > 0 for a in res["arms"].values()),
              f"{name}: bad timings {res['arms']}")
        out[name] = {**res, "argv": argv, "wall_s": wall, "launches": launches}
    return out


def slice_phase(config: str = "ctc_bilstm_dev1h") -> dict:
    """Full width, float32 compute, one short synthetic batch of 8: card vs CPU."""
    cfg = get_config(config, **{"model.compute_dtype": "float32", "data.synthetic_num_utts": "8",
                                "data.batch_size": "8", "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    outs = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", CARD)):
        model = build_model(cfg, device)
        with torch.inference_mode():
            out = model(torch.from_numpy(batch["audio"]).to(device),
                        torch.from_numpy(batch["audio_len"]).to(device))
        outs[name] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["card"]
    check(torch.equal(cpu["enc_len"], gpu["enc_len"]), "slice: enc_len differs")
    check(bool(torch.isfinite(gpu["ctc_logits"]).all()), "slice: non-finite logits")
    err, _ = errors(gpu["ctc_logits"], cpu["ctc_logits"])
    check(err <= SLICE_TOL, f"slice logits card vs CPU: {err}")
    top2 = cpu["ctc_logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_TOL
    same = gpu["ctc_logits"].argmax(-1)[clear] == cpu["ctc_logits"].argmax(-1)[clear]
    check(bool(same.all()), "slice: greedy tokens differ where the top-2 gap is clear")
    ids_c, n_c = greedy_ctc(cpu["ctc_logits"], cpu["enc_len"])
    ids_g, n_g = greedy_ctc(gpu["ctc_logits"], gpu["enc_len"])
    return {"logits_max_abs_err": err, "tol": SLICE_TOL,
            "clear_frames": float(clear.float().mean()),
            "tokens_equal": bool(torch.equal(ids_c, ids_g) and torch.equal(n_c, n_g)),
            "shape": list(gpu["ctc_logits"].shape)}


def train_step_phase(config: str = "ctc_bilstm_dev1h", front: str = "encoder.conv.") -> dict:
    """One float32 train step at full width, card vs CPU, from the same seeded
    weights and batch, dropout 0 and SpecAugment off.  Both save float32
    LSTM residuals: bf16 residuals would round differently on the two
    devices.  ``front`` names the convs that see the log-mel directly."""
    cfg = get_config(config, **{
        "model.compute_dtype": "float32", "model.encoder.dropout": "0.0",
        "frontend.specaugment": "false", "data.synthetic_num_utts": str(B),
        "data.batch_size": str(B), "data.auto_buckets": "1", "train.optim.peak_lr": "1e-3",
        "train.optim.warmup_steps": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    runs = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", CARD)):
        model = set_residual_dtype(train_state.build_model(cfg, dev), torch.float32)
        st = train_state.init_train_state(cfg, model)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        aux = train_state.train_step(cfg, st, train_state.batch_to_device(batch, dev))
        runs[name] = {"aux": aux, "before": before,
                      "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
                      "after": {k: v.cpu() for k, v in model.state_dict().items()}}
    cpu, gpu = runs["cpu"], runs["card"]
    loss_c, loss_g = float(cpu["aux"]["loss"]), float(gpu["aux"]["loss"])
    check(math.isfinite(loss_g) and abs(loss_g - loss_c) <= STEP_LOSS_RTOL * abs(loss_c),
          f"train step loss card {loss_g} vs CPU {loss_c}")
    lr = gpu["aux"]["lr"]
    check(lr == cpu["aux"]["lr"], "train step: lr differs")
    grad_rel = {}
    for k, gc in cpu["grads"].items():
        _, grad_rel[k] = errors(gpu["grads"][k], gc)
        tol = STEP_CONV_GRAD_TOL if k.startswith(front) else STEP_GRAD_TOL
        check(grad_rel[k] <= tol, f"train step gradient {k}: {grad_rel[k]} of its largest entry")
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])
    conv_rel = max(v for k, v in worst if k.startswith(front))
    rest_rel = max(v for k, v in worst if not k.startswith(front))
    param_err = max(errors(gpu["after"][k], v)[0] for k, v in cpu["after"].items())
    check(param_err <= 2 * lr, f"params after one AdamW step differ by {param_err} > 2 lr")
    moved = max(errors(v, cpu["before"][k])[0] for k, v in cpu["after"].items())
    return {"loss_cpu": loss_c, "loss_card": loss_g, "loss_rtol": STEP_LOSS_RTOL,
            "grad_norm_cpu": float(cpu["aux"]["grad_norm"]),
            "grad_norm_card": float(gpu["aux"]["grad_norm"]),
            "conv_grad_max_rel_err": conv_rel, "conv_grad_tol": STEP_CONV_GRAD_TOL,
            "grad_max_rel_err": rest_rel, "grad_tol": STEP_GRAD_TOL, "worst_grads": worst[:4],
            "param_max_abs_err": param_err, "param_tol": 2 * lr, "param_max_move": moved,
            "audio_len": batch["audio_len"].tolist()}


def train_main_phase() -> dict:
    """The training main path: ``train.main`` at full width in bf16, full
    batches of 8 utterances of 10-16 s, then one greedy eval of 8 batches."""
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={TRAIN_UTTS}", "data.auto_buckets=1",
                f"steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS}",
                f"train.log_every={TRAIN_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    last, ev = result["train"], result["eval"]
    want = {"stft_log_mel": TRAIN_STEPS + EVAL_BATCHES, "lstm_seq": 2 * LAYERS * EVAL_BATCHES,
            "lstm_seq_train_fwd": 2 * LAYERS * TRAIN_STEPS,
            "lstm_seq_bwd": 2 * LAYERS * TRAIN_STEPS,
            "ctc_alpha": TRAIN_STEPS, "ctc_beta": TRAIN_STEPS}
    check({k: v for k, v in launches.items() if v} == want,
          f"train launches {launches} != {want}")
    check(last.get("step") == TRAIN_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"train: bad record {last}")
    check(ev.get("num_utts") == EVAL_BATCHES * B, f"train eval: {ev}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()
                if k not in ("lstm_seq", "stft_log_mel")}
    per_step["stft_log_mel"] = (launches["stft_log_mel"] - EVAL_BATCHES) / TRAIN_STEPS
    return {"record": last, "eval": ev, "wall_s": wall,
            "step_s": 1.0 / last["steps_per_sec"], "launches": launches,
            "launches_per_step": per_step,
            "lstm_seq_per_eval_batch": launches["lstm_seq"] / EVAL_BATCHES}


def learn_phase(arpa: str, rnn_lm: str) -> dict:
    """The tiny config of the JAX package's end-to-end test, on the card: its
    loss must fall below half the first logged value and its greedy WER below
    0.3 after 300 steps.  Then ``Trainer.decode_eval`` decodes the learned
    model with config 2's prefix beam search, with the 4-gram LM and with the
    RNN LM: neither WER may exceed the greedy WER."""
    cfg = dataclasses.replace(
        get_config("ctc_bilstm_dev1h"),
        frontend=FrontendConfig(specaugment=False),
        data=DataConfig(batch_size=4, bucket_audio_lens=(40000,), bucket_label_lens=(48,),
                        synthetic_num_utts=24),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(conv_channels=(8, 8), hidden_dim=96,
                                                      num_layers=2, dropout=0.0),
                          compute_dtype="float32"),
        train=TrainConfig(optim=OptimConfig(peak_lr=3e-3, warmup_steps=30, total_steps=400,
                                            grad_clip_norm=5.0), log_every=50))
    corpus = synthetic_corpus(cfg.data.synthetic_num_utts, cfg.frontend.sample_rate, seed=0,
                              min_words=1, max_words=3)
    dataset = BucketedDataset(corpus, batch_size=cfg.data.batch_size,
                              bucket_audio_lens=cfg.data.bucket_audio_lens,
                              bucket_label_lens=cfg.data.bucket_label_lens)
    t0 = time.perf_counter()
    with Trainer(cfg, dataset=dataset, enable_checkpoints=False, device=CARD) as trainer:
        first = trainer.train(num_steps=LEARN_STEPS[0])
        rest = trainer.train(num_steps=LEARN_STEPS[1])
        result = trainer.evaluate()
        wall = time.perf_counter() - t0
        c2 = get_config(CFG2).decode
        trainer.cfg = dataclasses.replace(cfg, decode=DecodeConfig(
            method="prefix_beam", beam_size=c2.beam_size, lm_path=arpa,
            lm_alpha=c2.lm_alpha, lm_beta=c2.lm_beta))
        build.reset_launches()
        beam = trainer.decode_eval()
        beam_launches = build.LAUNCHES["prefix_beam"]
        trainer.cfg = dataclasses.replace(trainer.cfg, decode=dataclasses.replace(
            trainer.cfg.decode, lm_path=rnn_lm))
        build.reset_launches()
        rnn = trainer.decode_eval()
        rnn_launches = build.LAUNCHES["prefix_beam_rnn"]
    check(rest["ctc_loss"] < 0.5 * first["ctc_loss"],
          f"learn: ctc_loss {rest['ctc_loss']} not below half of {first['ctc_loss']}")
    check(result["wer"] < 0.3 and result["num_utts"] == 24, f"learn: {result}")
    check(beam["num_utts"] == 24 and beam_launches > 0 and beam["wer"] <= result["wer"],
          f"learn: beam + LM {beam} ({beam_launches} K7 launches) vs greedy {result}")
    check(rnn["num_utts"] == 24 and rnn_launches > 0 and rnn["wer"] <= result["wer"],
          f"learn: beam + RNN LM {rnn} ({rnn_launches} K9 launches) vs greedy {result}")
    return {"first_ctc_loss": first["ctc_loss"], "last_ctc_loss": rest["ctc_loss"],
            "wer": result["wer"], "cer": result["cer"], "steps": sum(LEARN_STEPS),
            "wall_s": wall, "beam_lm_wer": beam["wer"], "beam_lm_cer": beam["cer"],
            "beam_lm_k7_launches": beam_launches, "beam_rnn_lm_wer": rnn["wer"],
            "beam_rnn_lm_cer": rnn["cer"], "beam_rnn_lm_k9_launches": rnn_launches}


def build_lm() -> str:
    """Config 2's LM, made at run time by the port's ``train_ngram``: an
    order-4 Kneser-Ney char LM of ``synthetic_texts(512)``, into the build
    directory (gitignored)."""
    path = build.BUILD_DIR / "syn4.arpa"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    train_ngram.main([str(path), "num_synthetic=512", "order=4"])
    return str(path)


def build_rnn_lm() -> tuple[str, dict]:
    """Config 2's RNN LM, trained on the card at run time by the port's
    ``train_lm`` at its default widths on ``synthetic_texts(256)``, into the
    build directory (gitignored).  Returns its path and the CLI's record."""
    path = build.BUILD_DIR / "rnn_lm.npz"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    record = train_lm.main([str(path), f"steps={LM_STEPS}", "log_every=100"])
    torch.cuda.synchronize()
    record["wall_s"] = time.perf_counter() - t0
    # uniform over the 31 chars is log(31) ~ 3.43 nats
    check(math.isfinite(record["nll"]) and record["nll"] < 3.0, f"train_lm: {record}")
    return str(path), record


def cfg2_batch_logits(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Config 2's random-weight model on one full synthetic batch of 16
    utterances of 10-16 s: (ctc_logits (16, T', 31) f32, enc_len)."""
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    with torch.inference_mode():
        out = model_outputs(build_model(cfg, CARD), batch)
    return out["ctc_logits"], out["enc_len"]


def beam_phase(arpa: str) -> list[dict]:
    """K7 and K8 against the plain search, both on the card, at config 2's
    serving shapes: B 16, T' ~ 400, V 31, K 16, L 256, A 8; on planted-path
    logits (random plus a planted path, as tests/test_tpu_parity.py plants
    one) and on the random-weight model's logits, each with no LM and with
    the 4-gram table.  The kernels are timed on the model logits with the
    table, the serving path's case."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    rng = np.random.default_rng(19)
    planted = rng.standard_normal((B, T, V)).astype(np.float32)
    path = rng.integers(0, V, size=(B, T))
    for b in range(B):
        planted[b, np.arange(T), path[b]] += 4.0
    table = driver.load_lm(get_config(CFG2, **{"decode.lm_path": arpa}), CARD)
    dec = cfg.decode
    inputs = {"planted": (torch.from_numpy(planted).to(CARD), lens), "model": (logits, lens)}
    out = []
    for name, A, line in (("prefix_beam", 0, 756), ("prefix_beam_topa", BEAM_A, 1566)):
        cases = []
        for which, (lg, ln) in inputs.items():
            for lm in (None, table):
                kw = dict(beam_size=BEAM_K, max_len=BEAM_L, ext_top_a=A, lm_table=lm,
                          lm_alpha=dec.lm_alpha if lm is not None else 0.0,
                          lm_beta=dec.lm_beta if lm is not None else 0.0)
                build.reset_launches()
                got = prefix_beam.prefix_beam_search(lg, ln, **kw)
                torch.cuda.synchronize()
                check(build.LAUNCHES[name] == 1, f"{name}: {dict(build.LAUNCHES)}")
                want = prefix_beam.prefix_beam_search_plain(lg, ln, **kw)
                tag = f"{name} {which} {'4-gram' if lm is not None else 'no LM'}"
                check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
                      f"{tag}: tokens or lengths differ from the plain search")
                torch.testing.assert_close(got[2], want[2], rtol=BEAM_RTOL, atol=0,
                                           msg=lambda m, tag=tag: f"{tag} scores: {m}")
                cases.append({"logits": which, "lm": lm is not None,
                              "max_abs_err": (got[2] - want[2]).abs().max().item(),
                              "mean_len": got[1].float().mean().item()})
        logp, (tv, ti) = prefix_beam._prepare(logits, A)
        args = (logp, lens.to(torch.int32).contiguous(), BEAM_K, BEAM_L, table, dec.lm_alpha,
                dec.lm_beta, tv, ti)
        frames = int(lens.sum())
        C = A or V
        # Bytes: logp of the valid frames, the top-A values and ids (K8),
        # the table, the backpointers written, the lengths and outputs.
        nbytes = (4 * V * frames + 8 * A * frames + table.numel() * 4 + 8 * BEAM_K * frames
                  + 4 * B + 4 * B * BEAM_L + 8 * B)
        # Operations a valid frame: ~12 a candidate lane (log-sum-exp, the
        # extension and the fusion), 3 per (beam, beam) absorb test, and a
        # top-K over K + K*C candidates at log2(K) compares each.
        ops = frames * (12 * BEAM_K * C + 3 * BEAM_K ** 2
                        + (BEAM_K + BEAM_K * C) * math.log2(BEAM_K))
        b_ms, b_by = bound(nbytes, ops / PEAK_FP32_S)
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": f"pytorch_asr_tpu/ops/beam_pallas.py:{line}",
            "shape": f"logp ({B}, {T}, {V}) f32, lengths {lens.tolist()}, K {BEAM_K}, "
                     f"L {BEAM_L}, C {C}, table {tuple(table.shape)}",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": {"tokens": "equal", "scores_rtol": BEAM_RTOL},
            "ms": time_ms(lambda: beam_cuda.prefix_beam(*args)),
            "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(*args), 3, 1, 1),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            "bound_ms": b_ms, "bound_by": b_by, "cases": cases})
    return out


@contextlib.contextmanager
def lm_steps_counted():
    """Counts the LM steps the plain search's frames need: beams that append
    a char at a frame inside their row's length, the steps K9 computes."""
    count, fn = [0], prefix_beam._advance_lm

    def counted(rnn_lm, carry, parent, append, active):
        count[0] += int(((append >= 0) & active[:, None]).sum())
        return fn(rnn_lm, carry, parent, append, active)

    prefix_beam._advance_lm = counted
    try:
        yield count
    finally:
        prefix_beam._advance_lm = fn


def transcript_path(batch: dict, lens: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) int64 CTC path of each row's transcript: its n chars on the
    first frames of n equal spans of the row's frames, blanks elsewhere."""
    path = torch.zeros((len(lens), T), dtype=torch.long)
    for b, n_t in enumerate(lens.tolist()):
        ids = torch.from_numpy(batch["tokens"][b, : batch["token_len"][b]]).long()[:n_t]
        n = len(ids)
        if n:
            path[b, (torch.arange(n) * n_t + n - 1) // n] = ids
    return path


def rnn_beam_phase(rnn_lm_path: str) -> list[dict]:
    """K9 against the plain search, both on the card, at config 2's serving
    shapes (B 16, T' ~ 400, V 31, K 16, L 256) with the trained LM (E 128,
    H 256, 2 layers), over all chars and each frame's top 8: on the
    random-weight model's logits plus a planted path, the last row cut to no
    frames, tokens and lengths exact and scores within RNN_RTOL / RNN_ATOL;
    on the model's logits alone, the share of rows with equal tokens
    (information only).  Timed on the model's logits, the serving path's case.

    The planted path is each row's transcript (~200 chars, below L), not
    a random char a frame: a random path of ~380 chars fills the beams to L,
    and full beams only stay, so their candidates tie to the last ulps and
    the LM's rounding decides (on the card the kernel then agreed with a
    float64 plain search where the float32 one did not)."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm_path})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    rnn = driver.load_lm(cfg, CARD)
    lmc, dec, sos = rnn.cfg, cfg.decode, get_tokenizer(cfg.data.vocab).sos_id
    h0, c0, lmp0 = prefix_beam.primed_lm_state(rnn, sos)
    n_weights = sum(p.numel() for p in rnn.parameters())
    out = []
    for name, A in (("prefix_beam_rnn", 0), ("prefix_beam_rnn_topa", BEAM_A)):
        kw = dict(beam_size=BEAM_K, max_len=BEAM_L, ext_top_a=A, rnn_lm=rnn, sos_id=sos,
                  lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta)
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(planted, ragged, **kw)
        torch.cuda.synchronize()
        check({k: v for k, v in build.LAUNCHES.items() if v} == {name: 1},
              f"{name}: {dict(build.LAUNCHES)}")
        want = prefix_beam.prefix_beam_search_plain(planted, ragged, **kw)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"{name} planted: tokens or lengths differ from the plain search")
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m, name=name: f"{name} planted scores: {m}")
        check(got[1][B - 1] == 0 and got[2][B - 1] == 0, f"{name}: the empty row")
        model_got = prefix_beam.prefix_beam_search(logits, lens, **kw)
        with lm_steps_counted() as lm_steps:
            model_want = prefix_beam.prefix_beam_search_plain(logits, lens, **kw)
        same = (got_rows := (model_got[0] == model_want[0]).all(1)
                & (model_got[1] == model_want[1])).float().mean().item()
        logp, (tv, ti) = prefix_beam._prepare(logits, A)
        args = (logp, lens.to(torch.int32).contiguous(), BEAM_K, BEAM_L, rnn, h0, c0, lmp0,
                dec.lm_alpha, dec.lm_beta, tv, ti)
        frames, C = int(lens.sum()), A or V
        # Bytes: logp of the valid frames, the top-A values and ids, the
        # LM's weights and primed state once, the backpointers written, the
        # lengths and outputs.
        nbytes = (4 * V * frames + 8 * A * frames + 4 * (n_weights + 2 * lmc.num_layers
                                                         * lmc.hidden_dim + V)
                  + 8 * BEAM_K * frames + 4 * B + 4 * B * BEAM_L + 8 * B)
        # Operations: the search's, as for K7 and K8, plus each LM step the
        # data needs: the gate products 2 * 4H * (in + H) a layer, ~10 a
        # gate unit for the cell, the output product 2 H V and ~5 V for the
        # log-softmax.
        Hd, G4 = lmc.hidden_dim, 4 * lmc.hidden_dim
        step_ops = (sum(2 * G4 * ((lmc.embed_dim if l == 0 else Hd) + Hd)
                        for l in range(lmc.num_layers))
                    + 10 * G4 * lmc.num_layers + 2 * Hd * V + 5 * V)
        ops = (frames * (12 * BEAM_K * C + 3 * BEAM_K ** 2
                         + (BEAM_K + BEAM_K * C) * math.log2(BEAM_K)) + lm_steps[0] * step_ops)
        b_ms, b_by = bound(nbytes, ops / PEAK_FP32_S)
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1452",
            "shape": f"logp ({B}, {T}, {V}) f32, lengths {lens.tolist()}, K {BEAM_K}, "
                     f"L {BEAM_L}, C {C}, LM E {lmc.embed_dim} H {Hd} x {lmc.num_layers}",
            "max_abs_err": (got[2] - want[2]).abs().max().item(),
            "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
            "model_logits_rows_equal": same,
            "model_logits_max_abs_err": (model_got[2] - model_want[2])[got_rows].abs().max()
            .item() if bool(got_rows.any()) else None,
            "lm_steps": lm_steps[0], "lm_steps_per_frame": lm_steps[0] / frames,
            "ms": time_ms(lambda: beam_cuda.prefix_beam_rnn(*args), 5, 2, 1),
            "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
                *args[:4], None, *args[8:], rnn_lm=rnn, lm_state=(h0, c0, lmp0)), 3, 1, 1),
            "library_ms": None, "library": "none: no PyTorch call computes a prefix beam search",
            "bound_ms": b_ms, "bound_by": b_by})
    return out


@contextlib.contextmanager
def plain_calls_of(*targets):
    """Wrap each (module, name) plain version so that its calls record the
    device of their first argument; yields that list, and restores them."""
    calls, saved = [], [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(fn):
        def run(x, *args, **kwargs):
            calls.append((x["pb"] if isinstance(x, dict) else x).device.type)  # a merge's stays
            return fn(x, *args, **kwargs)
        return run

    for mod, name, fn in saved:
        setattr(mod, name, counted(fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def beam_decode_phase(lm_path: str, top_a: int) -> dict:
    """Config 2's serving path through ``decode.main`` at full width with the
    LM at ``lm_path`` (the 4-gram ARPA or the RNN LM's ``.npz``) and its own
    decode ladder (14 buckets over 64 utterances of 10-16 s, so batches may
    be partly filled), 4 batches: exactly 1 K1, 8 K2 and 1 beam kernel a
    batch (K7, K8 with ``decode.ext_top_a``; K9 over all chars or the top-A
    with the RNN LM), no other kernel, and no call of the plain search on
    the card."""
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(
            (prefix_beam, "beam_scan_plain")) as plain_calls:
        argv = [CFG2, f"decode.lm_path={lm_path}", "data.synthetic_min_sec=10",
                "data.synthetic_max_sec=16", "data.synthetic_num_utts=64",
                f"max_batches={DECODE_BATCHES}", f"train.checkpoint_dir={ckpt}"]
        if top_a:
            argv.append(f"decode.ext_top_a={top_a}")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    beam = ("prefix_beam_rnn" if lm_path.endswith(".npz") else "prefix_beam") + (
        "_topa" if top_a else "")
    want = {"stft_log_mel": DECODE_BATCHES, "lstm_seq": DECODE_BATCHES * CFG2_LAYERS * 2,
            beam: DECODE_BATCHES}
    check({k: v for k, v in launches.items() if v} == want,
          f"beam decode launches {launches} != {want}")
    check(not plain_calls, f"the plain search ran on the serving path: {plain_calls}")
    check(set(result) == {"method", "wer", "cer", "num_utts", "decode_rtf",
                          "padding_efficiency_decode", "world_size", "dist_backend"}
          and result["num_utts"] > 0 and result["decode_rtf"] > 0
          and result["world_size"] == 1, f"beam decode: bad result {result}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "ext_top_a": top_a,
            "launches": launches}


def beam_profile_phase(lm_path: str) -> dict:
    """Device time by kernel over one config-2 decode batch (16 utterances of
    10-16 s, bf16, the LM at ``lm_path``): the shares of K2 and of the beam
    kernel (K7 with the 4-gram, K9 with the RNN LM)."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": lm_path})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, CARD)
    decode_fn = driver.make_decode_fn(cfg, model, driver.load_lm(cfg, CARD))
    with torch.inference_mode():
        decode_fn(batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ids, _ = decode_fn(batch)
            ids.cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, "beam profile: no device time recorded")
    share = lambda key: sum(r["device_ms"] for r in rows if key in r["name"]) / total  # noqa: E731
    return {"batch_wall_ms": wall_ms, "device_ms": total, "device_busy": total / wall_ms,
            "lstm_share": share("lstm"), "prefix_beam_share": share("prefix_beam"),
            "top": rows[:8]}


def decode_phase() -> dict:
    # One bucket and 8 utterances a batch: every batch the path decodes is full.
    argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
            f"data.synthetic_num_utts={DECODE_BATCHES * B}", "data.auto_buckets=1",
            f"max_batches={DECODE_BATCHES}"]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    result = decode.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(set(result) == {"wer", "cer", "num_utts", "decode_rtf", "world_size",
                          "dist_backend"}, f"decode: {result}")
    check(result["num_utts"] == DECODE_BATCHES * B and 0.0 <= result["wer"]
          and result["decode_rtf"] > 0, f"decode: bad result {result}")
    check(launches["stft_log_mel"] == DECODE_BATCHES,
          f"stft launches {launches['stft_log_mel']} != {DECODE_BATCHES} batches")
    check(launches["lstm_seq"] == DECODE_BATCHES * LAYERS * 2,
          f"lstm launches {launches['lstm_seq']} != {DECODE_BATCHES} x {LAYERS} x 2")
    check(launches["prefix_beam"] == launches["prefix_beam_topa"] == 0,
          f"greedy decode launched a beam kernel: {launches}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "launches": launches}


def profile_phase() -> list:
    """Device time by kernel name over one bf16 decode batch of 10-16 s utterances."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": "8",
                                            "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, CARD)
    with torch.inference_mode():
        eval_step(model, batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ids, _ = eval_step(model, batch)
            ids.cpu()
    return device_rows(prof)[:8]


def device_rows(prof) -> list:
    """Device time by kernel name, largest first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": ev.key[:60], "device_ms": dev_us / 1e3, "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def train_profile_phase() -> dict:
    """Device time by kernel name over one full-width bf16 train step on a
    full batch of 10-16 s utterances, beside the step's host-clock time."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": str(B),
                                            "data.auto_buckets": "1"})
    host_batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    st = train_state.init_train_state(cfg, train_state.build_model(cfg, CARD))
    batch = train_state.batch_to_device(host_batch, CARD)
    train_state.train_step(cfg, st, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_state.train_step(cfg, st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    check(total > 0, "train profile: no device time recorded")
    return {"step_wall_ms": wall_ms, "device_ms": total, "device_busy": total / wall_ms,
            "top": rows[:12]}


def tcn_weights(g: torch.Generator) -> list[torch.Tensor]:
    """Block weights at lecun-normal scales, as the model draws them, with
    LayerNorm scales near 1 and nonzero biases."""
    C, K = TCN_C, TCN_K
    return [t.cuda() for t in (1 + 0.1 * torch.randn(C, generator=g),
                               0.1 * torch.randn(C, generator=g),
                               torch.randn(K, C, 2 * C, generator=g) / (K * C) ** 0.5,
                               0.1 * torch.randn(2 * C, generator=g),
                               torch.randn(C, C, generator=g) / C ** 0.5,
                               0.1 * torch.randn(C, generator=g))]


def tcn_composite(p: list[torch.Tensor], d: int):
    """The yardstick, a composite of torch calls in fp32 that the port never
    makes: body(xn) = F.conv1d (dilation d, padding 2d) -> F.glu -> F.linear,
    and block(x) = body(F.layer_norm(x)) (+ x).  Weights in the layouts the
    calls take, made once."""
    w_conv = p[2].permute(2, 1, 0).contiguous()              # (2C, C, K)
    w_point = p[4].T.contiguous()                            # (out, in)

    def body(xn, wc=w_conv, bc=p[3], wp=w_point, bp=p[5]):
        acc = F.conv1d(xn.transpose(1, 2), wc, bc, dilation=d, padding=(TCN_K // 2) * d)
        return F.linear(F.glu(acc.transpose(1, 2), dim=-1), wp, bp)

    def block(x, residual):
        y = body(F.layer_norm(x, (TCN_C,), p[0], p[1], eps=tcn_cuda.EPS))
        return x + y if residual else y

    return body, block, (w_conv, w_point)


def tcn_phase() -> list[dict]:
    """K5, the K6 forward and the K6 backward against their plain versions
    at config 3's block shapes, B 16 x T' 400 and a ragged T' 397, C 384,
    K 5, every dilation of the cycle; rows of 10-16 s with zero padding past
    their lengths; K5 also on bf16 input, as the model feeds it.  Kernels
    are timed at every dilation, the plain versions and the composite
    yardstick at d = 1."""
    g = torch.Generator().manual_seed(11)
    p = tcn_weights(g)
    names = {"tcn_block": ("out",), "tcn_block_train_fwd": ("y", "xn"),
             "tcn_block_bwd": ("dxn", "dwc", "dbc", "dwp", "dbp")}
    errs = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0} for n in names}
    timed, cases = {}, []
    B, C, K = TCN_B, TCN_C, TCN_K
    for T in (TCN_T, TCN_RAGGED_T):
        lengths = torch.linspace(T, 0.625 * T, B).int()
        x = torch.randn(B, T, C, generator=g)
        x = torch.where(torch.arange(T)[None, :, None] < lengths[:, None, None], x, 0.0).cuda()
        dy = torch.randn(B, T, C, generator=g).cuda()
        for d in TCN_DILATIONS:
            out = tcn_cuda.tcn_block(x, *p, d)
            y, xn = tcn_cuda.tcn_block_train_fwd(x, *p, d)
            grads = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], d)
            torch.cuda.synchronize()
            want_y, want_xn = tcn_cuda.tcn_block_train_fwd_plain(x, *p, d)
            want = {"out": tcn_cuda.tcn_block_plain(x, *p, d), "y": want_y, "xn": want_xn,
                    **dict(zip(names["tcn_block_bwd"], tcn_cuda.tcn_block_bwd_plain(
                        want_xn, dy, p[2], p[3], p[4], d)))}
            got = {"out": out, "y": y, "xn": xn, **dict(zip(names["tcn_block_bwd"], grads))}
            case = {"T": T, "dilation": d}
            for kernel, outs in names.items():
                for o in outs:
                    check(got[o].dtype == want[o].dtype and got[o].shape == want[o].shape
                          and bool(torch.isfinite(got[o]).all()), f"{kernel} {o}: bad output")
                    err, rel = errors(got[o], want[o])
                    check(rel <= TCN_TOL, f"{kernel} {o} T={T} d={d}: {rel} > {TCN_TOL} "
                                          "of its largest entry")
                    e = errs[kernel]
                    e["max_abs_err"], e["max_rel_err"] = (max(e["max_abs_err"], err),
                                                          max(e["max_rel_err"], rel))
                    case[o] = rel
            if T == TCN_T:
                case["ms"] = {"tcn_block": time_ms(lambda: tcn_cuda.tcn_block(x, *p, d)),
                              "tcn_block_train_fwd": time_ms(
                                  lambda: tcn_cuda.tcn_block_train_fwd(x, *p, d)),
                              "tcn_block_bwd": time_ms(lambda: tcn_cuda.tcn_block_bwd(
                                  xn, dy, p[2], p[3], p[4], d))}
            if T == TCN_T and d == 1:
                timed = {"x": x, "dy": dy, "xn": xn}
                again = tcn_cuda.tcn_block_bwd(xn, dy, p[2], p[3], p[4], d)
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      "tcn_block_bwd: two calls differ")
            cases.append(case)
        xb = x.bfloat16()
        outb, wantb = tcn_cuda.tcn_block(xb, *p, 4), tcn_cuda.tcn_block_plain(xb, *p, 4)
        check(outb.dtype == torch.bfloat16, "tcn_block: bf16 input must give bf16 output")
        bf16_err, bf16_rel = errors(outb, wantb)
        check(bf16_rel <= TCN_BF16_TOL, f"tcn_block bf16 T={T}: {bf16_rel}")
        cases.append({"T": T, "dilation": 4, "x": "bf16", "out": bf16_rel})

    # Timed at d = 1, B 16, T' 400: the plain versions and the yardstick.
    x, dy, xn = timed["x"], timed["dy"], timed["xn"]
    body, block, (wc_l, wp_l) = tcn_composite(p, 1)
    lib_err, _ = errors(block(x, True), tcn_cuda.tcn_block_plain(x, *p, 1))
    check(lib_err <= 1e-3, f"tcn yardstick computes another function: {lib_err}")
    leaves = [t.detach().clone().requires_grad_(True) for t in (xn, wc_l, p[3], wp_l, p[5])]
    lib_out = body(*leaves)
    plain = {"tcn_block": lambda: tcn_cuda.tcn_block_plain(x, *p, 1),
             "tcn_block_train_fwd": lambda: tcn_cuda.tcn_block_train_fwd_plain(x, *p, 1),
             "tcn_block_bwd": lambda: tcn_cuda.tcn_block_bwd_plain(xn, dy, p[2], p[3], p[4], 1)}
    library = {"tcn_block": lambda: block(x, True), "tcn_block_train_fwd": lambda: block(x, False),
               "tcn_block_bwd": lambda: torch.autograd.grad(lib_out, leaves, dy,
                                                            retain_graph=True)}
    what = {"tcn_block": "4-call composite F.layer_norm -> F.conv1d -> F.glu -> F.linear, + x "
                         "(fp32, cuDNN and cuBLAS, no TF32)",
            "tcn_block_train_fwd": "4-call composite F.layer_norm -> F.conv1d -> F.glu -> "
                                   "F.linear (fp32)",
            "tcn_block_bwd": "3-call composite F.conv1d -> F.glu -> F.linear from xn, its "
                             "autograd backward (autograd.grad, graph kept)"}
    # Operations: the conv 2 B T C K 2C and the pointwise 2 B T C C; the
    # backward recomputes the conv, then dglu, dw_point, dw_conv and dxn.
    BT, P = B * TCN_T, 4 * (2 * C + K * C * 2 * C + 2 * C + C * C + C)
    fwd_ops = 2 * BT * C * (K * 2 * C + C)
    bwd_ops = 2 * BT * C * C * (6 * K + 2)
    # The backward's products run as 3xTF32 on the tensor cores: three
    # TF32 products for each one; its fp32 bound is reported beside.
    bounds = {"tcn_block": bound(4 * BT * C * 2 + P, fwd_ops / PEAK_FP32_S),
              "tcn_block_train_fwd": bound(4 * BT * C * 3 + P, fwd_ops / PEAK_FP32_S),
              "tcn_block_bwd": bound(4 * BT * C * 3 + 2 * P, 3 * bwd_ops / PEAK_TF32_S)}
    bwd_fp32_bound = bound(4 * BT * C * 3 + 2 * P, bwd_ops / PEAK_FP32_S)
    lines = {"tcn_block": 83, "tcn_block_train_fwd": 302, "tcn_block_bwd": 321}
    head = next(c for c in cases if c["T"] == TCN_T and c["dilation"] == 1)
    out = []
    for name in names:
        b_ms, b_by = bounds[name]
        out.append({
            "name": name, "route": "cuda", "source": "pytorch_asr_tpu_torch/csrc/tcn_block.cu",
            "replaces": f"pytorch_asr_tpu/ops/dilated_conv_pallas.py:{lines[name]}",
            "shape": f"x ({B}, {TCN_T}, {C}) f32 (also T' {TCN_RAGGED_T}, bf16 x for K5), "
                     f"w_conv ({K}, {C}, {2 * C}), d {list(TCN_DILATIONS)}",
            **errs[name], "tol": {"max_rel_err": TCN_TOL} if name != "tcn_block" else
            {"max_rel_err": TCN_TOL, "bf16 x max_rel_err": TCN_BF16_TOL},
            "ms": head["ms"][name], "plain_ms": time_ms(plain[name], 5, 4, 1),
            "library_ms": time_ms(library[name], 5, 4, 1), "library": what[name],
            "bound_ms": b_ms, "bound_by": b_by,
            **({"bound_fp32_ms": bwd_fp32_bound[0], "bound_note": "bound_ms: 3xTF32 on "
                "tensor cores (3 x ops / 495 TFLOP/s); bound_fp32_ms: ops / 67 TFLOP/s",
                "bit_equal_run_to_run": True} if name == "tcn_block_bwd" else {}),
            "ms_by_dilation": {c["dilation"]: c["ms"][name] for c in cases if "ms" in c}})
    out[0]["cases"] = cases
    return out


def tcn_decode_phase() -> dict:
    """Config 3's serving path through ``decode.main`` at full width in bf16
    on its own 14-bucket decode ladder over 64 utterances of 10-16 s, 4
    batches: exactly 1 K1, 10 K5 and 1 K7 a batch, no other kernel, and no
    call of the plain block or the plain search on the card."""
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(
            (tcn_cuda, "tcn_block_plain"), (prefix_beam, "beam_scan_plain")) as plain_calls:
        argv = [CFG3, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={DECODE_BATCHES}",
                f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    want = {"stft_log_mel": DECODE_BATCHES, "tcn_block": DECODE_BATCHES * TCN_BLOCKS,
            "prefix_beam": DECODE_BATCHES}
    check({k: v for k, v in launches.items() if v} == want,
          f"tcn decode launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the serving path: {plain_calls}")
    check(set(result) == {"method", "wer", "cer", "num_utts", "decode_rtf",
                          "padding_efficiency_decode", "world_size", "dist_backend"}
          and result["num_utts"] > 0 and result["decode_rtf"] > 0,
          f"tcn decode: bad result {result}")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "launches": launches}


def tcn_train_phase() -> dict:
    """Config 3's training path: ``train.main`` at full width in bf16, full
    batches of 16 utterances of 10-16 s in one bucket, dropout 0.1 and
    SpecAugment from the trainer's generator, then the greedy eval: per step
    1 K1, 10 K6 forwards, 10 K6 backwards, 1 K4 alpha and 1 beta; per eval
    batch 1 K1 and 10 K5; and no call of a plain block version on the card."""
    plain = [(tcn_cuda, name) for name in ("tcn_block_plain", "tcn_block_train_fwd_plain",
                                           "tcn_block_bwd_plain")]
    with tempfile.TemporaryDirectory() as ckpt, plain_calls_of(*plain) as plain_calls:
        argv = [CFG3, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                f"data.synthetic_num_utts={TCN_TRAIN_UTTS}", "data.auto_buckets=1",
                f"steps={TRAIN_STEPS}", f"train.eval_every={TRAIN_STEPS}",
                f"train.log_every={TRAIN_STEPS}", f"train.checkpoint_dir={ckpt}"]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        result = train.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    last, ev = result["train"], result["eval"]
    evals = TCN_TRAIN_UTTS // TCN_B
    want = {"stft_log_mel": TRAIN_STEPS + evals, "tcn_block": TCN_BLOCKS * evals,
            "tcn_block_train_fwd": TCN_BLOCKS * TRAIN_STEPS,
            "tcn_block_bwd": TCN_BLOCKS * TRAIN_STEPS, "ctc_alpha": TRAIN_STEPS,
            "ctc_beta": TRAIN_STEPS}
    check({k: v for k, v in launches.items() if v} == want,
          f"tcn train launches {launches} != {want}")
    check(not plain_calls, f"a plain version ran on the training path: {plain_calls}")
    check(last.get("step") == TRAIN_STEPS and math.isfinite(last["ctc_loss"])
          and math.isfinite(last["grad_norm"]), f"tcn train: bad record {last}")
    check(ev.get("num_utts") == TCN_TRAIN_UTTS, f"tcn train eval: {ev}")
    return {"record": last, "eval": ev, "wall_s": wall, "step_s": 1.0 / last["steps_per_sec"],
            "launches": launches,
            "launches_per_step": {k: (v - (want["tcn_block"] if k == "tcn_block" else 0)
                                      - (evals if k == "stft_log_mel" else 0)) / TRAIN_STEPS
                                  for k, v in launches.items() if v},
            "launches_per_eval_batch": {"stft_log_mel": 1, "tcn_block": TCN_BLOCKS}}


def tcn_profile_phase() -> dict:
    """Device time by kernel over one config-3 decode batch (16 utterances of
    10-16 s, bf16, beam 16, no LM) and one full-width bf16 train step on the
    same batch, each beside its host-clock time."""
    cfg = get_config(CFG3, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(TCN_B), "data.auto_buckets": "1"})
    host_batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    decode_fn = driver.make_decode_fn(cfg, build_model(cfg, CARD))
    with torch.inference_mode():
        decode_fn(host_batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            ids, _ = decode_fn(host_batch)
            ids.cpu()
            dec_ms = (time.perf_counter() - t0) * 1e3
    st = train_state.init_train_state(cfg, train_state.build_model(cfg, CARD))
    batch = train_state.batch_to_device(host_batch, CARD)
    train_state.train_step(cfg, st, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as tprof:
        t0 = time.perf_counter()
        train_state.train_step(cfg, st, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for name, p, wall in (("decode", prof, dec_ms), ("train", tprof, step_ms)):
        rows = device_rows(p)
        total = sum(r["device_ms"] for r in rows)
        check(total > 0, f"tcn {name} profile: no device time recorded")
        share = lambda key: sum(r["device_ms"] for r in rows if key in r["name"]) / total  # noqa
        out[name] = {"wall_ms": wall, "device_ms": total, "device_busy": total / wall,
                     "gemm_share": share("gemm_kernel"), "tc_gemm_share": share("tc_gemm_kernel"),
                     "prefix_beam_share": share("prefix_beam"),
                     "top": rows[:12]}
    return out

def shard_candidates(state, logp_t, P: int, lm, kw: dict) -> tuple[dict, dict]:
    """One frame's candidates as P beam shards build them (each its K/P
    beams, with global parent ids) and the all-gather assembles them:
    shard-major, contiguous."""
    kl, parts = BEAM_K // P, []
    for p in range(P):
        local = prefix_beam_sharded._local_slice(state, p, kl)
        rows = lm[local.ctx.long()] if lm is not None else None
        parts.append(prefix_beam._build_candidates(local, logp_t, lm_rows=rows, K=kl,
                                                   parent_offset=p * kl, **kw))
    return tuple({k: torch.cat([q[i][k] for q in parts], 1).contiguous() for k in parts[0][i]}
                  for i in (0, 1))


def merge_phase(arpa: str) -> dict:
    """K10 against the plain merge (``_merge_topk``), both on the card, every
    output field bit for bit, dead picks included: config 2's model logits
    for 16 utterances of 10-16 s (the last row cut to no frames), the plain
    search's state advanced to frames 0 and 1 (most beams dead) and 150,
    with no LM and with the 4-gram, candidates gathered from 2 and 4 beam
    shards (B 16, K 16, 30 lanes a beam).  Timed at frame 150 with the
    4-gram and 2 shards."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1"})
    logits, lens = cfg2_batch_logits(cfg)
    lens = lens.clone()
    lens[BEAM_B - 1] = 0
    B, T, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    table = driver.load_lm(get_config(CFG2, **{"decode.lm_path": arpa}), CARD)
    dec, cases, timed = cfg.decode, [], None
    for lm in (None, table):
        kw = dict(blank=0, vocab=V, lm_table=lm, lm_alpha=dec.lm_alpha if lm is not None else 0.0,
                  lm_beta=dec.lm_beta if lm is not None else 0.0, L=BEAM_L)
        state = prefix_beam._init_state(B, BEAM_K, BEAM_L, CARD)
        for t in range(max(MERGE_FRAMES) + 1):
            for P in ((2, 4) if t in MERGE_FRAMES else ()):
                stay, ext = shard_candidates(state, logp[:, t], P, lm, kw)
                build.reset_launches()
                score, got = beam_cuda.merge_topk(stay, ext, BEAM_K)
                torch.cuda.synchronize()
                check(build.LAUNCHES["merge_topk"] == 1, f"merge_topk: {dict(build.LAUNCHES)}")
                want_score, want = prefix_beam._merge_topk(stay, ext, BEAM_K)
                tag = f"merge_topk frame {t} P {P} {'4-gram' if lm is not None else 'no LM'}"
                check(torch.equal(score, want_score), f"{tag}: scores differ")
                for name, w in want.items():
                    check(got[name].dtype == w.dtype and torch.equal(got[name], w),
                          f"{tag}: {name} differs from the plain merge")
                alive = prefix_beam._lse(stay["pb"], stay["pnb"]) > prefix_beam.NEG_INF / 2
                cases.append({"frame": t, "P": P, "lm": lm is not None,
                              "alive_stays": int(alive.sum()),
                              "dead_picks": int((want_score <= prefix_beam.NEG_INF / 2).sum())})
                if lm is not None and t == max(MERGE_FRAMES) and P == 2:
                    timed = (stay, ext)
            state, _ = prefix_beam._step(state, logp[:, t], t < lens, K=BEAM_K, **kw)
    stay, ext = timed
    nb = V - 1
    N = BEAM_K + BEAM_K * nb
    # Bytes: the 7 stay and 6 lane fields read once, the 9 outputs written.
    # Operations a row: ~3 a candidate (its score and key), 3 a (beam, beam)
    # absorb test, and a top-K over N candidates at log2(K) compares each.
    nbytes = 4 * (7 * B * BEAM_K + 6 * B * BEAM_K * nb + 9 * B * BEAM_K)
    ops = B * (3 * N + 3 * BEAM_K ** 2 + N * math.log2(BEAM_K))
    b_ms, b_by = bound(nbytes, ops / PEAK_FP32_S)
    # Back-to-back calls measure the wrapper (its checks, 9 output tensors,
    # the ctypes call) where that costs more than the kernel; the profiler
    # gives the kernel's own device time.
    merge = lambda: beam_cuda.merge_topk(stay, ext, BEAM_K)  # noqa: E731
    return {"name": "merge_topk", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "pytorch_asr_tpu/ops/beam_pallas.py:1026",
            "shape": f"stays ({B}, {BEAM_K}) x 7 fields, lanes ({B}, {BEAM_K * nb}) x 6 fields, "
                     f"K {BEAM_K}, from 2 and 4 shards, frames {list(MERGE_FRAMES)}",
            "max_abs_err": 0.0, "tol": "every field bit-equal",
            "ms": time_ms(merge), "device_ms": device_ms_per_call(merge, "merge_topk_kernel"),
            "plain_ms": time_ms(lambda: prefix_beam._merge_topk(stay, ext, BEAM_K)),
            "library_ms": None, "library": "none: no PyTorch call computes this merge",
            "bound_ms": b_ms, "bound_by": b_by, "cases": cases}


def rnn_past_smem_phase(rnn_lm_path: str) -> dict:
    """K9 where the LM state does not fit a block's shared memory beside the
    search, so each block keeps it in a device scratch: an LM of H 512 x 2
    layers (random weights from a seed) at beam 16, and the trained default
    LM at beam 32; planted transcripts on config 2's model logits, the last
    row cut to no frames; tokens and lengths exact against the plain search
    on the card, scores within RNN_RTOL / RNN_ATOL; both timed."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm_path})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    dec, sos = cfg.decode, get_tokenizer(cfg.data.vocab).sos_id
    wide = CharRNNLM(WIDE_LM, V, seed=23).to(CARD).eval()
    out = {}
    for name, lm, K in (("h512", wide, BEAM_K), ("beam32", driver.load_lm(cfg, CARD), WIDE_BEAM)):
        lmc = lm.cfg
        smem = beam_cuda.rnn_smem_bytes(K, V, V, lmc.num_layers, lmc.embed_dim, lmc.hidden_dim)
        check(smem > beam_cuda.MAX_SMEM, f"{name}: its state fits shared memory ({smem} bytes)")
        kw = dict(beam_size=K, max_len=BEAM_L, rnn_lm=lm, sos_id=sos, lm_alpha=dec.lm_alpha,
                  lm_beta=dec.lm_beta)
        build.reset_launches()
        got = prefix_beam.prefix_beam_search(planted, ragged, **kw)
        torch.cuda.synchronize()
        check({k: v for k, v in build.LAUNCHES.items() if v} == {"prefix_beam_rnn": 1},
              f"K9 {name}: {dict(build.LAUNCHES)}")
        want = prefix_beam.prefix_beam_search_plain(planted, ragged, **kw)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"K9 {name}: tokens or lengths differ from the plain search")
        torch.testing.assert_close(got[2], want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m, name=name: f"K9 {name} scores: {m}")
        logp = prefix_beam._prepare(planted, 0)[0]
        state0 = prefix_beam.primed_lm_state(lm, sos)
        args = (logp, ragged.to(torch.int32).contiguous(), K, BEAM_L, lm, *state0, dec.lm_alpha,
                dec.lm_beta)
        out[name] = {"K": K, "lm": f"E {lmc.embed_dim} H {lmc.hidden_dim} x {lmc.num_layers}",
                     "state_in_smem_bytes": smem,
                     "scratch_bytes": 4 * B * beam_cuda.lm_state_floats(K, V, lmc.num_layers,
                                                                        lmc.hidden_dim),
                     "max_abs_err": (got[2] - want[2]).abs().max().item(),
                     "mean_len": got[1].float().mean().item(),
                     "ms": time_ms(lambda: beam_cuda.prefix_beam_rnn(*args), 3, 1, 1),
                     "plain_ms": time_ms(lambda: prefix_beam.beam_scan_plain(
                         *args[:4], None, *args[8:], rnn_lm=lm, lm_state=state0), 1, 1, 0)}
    return out


def device_ms_per_call(fn, kernel: str, calls: int = 20) -> float:
    """The device time of the kernels named ``kernel`` per call of ``fn``,
    from the profiler over ``calls`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    got = sum(r["device_ms"] for r in device_rows(prof) if kernel in r["name"])
    check(got > 0, f"no device time recorded for {kernel}")
    return got / calls


@contextlib.contextmanager
def timed_calls(*targets):
    """Wrap each (module, name) function so that every call is timed on the
    host clock between two synchronisations, with its first argument's
    second dim (a search's frames); yields {name: [(seconds, dim), ...]}."""
    log = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def run(x, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *args, **kwargs)
            torch.cuda.synchronize()
            dim = x.shape[1] if isinstance(x, torch.Tensor) and x.dim() > 1 else 0
            log[name].append((time.perf_counter() - t0, dim))
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rank_decode(argv: list[str]) -> dict:
    """One rank of a decode (spawned, or in this process for one rank):
    ``decode.main(argv)`` with the launch counters set to 0 just before and
    read just after, the device of every plain merge or plain search call,
    and each batch's encoder and search times, with the all-gathers inside
    each (a collective's time includes waiting for the slowest rank)."""
    torch.cuda.synchronize()
    with plain_calls_of((prefix_beam, "_merge_topk"), (prefix_beam, "beam_scan_plain")) as plain, \
            timed_calls((driver, "model_outputs"), (driver, "prefix_beam_search_sharded"),
                        (driver, "prefix_beam_search")) as steps, \
            timed_calls((encoder_bilstm, "model_all_gather")) as enc_x, \
            timed_calls((prefix_beam_sharded, "model_all_gather")) as search_x:
        build.reset_launches()
        t0 = time.perf_counter()
        result = decode.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    searches = steps["prefix_beam_search_sharded"] + steps["prefix_beam_search"]
    return {"rank": distributed.topology()["rank"], "result": result, "wall_s": wall,
            "launches": {k: v for k, v in launches.items() if v}, "plain": plain,
            "frames": [d for _, d in searches],
            "encoder_s": sum(t for t, _ in steps["model_outputs"]),
            "search_s": sum(t for t, _ in searches),
            "encoder_exchange_s": sum(t for t, _ in enc_x["model_all_gather"]),
            "search_exchange_s": sum(t for t, _ in search_x["model_all_gather"])}


def rank_search(logits: np.ndarray, lens: np.ndarray, lm_path: str, kw: dict) -> dict:
    """One of 4 ranks: the sharded search with the RNN LM at model axis 4
    on the same rows as every rank; its result and launch counts."""
    distributed.initialize("cuda")
    dev = resolve_device("cuda")
    mesh = make_mesh(MeshConfig(model_axis=4))
    rnn = driver.load_lm(get_config(CFG2, **{"decode.lm_path": lm_path}), dev)
    build.reset_launches()
    got = prefix_beam_sharded.prefix_beam_search_sharded(
        torch.from_numpy(logits).to(dev), torch.from_numpy(lens).to(dev), mesh, rnn_lm=rnn, **kw)
    torch.cuda.synchronize()
    return {"out": [g.cpu().numpy() for g in got],
            "launches": {k: v for k, v in build.LAUNCHES.items() if v}}


def read_dump(prefix: str) -> list[tuple[str, str]]:
    """(reference, hypothesis) text pairs of a decode dump, in its order."""
    with open(prefix + ".ref.tsv") as r, open(prefix + ".hyp.tsv") as h:
        return [(a.split("\t", 1)[1], b.split("\t", 1)[1]) for a, b in zip(r, h)]


def sharded_decode_phase(arpa: str, rnn_lm: str) -> dict:
    """Config 2's serving path across ranks: ``decode.main ctc_bilstm_beam_lm
    decode.shard_beams=true`` at full width on its 14-bucket decode ladder
    over 64 utterances of 10-16 s, 2 batches, in ranks spawned on the one
    card over gloo.  Each rank and batch runs 1 K1, the K2 launches of its
    direction (4, or 8 without the split), one K10 a frame, no K7 or K9, and
    no plain merge or search on the card.
      one:    the one-rank decode of the same batches (K7), the reference;
      model2: 2 ranks, model axis 2, the 4-gram: the same hypotheses;
      data2_model2: 4 ranks, data 2 x model 2, the 4-gram: the same
              hypotheses, each utterance counted once;
      rnn_model4: 4 ranks, model axis 4, the RNN LM;
    then the sharded search with the RNN LM in 4 ranks on config 2's logits
    with each row's transcript planted, against the plain search on the
    card: tokens and lengths exact, scores within RNN_RTOL / RNN_ATOL."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = [CFG2, "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
                "data.synthetic_num_utts=64", f"max_batches={SHARD_BATCHES}",
                f"train.checkpoint_dir={tmp}/none"]
        ngram = base + [f"decode.lm_path={arpa}"]
        one = rank_decode(ngram + [f"dump_path={tmp}/one"])
        check(one["launches"] == {"stft_log_mel": SHARD_BATCHES,
                                  "lstm_seq": 2 * CFG2_LAYERS * SHARD_BATCHES,
                                  "prefix_beam": SHARD_BATCHES} and not one["plain"],
              f"one-rank decode: {one['launches']} {one['plain']}")
        want_pairs = read_dump(f"{tmp}/one")
        # name: (ranks, model axis, argv, K2 directions a layer on each rank)
        runs = {"model2": (2, 2, ngram + ["mesh.model_axis=2"], 1),
                "data2_model2": (4, 2, ngram + ["mesh.data_axis=2", "mesh.model_axis=2"], 1),
                "rnn_model4": (4, 4, base + [f"decode.lm_path={rnn_lm}", "mesh.model_axis=4"],
                               2)}
        for name, (world, model, argv, dirs) in runs.items():
            ranks = launch.spawn(rank_decode, world, argv + [
                "decode.shard_beams=true", f"dump_path={tmp}/{name}"], timeout=RANK_TIMEOUT)
            for r in ranks:
                frames = r["frames"]
                want = {"stft_log_mel": SHARD_BATCHES,
                        "lstm_seq": dirs * CFG2_LAYERS * SHARD_BATCHES, "merge_topk": sum(frames)}
                check(len(frames) == SHARD_BATCHES and r["launches"] == want,
                      f"{name} rank {r['rank']}: launches {r['launches']} != {want}")
                check(not r["plain"], f"{name}: a plain merge or search ran: {r['plain']}")
                res = r["result"]
                check(res["world_size"] == world and res["dist_backend"] == "gloo"
                      and res["num_utts"] == one["result"]["num_utts"], f"{name}: {res}")
            res = ranks[0]["result"]
            if name != "rnn_model4":
                check(all(r["result"]["wer"] == one["result"]["wer"]
                          and r["result"]["cer"] == one["result"]["cer"] for r in ranks),
                      f"{name}: WER/CER {res} differ from one rank's {one['result']}")
                pairs = [p for r in ranks if r["rank"] % model == 0
                         for p in read_dump(f"{tmp}/{name}.p{r['rank']}")]
                check(sorted(pairs) == sorted(want_pairs) and (name != "model2"
                                                               or pairs == want_pairs),
                      f"{name}: hypotheses differ from the one-rank decode")
            r0 = ranks[0]
            exchange = r0["encoder_exchange_s"] + r0["search_exchange_s"]
            out[name] = {"world": world, **{k: res[k] for k in (
                "wer", "cer", "num_utts", "decode_rtf", "dist_backend")},
                "launches_rank0": r0["launches"], "frames": r0["frames"],
                **{k: r0[k] for k in ("wall_s", "encoder_s", "search_s", "encoder_exchange_s",
                                      "search_exchange_s")},
                "search_ms_per_frame": 1e3 * r0["search_s"] / sum(r0["frames"]),
                "exchange_share_of_batches": exchange / (r0["encoder_s"] + r0["search_s"])}
        out["one"] = {**{k: one["result"][k] for k in ("wer", "cer", "num_utts", "decode_rtf")},
                      "launches": one["launches"], "encoder_s": one["encoder_s"],
                      "search_s": one["search_s"]}
    out["search_rnn_model4"] = sharded_rnn_search(rnn_lm)
    return out


def sharded_rnn_search(rnn_lm: str) -> dict:
    """The sharded search with the RNN LM in 4 ranks at model axis 4 (one
    K10 a frame) against the plain search on the card."""
    cfg = get_config(CFG2, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                              "data.synthetic_num_utts": str(BEAM_B), "data.auto_buckets": "1",
                              "decode.lm_path": rnn_lm})
    logits, lens = cfg2_batch_logits(cfg)
    B, T, V = logits.shape
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    path = transcript_path(batch, lens.cpu(), T).to(CARD)
    planted = logits.clone()
    planted.scatter_add_(2, path[..., None], torch.full((B, T, 1), 4.0, device=CARD))
    ragged = lens.clone()
    ragged[B - 1] = 0
    dec = cfg.decode
    kw = dict(beam_size=BEAM_K, max_len=BEAM_L, lm_alpha=dec.lm_alpha, lm_beta=dec.lm_beta,
              sos_id=get_tokenizer(cfg.data.vocab).sos_id)
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_search, 4, planted.float().cpu().numpy(),
                         ragged.int().cpu().numpy(), rnn_lm, kw, timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    want = prefix_beam.prefix_beam_search_plain(planted, ragged, rnn_lm=driver.load_lm(cfg, CARD),
                                                **kw)
    for r in ranks:
        check(r["launches"] == {"merge_topk": T}, f"sharded RNN search: {r['launches']}")
        toks, n, score = (torch.from_numpy(x).to(CARD) for x in r["out"])
        check(torch.equal(n, want[1]) and torch.equal(toks, want[0]),
              "sharded RNN search: tokens or lengths differ from the plain search")
        torch.testing.assert_close(score, want[2], rtol=RNN_RTOL, atol=RNN_ATOL,
                                   msg=lambda m: f"sharded RNN search scores: {m}")
    score = torch.from_numpy(ranks[0]["out"][2]).to(CARD)
    return {"ranks": 4, "frames": T, "max_abs_err": (score - want[2]).abs().max().item(),
            "tol": {"tokens": "equal", "scores_rtol": RNN_RTOL, "scores_atol": RNN_ATOL},
            "spawn_and_search_s": wall, "mean_len": want[1].float().mean().item()}


def main() -> int:
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # Library yardsticks (cuDNN's LSTM and convolutions) in full fp32 too.
    set_fp32_math()
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    logs = build.build(["stft_log_mel", "lstm_seq", "ctc_alpha_beta", "prefix_beam",
                       "tcn_block", "prefix_beam_study"])
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    arpa = build_lm()
    print(f"lm: {time.perf_counter() - t0:.1f} s (set-up)")
    rnn_lm, lm_record = build_rnn_lm()
    print("rnn_lm:", json.dumps(lm_record))
    print(f"rnn_lm: {lm_record['wall_s']:.1f} s (set-up), {LM_STEPS} steps, "
          f"nll {lm_record['nll']:.4f}")

    bilstm, bilstm_launches = bilstm_phase()
    kernels = [stft_phase(), lstm_phase(), *lstm_train_phase(), *ctc_phase(),
               *beam_phase(arpa), *rnn_beam_phase(rnn_lm), *tcn_phase(), merge_phase(arpa),
               *bilstm, ctc_paired_phase(), *study_beam_phase()]
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} "
              f"(tol {k['tol']}) ms {k['ms']:.4f} plain {k['plain_ms']:.4f} "
              f"library {lib} bound {k['bound_ms']:.4f} ({k['bound_by']})")
    print("slice:", json.dumps(slice_phase()))
    print("train_step:", json.dumps(train_step_phase()))
    dec = decode_phase()
    print("decode:", json.dumps(dec))
    trn = train_main_phase()
    print("train:", json.dumps(trn))
    print(f"train: audio_seconds_per_sec_per_chip "
          f"{trn['record']['audio_seconds_per_sec_per_chip']:.2f} step {trn['step_s']:.4f} s "
          f"ctc_loss {trn['record']['ctc_loss']:.4f}")
    print("learn:", json.dumps(learn_phase(arpa, rnn_lm)))
    beam_dec = {"beam_decode": beam_decode_phase(arpa, 0),
                "beam_decode_topa": beam_decode_phase(arpa, BEAM_A),
                "rnn_decode": beam_decode_phase(rnn_lm, 0),
                "rnn_decode_topa": beam_decode_phase(rnn_lm, BEAM_A)}
    for path, res in beam_dec.items():
        print(f"{path}:", json.dumps(res))
        print(f"{path}: decode_rtf {res['decode_rtf']:.5f} wer {res['wer']:.4f} "
              f"padding_efficiency_decode {res['padding_efficiency_decode']:.4f}")
    print("tcn_slice:", json.dumps(slice_phase(CFG3)))
    print("tcn_train_step:", json.dumps(train_step_phase(CFG3, "encoder.stem.")))
    tcn_dec = tcn_decode_phase()
    print("tcn_decode:", json.dumps(tcn_dec))
    print(f"tcn_decode: decode_rtf {tcn_dec['decode_rtf']:.5f} wer {tcn_dec['wer']:.4f} "
          f"padding_efficiency_decode {tcn_dec['padding_efficiency_decode']:.4f}")
    tcn_trn = tcn_train_phase()
    print("tcn_train:", json.dumps(tcn_trn))
    print(f"tcn_train: audio_seconds_per_sec_per_chip "
          f"{tcn_trn['record']['audio_seconds_per_sec_per_chip']:.2f} "
          f"step {tcn_trn['step_s']:.4f} s ctc_loss {tcn_trn['record']['ctc_loss']:.4f}")
    print("rnn_past_smem:", json.dumps(rnn_past_smem_phase(rnn_lm)))
    t0 = time.perf_counter()
    sharded = sharded_decode_phase(arpa, rnn_lm)
    print("sharded_decode:", json.dumps(sharded))
    for path in ("model2", "data2_model2", "rnn_model4"):
        res = sharded[path]
        print(f"sharded_decode {path}: ranks {res['world']} over {res['dist_backend']} "
              f"decode_rtf {res['decode_rtf']:.5f} wer {res['wer']:.4f} "
              f"exchange_share {res['exchange_share_of_batches']:.3f}")
    print(f"sharded_decode: {time.perf_counter() - t0:.1f} s")
    trn_paired = train_paired_phase()
    print("train_paired:", json.dumps(trn_paired))
    t0 = time.perf_counter()
    scripts = bench_scripts_phase()
    print("bench_scripts:", json.dumps(scripts))
    print(f"bench_scripts: {time.perf_counter() - t0:.1f} s")
    # Each kernel is held to the main path that runs it: K7, K8 and K9 to
    # the config-2 serving paths, K5 to config 3's serving path, K6 to config
    # 3's training path, K10 to the sharded decode; K11 to its op's own path
    # (no model calls it, as in the JAX package), the paired alpha to config
    # 1's training with PAIRED_FWD set, K13 and K12 to the benchmark scripts
    # that reach them; the rest to config 1's training path (which runs K2
    # in its eval); every path's count is printed.
    paths = {"train": trn["launches"], "decode": dec["launches"],
             **{p: r["launches"] for p, r in beam_dec.items()},
             "tcn_decode": tcn_dec["launches"], "tcn_train": tcn_trn["launches"],
             **{f"sharded_{p}": sharded[p]["launches_rank0"]
                for p in ("model2", "data2_model2", "rnn_model4")},
             "bilstm": bilstm_launches, "train_paired": trn_paired["launches"],
             **{p: scripts[p]["launches"] for p in ("bench_prefix_beam", "bench_beam_compile")}}
    own_path = {"prefix_beam": "beam_decode", "prefix_beam_topa": "beam_decode_topa",
                "prefix_beam_rnn": "rnn_decode", "prefix_beam_rnn_topa": "rnn_decode_topa",
                "tcn_block": "tcn_decode", "tcn_block_train_fwd": "tcn_train",
                "tcn_block_bwd": "tcn_train", "merge_topk": "sharded_model2",
                "bilstm_seq": "bilstm", "bilstm_seq_train_fwd": "bilstm",
                "bilstm_seq_bwd": "bilstm", "ctc_alpha_paired": "train_paired",
                "prefix_beam_fused": "bench_prefix_beam",
                "prefix_beam_stepwise": "bench_beam_compile"}
    # The per-utterance oracle of the grid kernel is no path's kernel.
    oracle_runs = {p: counts.get("bilstm_seq_per_utterance", 0) for p, counts in paths.items()}
    print("bilstm_seq_per_utterance launches by path:", json.dumps(oracle_runs))
    check(not any(oracle_runs.values()), f"the per-utterance oracle ran on a path: {oracle_runs}")
    for k in kernels:
        by_path = {p: counts.get(k["name"], 0) for p, counts in paths.items()}
        own = own_path.get(k["name"], "train")
        check(by_path[own] > 0, f"{k['name']} never launched on its main path ({own})")
        k["launches"], k["launches_by_path"], k["main_path"] = by_path[own], by_path, own
        k["kernel_ms"] = k["ms"]
    print("profile:", json.dumps(profile_phase()))
    print("train_profile:", json.dumps(train_profile_phase()))
    print("beam_profile:", json.dumps(beam_profile_phase(arpa)))
    print("rnn_beam_profile:", json.dumps(beam_profile_phase(rnn_lm)))
    print("tcn_profile:", json.dumps(tcn_profile_phase()))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_descendants()
    sys.exit(code)
