"""Times K11's backward (``ops.lstm_cuda.bilstm_seq_bwd``), K10
(``ops.beam_cuda.merge_topk``), K9 (``ops.beam_cuda.rnn_on_route``, on
its grid and its block kernel), K4 (``ops.ctc_cuda.ctc_alpha`` and
``ctc_beta``), K1 and config 3's training on one card:

    python -m pytorch_asr_tpu_torch.scripts.bench_kernel_turns [reps=5 inner=4
        calls=40 frame=150 only=bilstm,merge,rnn,ctc,stft,train3,lstm,beam]

``only`` names the sections to run (all eight by default).

K11's backward at config 1's layer shape: x (8, 400, 768) bf16, H 384,
lengths 400 down to 250, residuals bf16 and float32 from its training
forward, upstream gradients from numpy seed 0.  Each call is timed with
CUDA events over ``inner`` calls queued back to back, the median of
``reps``; then the profiler's device time a call by kernel over ``calls //
10`` calls: the dh recurrence (the kernels named ``lstm_bwd_``) apart from
the products (``gemm_kernel``, ``column_sum_kernel``, ``add_halves_kernel``).
Where the checkout has it (``lstm_cuda.bilstm_backward_on_route``), CTA (0,
0)'s median µs a step of the dual grid by phase, from its trace.

K10 at the beam-sharded decode's shape: 16 rows, beam 16 over 31 chars (30
lanes a beam), the candidates that 2 and 4 beam shards gather from the plain
search's state at frame ``frame`` of random logits (numpy seed 0), with no
LM and with a random dense table of 31^2 contexts: the profiler's device time
a launch over ``calls`` launches, and a wrapper call's time (CUDA events
over 10 calls queued back to back, the median of 5: the host's share where
it exceeds the kernel's); and where the wrapper takes a ``trace``,
block 0's median µs by phase (loads, absorb, keys and sort, picks) over
``calls`` launches, at the clock the traces saw.

K9 at config 2's shape: 16 rows of 397 frames of random logits (numpy seed
0) over 31 chars, beam 16, max_len 256, an LM of E 128, H 256, 2 layers
(``CharRNNLM`` seed 0), over all chars and the top 8: its grid
(``rnn_grid_route``) and its block kernel (route None), each timed with
CUDA events as K11's backward, in turns grid, block, block, grid.

K4 and the paired alpha at config 1's training shape (``train_ctc_case``: 8
synthetic 10-16 s utterances' labels, logits (8, T', 31) from torch seed 4,
a row of no frames and an infeasible row), at config 3's (its batch of 16,
all rows feasible) and at the card tests' three cases (``ctc_case``, numpy
seed 8; ``chip_smoke.py`` and the tests build theirs here): a sha256 of each
output (alphas and final; the posteriors, fed the plain alphas; the paired
alpha's alphas and final), so that two checkouts' bits can be compared; at
each configuration's shape the alpha, the paired alpha, the beta and
``F.ctc_loss``'s forward and backward timed with CUDA events as K11's
backward, in turns; and there, where the wrappers take a ``trace``, the
median µs a frame (a pair) by phase (``ctc_split``: for the alpha and beta
``CTC_PHASES``, the row's wait, the neighbour warp's edge, the shuffles,
the lse3 chain, the stores; for the paired alpha ``PAIRED_PHASES``, the
rows' wait, the emission weights, the shuffles, the left warp's edge, the
lse chains, the publication and stores).

K1 at config 1's serving shape (8 synthetic utterances of 16 s, n_fft 512):
a sha256 of its output and its time with CUDA events as K11's backward.

Config 3's ``train.main`` (``train3``), as ``chip_smoke.py`` runs it: its
audio seconds a second and steps a second, from the trainer's own record.

The LSTM kernels' bits (``lstm``) at K11's inputs above (x (8, 400, 768)
bf16, H 384, the same lengths, upstream gradients from numpy seed 0): a
sha256 of the outputs of K2 (each direction, bf16 and float32 output), K3's
training forward (its output and residuals, bf16 and float32) and backward
(dx, dwih, dwhh, db), K11's forward, training forward and backward, and the
wide routes (the ops with ``forward_route`` and ``backward_route`` set to
None, the per-utterance kernels), so that two checkouts' bits can be
compared.

The offline searches' bits (``beam``): a sha256 of the outputs of K7 and K8
(no LM and a random dense table of 31^2 contexts, as K10's), K9 on its grid
and its block kernel (over all chars and the top 8; the LM above at beam
16), and the in-scratch forms (``beam_cuda.fits`` set to False: K7, K8 and
K9's block form) at K9's inputs above (16 rows of 397 frames, max_len
256), so that two checkouts' bits can be compared.

It calls only entry points that every checkout of the port has (and the
traces where there are), so it times any checkout alike: run it by its path
with that checkout first on ``PYTHONPATH`` to compare two checkouts on one
card, in turns.  Prints, and returns, one JSON record.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_asr_tpu_torch import train
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding import prefix_beam_sharded
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.models.encoder_bilstm import conv_out_len
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, ctc, ctc_cuda, lstm_cuda, stft_cuda
from pytorch_asr_tpu_torch.scripts import _timing

DEFAULTS = {"reps": "5", "inner": "4", "calls": "40", "frame": "150",
            "only": "bilstm,merge,rnn,ctc,stft,train3,lstm,beam"}
LSTM_B, LSTM_T, LSTM_D, LSTM_H = 8, 400, 768, 384
LSTM_LENGTHS = [400, 371, 352, 330, 310, 290, 260, 250]
MERGE_B, MERGE_K, MERGE_V, MERGE_L = 16, 16, 31, 256
PRODUCTS = ("gemm_kernel", "column_sum_kernel", "add_halves_kernel")
CTC_B, CTC_V = 8, 31
CTC_TEST_CASES = ((6, 90, 9, 30), (2, 1100, 5, 520), (2, 2200, 30, 1500))
CTC_PHASES = ("row", "edge", "shuffles", "chain", "stores")
PAIRED_PHASES = ("row", "weights", "shuffles", "edge", "chain", "stores")


def _events_ms(fn, reps: int, inner: int) -> float:
    # Kept here, not in _timing: the script runs against older checkouts too.
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


def _device_ms(fn, calls: int) -> dict:
    """The profiler's device time a call of ``fn`` by kernel name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows[ev.key] = rows.get(ev.key, 0.0) + us / 1e3 / calls
    return rows


def _median_split(rows: np.ndarray, names: tuple[str, ...], ghz: float) -> dict:
    return {n: float(np.median(rows[:, i + 1] - rows[:, i])) / ghz / 1e3
            for i, n in enumerate(names)}


def bilstm_backward(reps: int, inner: int, calls: int, dev) -> dict:
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    G = 4 * LSTM_H
    x = t(rng.standard_normal((LSTM_B, LSTM_T, LSTM_D)) * 0.5).bfloat16()
    wih = t(rng.standard_normal((2, LSTM_D, G)) / LSTM_D ** 0.5).bfloat16()
    whh = t(rng.standard_normal((2, LSTM_H, G)) / LSTM_H ** 0.5)
    bias = t(rng.standard_normal((2, G)) * 0.1)
    lens = torch.tensor(LSTM_LENGTHS, dtype=torch.int32, device=dev)
    gy = t(rng.standard_normal((LSTM_B, LSTM_T, 2 * LSTM_H)))
    out = {}
    for res in (torch.bfloat16, torch.float32):
        _, acts, ct = lstm_cuda.bilstm_seq_train_fwd(x, wih, whh, bias, lens, torch.bfloat16,
                                                     res)
        bargs = (gy, x, wih, whh, lens, acts, ct)
        fn = lambda: lstm_cuda.bilstm_seq_bwd(*bargs)  # noqa: E731
        rows = _device_ms(fn, max(calls // 10, 2))
        rec = {"ms": _events_ms(fn, reps, inner),
               "recurrence_device_ms": sum(v for k, v in rows.items() if "lstm_bwd_" in k),
               "products_device_ms": sum(v for k, v in rows.items()
                                         if any(p in k for p in PRODUCTS)),
               "device_ms": sum(rows.values())}
        if hasattr(lstm_cuda, "bilstm_backward_on_route"):
            grid = lstm_cuda.backward_route(LSTM_H, LSTM_B, directions=2,
                                            sms=torch.cuda.get_device_properties(dev)
                                            .multi_processor_count)
            trace = torch.zeros((LSTM_T, 5), dtype=torch.int64, device=dev)
            lstm_cuda.bilstm_backward_on_route(grid, *bargs, trace=trace)
            tr = trace[:max(LSTM_LENGTHS)].cpu().numpy().astype(np.float64)
            ghz = (tr[-1, 1] - tr[0, 1]) / (tr[-1, 0] - tr[0, 0])
            cycles = {"stage": tr[:-1, 2] - tr[:-1, 1], "chains": tr[:-1, 3] - tr[:-1, 2],
                      "cells": tr[:-1, 4] - tr[:-1, 3], "barrier": tr[1:, 1] - tr[:-1, 4]}
            rec["grid"] = grid._asdict()
            rec["step_us_median"] = {k: float(np.median(v)) / ghz / 1e3
                                     for k, v in cycles.items()}
        out[str(res).split(".")[1]] = rec
    return out


def _candidates(state, logp_t, P: int, table, kw: dict):
    """One frame's candidates as P beam shards build them and the all-gather
    assembles them: shard-major, contiguous."""
    kl, parts = MERGE_K // P, []
    for p in range(P):
        local = prefix_beam_sharded._local_slice(state, p, kl)
        rows = table[local.ctx.long()] if table is not None else None
        parts.append(pb._build_candidates(local, logp_t, lm_rows=rows, K=kl,
                                          parent_offset=p * kl, **kw))
    return tuple({k: torch.cat([q[i][k] for q in parts], 1).contiguous() for k in parts[0][i]}
                 for i in (0, 1))


def merge(calls: int, frame: int, dev) -> dict:
    rng, logits, lens = _timing.random_logits(MERGE_B, frame + 1, MERGE_V, dev)
    logp = torch.log_softmax(logits, -1)
    table = rng.standard_normal((MERGE_V * MERGE_V, MERGE_V)).astype(np.float32)
    table -= np.log(np.exp(table).sum(1, keepdims=True))
    table = torch.from_numpy(table).to(dev)
    traced = "trace" in inspect.signature(beam_cuda.merge_topk).parameters
    out = {}
    for lm in (None, table):
        kw = dict(blank=0, vocab=MERGE_V, lm_table=lm, lm_alpha=0.5 if lm is not None else 0.0,
                  lm_beta=1.0 if lm is not None else 0.0, L=MERGE_L)
        state = pb._init_state(MERGE_B, MERGE_K, MERGE_L, dev)
        for t in range(frame):
            state, _ = pb._step(state, logp[:, t], t < lens, K=MERGE_K, **kw)
        for P in (2, 4):
            stay, ext = _candidates(state, logp[:, frame], P, lm, kw)
            fn = lambda: beam_cuda.merge_topk(stay, ext, MERGE_K)  # noqa: E731
            rows = _device_ms(fn, calls)
            rec = {"device_ms": sum(v for k, v in rows.items() if "merge_topk_kernel" in k),
                   "call_ms": _events_ms(fn, 5, 10)}
            if traced:
                trace = torch.zeros((calls, 7), dtype=torch.int64, device=dev)
                for i in range(calls):
                    beam_cuda.merge_topk(stay, ext, MERGE_K, trace=trace[i])
                tr = trace.cpu().numpy().astype(np.float64)
                ghz = (tr[:, 5] - tr[:, 1]).sum() / (tr[:, 6] - tr[:, 0]).sum()
                rec["trace_clock_ghz"] = ghz
                rec["us_median"] = _median_split(tr[:, 1:6], ("loads", "absorb", "sort",
                                                              "picks"), ghz)
                rec["us_total_median"] = float(np.median(tr[:, 5] - tr[:, 1])) / ghz / 1e3
            out[f"P{P}_{'4gram' if lm is not None else 'nolm'}"] = rec
    return out


def rnn_search(reps: int, inner: int, dev) -> dict:
    _, logits, lens = _timing.random_logits(MERGE_B, 397, MERGE_V, dev)
    lm = CharRNNLM(RNNLMConfig(embed_dim=128, hidden_dim=256, num_layers=2), MERGE_V,
                   seed=0).to(dev).eval()
    state0 = pb.primed_lm_state(lm, 29)
    out = {}
    for A in (0, 8):
        logp, (top_val, top_idx) = pb._prepare(logits, A)
        args = (logp, lens, MERGE_K, MERGE_L, lm, *state0, 0.5, 1.0, top_val, top_idx)
        route = beam_cuda.rnn_grid_route(MERGE_B, MERGE_K, A or MERGE_V, MERGE_V, 2, 128, 256,
                                         torch.cuda.get_device_properties(dev)
                                         .multi_processor_count)
        fns = {"grid_ms": lambda: beam_cuda.rnn_on_route(route, *args),
               "block_ms": lambda: beam_cuda.rnn_on_route(None, *args)}
        rec = {n: [] for n in fns}
        for n in [*fns, *reversed(fns)]:
            rec[n].append(_events_ms(fns[n], reps, 1))
        out[f"top{A}" if A else "all_chars"] = rec
    return out


def _digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def train_ctc_case(dev, config: str = "ctc_bilstm_dev1h", planted: bool = True):
    """K4's inputs at a configuration's training shape: the labels of its
    first training batch of 10-16 s synthetic utterances, the encoder's
    output lengths, logits (B, T', 31) from torch seed 4; with ``planted``,
    the second-last row has no frames and the last is infeasible.
    Returns (logits, logit_len, labels, label_len) on ``dev``."""
    B = get_config(config).data.batch_size
    cfg = get_config(config, **{"data.synthetic_min_sec": "10", "data.synthetic_max_sec": "16",
                                "data.synthetic_num_utts": str(B), "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    enc = cfg.model.encoder
    logit_len = features.num_frames(torch.from_numpy(batch["audio_len"]), cfg.frontend)
    if enc.kind == "tcn":
        logit_len = conv_out_len(logit_len, 2 * enc.subsample, enc.subsample)
    else:
        for _ in enc.conv_channels:
            logit_len = conv_out_len(logit_len, enc.conv_kernel[0], enc.conv_stride[0])
    label_len = torch.from_numpy(batch["token_len"]).to(torch.int32)
    logit_len = logit_len.to(torch.int32)
    if planted:
        logit_len[B - 2] = 0
        logit_len[B - 1] = label_len[B - 1] // 2
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(B, int(logit_len.max()), CTC_V, generator=g) * 2
    return (logits.to(dev), logit_len.to(dev), torch.from_numpy(batch["tokens"]).to(dev),
            label_len.to(dev))


def ctc_case(dev, B: int = 6, T: int = 90, V: int = 9, Lmax: int = 30, seed: int = 8):
    """The card tests' K4 case (numpy ``seed``): ragged rows with repeats
    (they block the skip); row 0 has Lmax labels in T frames; with B > 2,
    row 1 has no frames and row 2 is infeasible.  Returns (logits,
    logit_len, labels, label_len) on ``dev``."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    label_len = rng.integers(1, Lmax + 1, size=B).astype(np.int32)
    logit_len = np.minimum(2 * label_len + rng.integers(1, T, size=B), T).astype(np.int32)
    labels = rng.integers(1, V, size=(B, Lmax)).astype(np.int32)
    labels[0, :4] = [1, 1, 2, 2]
    label_len[0], logit_len[0] = Lmax, T
    if B > 2:
        logit_len[1] = 0
        label_len[2], logit_len[2] = Lmax, Lmax // 2
    for b in range(B):
        labels[b, label_len[b]:] = 0
    return tuple(torch.from_numpy(a).to(dev) for a in (logits, logit_len, labels, label_len))


def _ctc_inputs(case):
    """(alpha args, beta args) of a case, the beta fed the plain alphas."""
    logits, logit_len, labels, label_len = case
    _, logp_tbs, _, skip = ctc.prep(logits, labels.long(), label_len, 0)
    lens = logit_len.contiguous()
    ref_alphas, ref_final = ctc.alphas_plain(logp_tbs, skip, lens)
    logz = ctc.terminal_logz(ref_final, label_len)
    feasible = (logz > ctc.NEG_INF / 2) & (lens > 0)
    bargs = (logp_tbs, ref_alphas, ctc.shift_left(skip, 2, fill=False).contiguous(),
             ctc.terminal_betas(label_len, logp_tbs.shape[2]),
             torch.where(feasible, lens, 0).to(torch.int32), torch.where(feasible, logz, 0.0))
    return (logp_tbs, skip, lens), bargs


def ctc_split(call, T: int, dev, phases: tuple[str, ...] = CTC_PHASES) -> dict:
    """Where a K4 frame's time goes (or a paired alpha's pair, with
    ``PAIRED_PHASES``): the trace of each frame (pair) recursed, written by
    ``call(trace)`` (``ctc_cuda.ctc_alpha``'s or ``ctc_alpha_paired``'s
    ``trace``): the median µs of each phase, of a frame, and from one
    frame's start to the next's, at the clock the trace saw from its first
    frame to its last."""
    trace = torch.zeros((T, 8), dtype=torch.int64, device=dev)
    call(trace)
    torch.cuda.synchronize()
    tr = trace.cpu().numpy().astype(np.float64)
    tr = tr[tr[:, 0] != 0]
    if len(tr) < 2:
        return {"frames": len(tr)}
    tr = tr[np.argsort(tr[:, 0], kind="stable")]
    ghz = (tr[-1, 1] - tr[0, 1]) / (tr[-1, 0] - tr[0, 0])
    last = 1 + len(phases)
    return {"frames": len(tr), "trace_clock_ghz": ghz,
            "us_median": _median_split(tr[:, 1:last + 1], phases, ghz),
            "frame_us_median": float(np.median(tr[:, last] - tr[:, 1])) / ghz / 1e3,
            "start_to_start_us_median": float(np.median(np.diff(tr[:, 1]))) / ghz / 1e3}


def ctc_kernels(reps: int, inner: int, dev) -> dict:
    out = {"bits": {}, "turns": {}, "shape": {}}
    cases = [("config1", train_ctc_case(dev)),
             ("config3", train_ctc_case(dev, "tcn_ctc_devclean", planted=False)),
             *((f"test_{'_'.join(map(str, c))}", ctc_case(dev, *c)) for c in CTC_TEST_CASES)]
    for tag, case in cases:
        aargs, bargs = _ctc_inputs(case)
        alphas, final = ctc_cuda.ctc_alpha(*aargs)
        w = ctc_cuda.ctc_beta(*bargs)
        out["bits"][tag] = {"alphas": _digest(alphas, final), "posteriors": _digest(w),
                            "paired": _digest(*ctc_cuda.ctc_alpha_paired(*aargs))}
        if not tag.startswith("config"):
            continue
        logits, logit_len, labels, label_len = case
        lp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_(True)
        lib = lambda: F.ctc_loss(lp, labels.long(), logit_len.long(),  # noqa: E731
                                 label_len.long(), reduction="none", zero_infinity=True)
        lib_loss = lib()
        fns = {"alpha_ms": lambda: ctc_cuda.ctc_alpha(*aargs),
               "paired_ms": lambda: ctc_cuda.ctc_alpha_paired(*aargs),
               "beta_ms": lambda: ctc_cuda.ctc_beta(*bargs),
               "library_forward_ms": lib,
               "library_backward_ms": lambda: torch.autograd.grad(lib_loss.sum(), lp,
                                                                  retain_graph=True)}
        turns = {n: [] for n in fns}
        for n in [*fns, *reversed(fns)]:
            turns[n].append(_events_ms(fns[n], reps, inner))
        out["turns"][tag], out["shape"][tag] = turns, list(aargs[0].shape)
        T = aargs[0].shape[0]
        if tag == "config1" and "trace" in inspect.signature(ctc_cuda.ctc_alpha).parameters:
            out["alpha_split"] = ctc_split(lambda tr: ctc_cuda.ctc_alpha(*aargs, trace=tr), T,
                                           dev)
            out["beta_split"] = ctc_split(lambda tr: ctc_cuda.ctc_beta(*bargs, trace=tr), T,
                                          dev)
        if "trace" in inspect.signature(ctc_cuda.ctc_alpha_paired).parameters:
            out.setdefault("paired_split", {})[tag] = ctc_split(
                lambda tr: ctc_cuda.ctc_alpha_paired(*aargs, trace=tr), T, dev, PAIRED_PHASES)
        if hasattr(ctc_cuda, "lane_plan"):
            out.setdefault("route", {})[tag] = list(ctc_cuda.lane_plan(aargs[0].shape[2]))
    return out


def train3(dev) -> dict:
    """Config 3's ``train.main`` as ``chip_smoke.py::tcn_train_phase`` runs
    it (20 steps of 16 utterances of 10-16 s, one bucket, then the eval):
    its training throughput and steps a second."""
    with tempfile.TemporaryDirectory() as ckpt:
        result = train.main(["tcn_ctc_devclean", "data.synthetic_min_sec=10",
                             "data.synthetic_max_sec=16", "data.synthetic_num_utts=64",
                             "data.auto_buckets=1", "steps=20", "train.eval_every=20",
                             "train.log_every=20", f"train.checkpoint_dir={ckpt}"])
    rec = result["train"]
    return {k: rec[k] for k in ("audio_seconds_per_sec_per_chip", "steps_per_sec")}


def lstm_bits(dev) -> dict:
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    G = 4 * LSTM_H
    x = t(rng.standard_normal((LSTM_B, LSTM_T, LSTM_D)) * 0.5).bfloat16()
    wih = t(rng.standard_normal((2, LSTM_D, G)) / LSTM_D ** 0.5).bfloat16()
    whh = t(rng.standard_normal((2, LSTM_H, G)) / LSTM_H ** 0.5)
    bias = t(rng.standard_normal((2, G)) * 0.1)
    lens = torch.tensor(LSTM_LENGTHS, dtype=torch.int32, device=dev)
    gy = t(rng.standard_normal((LSTM_B, LSTM_T, 2 * LSTM_H)))
    out = {}
    routes = (lstm_cuda.forward_route, lstm_cuda.backward_route)
    for form in ("grid", "wide"):
        if form == "wide":
            lstm_cuda.forward_route = lstm_cuda.backward_route = lambda *a, **k: None
        try:
            for d in (0, 1):
                args = (x, wih[d], whh[d], bias[d], lens, bool(d))
                out[f"{form} k2 dir{d}"] = _digest(*(lstm_cuda.lstm_seq_infer(*args, o)
                                                     for o in (torch.bfloat16, torch.float32)))
                for res in (torch.bfloat16, torch.float32):
                    fwd = lstm_cuda.lstm_seq_train_fwd(*args, torch.bfloat16, res)
                    out[f"{form} k3 dir{d} {res}"] = _digest(*fwd, *lstm_cuda.lstm_seq_bwd(
                        gy[..., d * LSTM_H:(d + 1) * LSTM_H].contiguous(), x, wih[d], whh[d],
                        lens, fwd[1], fwd[2], bool(d)))
            dual = (x, wih, whh, bias, lens, torch.bfloat16)
            out[f"{form} k11"] = _digest(lstm_cuda.bilstm_seq_infer(*dual))
            for res in (torch.bfloat16, torch.float32):
                fwd = lstm_cuda.bilstm_seq_train_fwd(*dual, res)
                out[f"{form} k11 train {res}"] = _digest(*fwd, *lstm_cuda.bilstm_seq_bwd(
                    gy, x, wih, whh, lens, fwd[1], fwd[2]))
        finally:
            lstm_cuda.forward_route, lstm_cuda.backward_route = routes
    return out


def beam_bits(dev) -> dict:
    rng, logits, lens = _timing.random_logits(MERGE_B, 397, MERGE_V, dev)
    table = rng.standard_normal((MERGE_V * MERGE_V, MERGE_V)).astype(np.float32)
    table = torch.from_numpy(table - np.log(np.exp(table).sum(1, keepdims=True))).to(dev)
    lm = CharRNNLM(RNNLMConfig(embed_dim=128, hidden_dim=256, num_layers=2), MERGE_V,
                   seed=0).to(dev).eval()
    state0 = pb.primed_lm_state(lm, 29)
    route = beam_cuda.rnn_grid_route(MERGE_B, MERGE_K, MERGE_V, MERGE_V, 2, 128, 256,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
    out, fits = {}, beam_cuda.fits
    for form in ("shared", "wide"):
        if form == "wide":
            beam_cuda.fits = lambda *a, **k: False
        try:
            for A in (0, 8):
                logp, (top_val, top_idx) = pb._prepare(logits, A)
                for name, tab in (("nolm", None), ("dense", table)):
                    out[f"{form} k7/8 top{A} {name}"] = _digest(*beam_cuda.prefix_beam(
                        logp, lens, MERGE_K, MERGE_L, tab, 0.5, 1.0, top_val, top_idx))
                for name, r in (("grid", route), ("block", None)):
                    if form == "wide" and r is not None:
                        continue
                    out[f"{form} k9 {name} top{A}"] = _digest(*beam_cuda.rnn_on_route(
                        r, logp, lens, MERGE_K, MERGE_L, lm, *state0, 0.5, 1.0, top_val,
                        top_idx))
        finally:
            beam_cuda.fits = fits
    return out


def stft(reps: int, inner: int, dev) -> dict:
    cfg = FrontendConfig()
    audio = np.zeros((CTC_B, 16 * cfg.sample_rate), np.float32)
    for b, (a, _) in enumerate(synthetic_corpus(CTC_B, cfg.sample_rate, seed=1, min_sec=16.0,
                                                max_sec=17.0)):
        audio[b, : min(len(a), audio.shape[1])] = a[: audio.shape[1]]
    audio = torch.from_numpy(audio).to(dev)
    fn = lambda: stft_cuda.stft_log_mel(audio, cfg)  # noqa: E731
    return {"bits": _digest(fn()), "ms": _events_ms(fn, reps, inner)}


def main(argv: list[str] | None = None) -> dict:
    kv, device = _timing.parse(sys.argv[1:] if argv is None else argv, DEFAULTS)
    reps, inner, calls, frame = (int(kv[k]) for k in ("reps", "inner", "calls", "frame"))
    only = set(kv["only"].split(","))
    if device.type != "cuda":
        raise SystemExit("bench_kernel_turns: times kernels; it needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"device": _timing.device_name(device), "card": card.strip().splitlines()[0]}
    if "bilstm" in only:
        out["bilstm_seq_bwd"] = bilstm_backward(reps, inner, calls, device)
    if "merge" in only:
        out["merge_topk"] = merge(calls, frame, device)
    if "rnn" in only:
        out["prefix_beam_rnn"] = rnn_search(reps, inner, device)
    if "ctc" in only:
        out["ctc"] = ctc_kernels(reps, inner, device)
    if "stft" in only:
        out["stft"] = stft(reps, inner, device)
    if "train3" in only:
        out["train3"] = train3(device)
    if "lstm" in only:
        out["lstm_bits"] = lstm_bits(device)
    if "beam" in only:
        out["beam_bits"] = beam_bits(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
