"""Times K11's backward (``ops.lstm_cuda.bilstm_seq_bwd``), K10
(``ops.beam_cuda.merge_topk``) and K9 (``ops.beam_cuda.rnn_on_route``, on
its grid and its block kernel) on one card:

    python -m pytorch_asr_tpu_torch.scripts.bench_kernel_turns [reps=5 inner=4
        calls=40 frame=150]

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

It calls only entry points that every checkout of the port has (and the
traces where there are), so it times any checkout alike: run it by its path
with that checkout first on ``PYTHONPATH`` to compare two checkouts on one
card, in turns.  Prints, and returns, one JSON record.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding import prefix_beam_sharded
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, lstm_cuda
from pytorch_asr_tpu_torch.scripts import _timing

DEFAULTS = {"reps": "5", "inner": "4", "calls": "40", "frame": "150"}
LSTM_B, LSTM_T, LSTM_D, LSTM_H = 8, 400, 768, 384
LSTM_LENGTHS = [400, 371, 352, 330, 310, 290, 260, 250]
MERGE_B, MERGE_K, MERGE_V, MERGE_L = 16, 16, 31, 256
PRODUCTS = ("gemm_kernel", "column_sum_kernel", "add_halves_kernel")


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


def main(argv: list[str] | None = None) -> dict:
    kv, device = _timing.parse(sys.argv[1:] if argv is None else argv, DEFAULTS)
    reps, inner, calls, frame = (int(kv[k]) for k in ("reps", "inner", "calls", "frame"))
    if device.type != "cuda":
        raise SystemExit("bench_kernel_turns: times kernels; it needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"device": _timing.device_name(device), "card": card.strip().splitlines()[0],
           "bilstm_seq_bwd": bilstm_backward(reps, inner, calls, device),
           "merge_topk": merge(calls, frame, device),
           "prefix_beam_rnn": rnn_search(reps, inner, device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
