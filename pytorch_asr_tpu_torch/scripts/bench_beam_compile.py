"""Times the per-frame design of the prefix beam search against the whole-
utterance kernel: the port of the JAX package's
``scripts/bench_beam_compile.py``, its ``stepwise=1`` and ``merge=1`` arms.

    python -m pytorch_asr_tpu_torch.scripts.bench_beam_compile stepwise=1 [T=1000 K=16 V=32
        batches=16 iters=3 device=cuda]
    python -m pytorch_asr_tpu_torch.scripts.bench_beam_compile merge=1 [...]

Random logits (numpy seed 0), B = the first of ``batches``, every row T
frames, beam K, max_len 256; each arm timed over ``iters`` calls after a
warm-up, the device synchronised around each call:
  * ``stepwise=1``: K7, the whole search in one launch ("monolithic
    lanes"); K12, one launch a frame with the state in device memory
    ("stepwise lanes (per-frame kernel)"); and the plain search;
  * ``merge=1``: the plain search frame by frame with the plain merge and
    top-K, and with K10 in its place (the beam-sharded search's merge).
The JAX script's default arm measures the Mosaic compile time of its lane
kernels under ``ROLLED_INNER``; nvcc builds each source once, before any
run, so that arm has no counterpart here, and the script exits non-zero
when neither arm is asked for (its ``rolled=`` is read and ignored, so the
JAX script's documented command lines run as they are).  Runs on the GPU unless ``device=cpu``,
where every search is the plain one.  Returns {arm: {"ms",
"us_per_frame"}} and the device.
"""

from __future__ import annotations

import sys

import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.ops import beam_cuda
from pytorch_asr_tpu_torch.scripts import _timing

DEFAULTS = {"T": "1000", "K": "16", "V": "32", "batches": "16,32,64", "iters": "3",
            "stepwise": "0", "merge": "0", "rolled": ""}
L = 256


def merge_search(logits, lens, K: int, fused: bool):
    """The search frame by frame through the plain candidates, a merge (K10
    when ``fused``, else the plain one), the token rebuild and the freeze;
    the best beam's tokens of each row."""
    B, T, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    merge = beam_cuda.merge_topk if fused else pb._merge_topk
    state = pb._init_state(B, K, L, logits.device)
    for t in range(T):
        stay, ext = pb._build_candidates(state, logp[:, t], blank=0, vocab=V, lm_table=None,
                                         lm_rows=None, lm_alpha=0.0, lm_beta=0.0, K=K, L=L)
        _, f = merge(stay, ext, K)
        state = pb._finish_step(state, f, t < lens, L)
    return pb._best(state)[0]


def main(argv: list[str] | None = None) -> dict:
    kv, device = _timing.parse(sys.argv[1:] if argv is None else argv, DEFAULTS)
    T, K, V, iters = (int(kv[k]) for k in ("T", "K", "V", "iters"))
    B = int(kv["batches"].split(",")[0])
    if kv["stepwise"] != "1" and kv["merge"] != "1":
        raise SystemExit("bench_beam_compile: pass stepwise=1 or merge=1. The JAX script's "
                         "default arm times Mosaic's compile of its lane kernels; on the card "
                         "nvcc builds each source once before any run, so it has no "
                         "counterpart here.")
    print(f"device: {_timing.device_name(device)} T={T} K={K} V={V}")
    _, logits, lens = _timing.random_logits(B, T, V, device)
    results = {}

    def measure(name, fn):
        dt = _timing.seconds_per_call(fn, iters, device)
        results[name] = {"ms": dt * 1e3, "us_per_frame": dt / T * 1e6}
        print(f"{name}: {dt*1e3:.2f} ms  per-step {dt/T*1e6:.1f} us")

    if kv["stepwise"] == "1":
        measure("monolithic lanes", lambda: pb.prefix_beam_search(logits, lens, K, 0,
                                                                  max_len=L))
        measure("stepwise lanes (per-frame kernel)",
                lambda: beam_cuda.prefix_beam_lanes_stepwise(logits, lens, K, 0, L))
        measure("plain scan", lambda: pb.prefix_beam_search_plain(logits, lens, K, 0,
                                                                  max_len=L))
    else:
        measure("plain merge scan", lambda: merge_search(logits, lens, K, fused=False))
        measure("fused merge scan", lambda: merge_search(logits, lens, K, fused=True))
    return {"device": _timing.device_name(device), "B": B, "T": T,
            "calls_per_arm": iters + 1, "arms": results}


if __name__ == "__main__":
    main()
