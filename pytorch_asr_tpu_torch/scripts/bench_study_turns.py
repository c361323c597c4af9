"""Times the two study searches, K13 (``ops.beam_cuda.prefix_beam_fused``)
and K12 (``ops.beam_cuda.prefix_beam_lanes_stepwise``), beside K7
(``decoding.prefix_beam.prefix_beam_search``), on one card:

    python -m pytorch_asr_tpu_torch.scripts.bench_study_turns [B=16 T=397 V=31 K=16
        L=256 reps=5 inner=4]

Random logits (numpy seed 0), every row T frames, no LM.  Each search is
timed with CUDA events over ``inner`` calls queued back to back, the median
of ``reps``, after one warm-up call; the three in turns, K7 K13 K12 K12 K13
K7.  It calls only those three entry points, so it times any checkout of the
port the same way: run it by its path with that checkout first on
``PYTHONPATH`` to compare two checkouts on one card.  Prints, and returns,
{"device", "shape", name: [ms, ms]}.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.ops import beam_cuda
from pytorch_asr_tpu_torch.scripts import _timing

DEFAULTS = {"B": "16", "T": "397", "V": "31", "K": "16", "L": "256", "reps": "5",
            "inner": "4"}


def _ms(fn, reps: int, inner: int) -> float:
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


def main(argv: list[str] | None = None) -> dict:
    kv, device = _timing.parse(sys.argv[1:] if argv is None else argv, DEFAULTS)
    B, T, V, K, L, reps, inner = (int(kv[k]) for k in ("B", "T", "V", "K", "L", "reps",
                                                        "inner"))
    if device.type != "cuda":
        raise SystemExit("bench_study_turns: times kernels; it needs the card")
    _, logits, lens = _timing.random_logits(B, T, V, device)
    fns = {"k7": lambda: pb.prefix_beam_search(logits, lens, K, 0, max_len=L),
           "k13": lambda: beam_cuda.prefix_beam_fused(logits, lens, K, 0, L),
           "k12": lambda: beam_cuda.prefix_beam_lanes_stepwise(logits, lens, K, 0, L)}
    out = {"device": _timing.device_name(device), "shape": [B, T, V, K, L],
           **{n: [] for n in fns}}
    for name in [*fns, *reversed(fns)]:
        out[name].append(_ms(fns[name], reps, inner))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
