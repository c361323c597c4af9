"""How decisive the card-vs-CPU search check of configs 4 and 5 is at several
scales of the seeded decoder's output rows, on one card:

    python -m pytorch_asr_tpu_torch.scripts.las_margin_probe [scales=16,48,96,128,192]

Run from the root of a checkout.  For each scale it runs
``chip_smoke.py::las_parity_phase`` of both configs with ``LAS_SHARPEN`` set
to it and its checks recorded instead of raised, and prints one JSON line:
each search's margins (best final score less the runner-up's, a row),
the rows inside ``LAS_MARGIN``, the rows whose tokens agree, the largest
relative score error and the best beams' lengths, with the checks that
failed.
"""

from __future__ import annotations

import json
import sys
import time

import torch


def main(argv: list[str] | None = None) -> None:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    import chip_smoke as cs

    fails: list[str] = []
    cs.check = lambda ok, msg: None if ok else fails.append(msg)
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    for scale in (float(s) for s in args.get("scales", "16,48,96,128,192").split(",")):
        cs.LAS_SHARPEN = scale
        for config in (cs.CFG4, cs.CFG5):
            fails.clear()
            t0 = time.perf_counter()
            rec = cs.las_parity_phase(config)
            keys = ("margins", "rows_inside_margin", "rows_equal", "score_max_rel_err", "lengths")
            out = {m: {k: rec[m][k] for k in keys}
                   for m in ("attention_beam", "joint_beam") if m in rec}
            print(json.dumps({"sharpen": scale, "config": config,
                              "s": time.perf_counter() - t0, **out, "fails": list(fails)}),
                  flush=True)


if __name__ == "__main__":
    main()
