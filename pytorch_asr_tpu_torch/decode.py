"""Greedy-CTC decode CLI of the port:

    python -m pytorch_asr_tpu_torch.decode <config> [k=v ...] [device=cpu]
        [params=<file.npz>] [max_batches=N]

``k=v`` overrides read as in ``python -m pytorch_asr_tpu.decode``.  Runs on
the GPU unless ``device=cpu``; without ``params`` the weights are drawn from
``train.seed``.  Prints the result dict (wer, cer, num_utts, decode_rtf).
"""

from __future__ import annotations

import sys

from pytorch_asr_tpu_torch.configs import CONFIGS, get_config


def parse_args(argv: list[str]):
    """-> (config, {"device", "params", "max_batches"})."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("configs:", ", ".join(sorted(CONFIGS)))
        raise SystemExit(0)
    overrides = dict(a.split("=", 1) for a in argv[1:])
    max_batches = overrides.pop("max_batches", None)
    runtime = {
        "device": overrides.pop("device", "cuda"),
        "params": overrides.pop("params", None),
        "max_batches": int(max_batches) if max_batches is not None else None,
    }
    cfg = get_config(argv[0], **overrides)
    if cfg.decode.method != "greedy":
        raise ValueError(f"decode.method={cfg.decode.method!r}: the port decodes "
                         "greedy CTC only so far")
    return cfg, runtime


def main(argv: list[str] | None = None) -> dict:
    from pytorch_asr_tpu_torch.evaluate import build_model, evaluate

    cfg, runtime = parse_args(sys.argv[1:] if argv is None else argv)
    model = build_model(cfg, runtime["device"], runtime["params"])
    result = evaluate(cfg, model, max_batches=runtime["max_batches"])
    print(result)
    return result


if __name__ == "__main__":
    main()
