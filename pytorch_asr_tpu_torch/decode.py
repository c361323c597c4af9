"""Decode CLI of the port:

    python -m pytorch_asr_tpu_torch.decode <config> [k=v ...] [device=cpu]
        [params=<file.npz>] [max_batches=N] [dump_path=<prefix>]

``k=v`` overrides read as in ``python -m pytorch_asr_tpu.decode``.  Runs on
the GPU unless ``device=cpu``.  The weights come from ``params`` when given,
else from the newest checkpoint in ``train.checkpoint_dir`` when there is
one (its EMA copy when kept), else they are drawn from ``train.seed``.
``decode.method`` is ``greedy`` or ``prefix_beam`` (the CTC prefix beam
search, with dense n-gram shallow fusion when ``decode.lm_path=<file.arpa>``,
e.g. one written by ``python -m pytorch_asr_tpu_torch.train_ngram``, or char
RNN-LM fusion when ``decode.lm_path=<file.npz>``, one written by
``python -m pytorch_asr_tpu_torch.train_lm`` or the JAX package's CLI).
``dump_path`` writes ``<prefix>.ref.tsv`` and ``<prefix>.hyp.tsv`` for
``python -m pytorch_asr_tpu_torch.eval_wer`` (beam methods).  Prints the
result dict.
"""

from __future__ import annotations

import sys

from pytorch_asr_tpu_torch.configs import CONFIGS, get_config

METHODS = ("greedy", "prefix_beam")


def parse_args(argv: list[str]):
    """-> (config, {"device", "params", "max_batches", "dump_path"})."""
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
        "dump_path": overrides.pop("dump_path", None),
    }
    cfg = get_config(argv[0], **overrides)
    if cfg.decode.method not in METHODS:
        raise ValueError(f"decode.method={cfg.decode.method!r}: the port decodes "
                         f"{' and '.join(METHODS)} so far")
    return cfg, runtime


def main(argv: list[str] | None = None) -> dict:
    from pytorch_asr_tpu_torch.decoding.driver import decode_dataset
    from pytorch_asr_tpu_torch.evaluate import build_model, evaluate
    from pytorch_asr_tpu_torch.training.checkpoint import restore_eval_weights

    cfg, runtime = parse_args(sys.argv[1:] if argv is None else argv)
    model = build_model(cfg, runtime["device"], runtime["params"])
    step = restore_eval_weights(cfg, model) if runtime["params"] is None else None
    if cfg.decode.method == "greedy":
        result = evaluate(cfg, model, max_batches=runtime["max_batches"])
        if step is not None:
            result["step"] = step
    else:
        result = decode_dataset(cfg, model, max_batches=runtime["max_batches"],
                                dump_path=runtime["dump_path"], step=step)
    print(result)
    return result


if __name__ == "__main__":
    main()
