"""Training CLI of the port:

    python -m pytorch_asr_tpu_torch.train <config> [k=v ...] [device=cpu] [steps=N]
        [metrics_path=<file.jsonl>]

``k=v`` overrides read as in ``python -m pytorch_asr_tpu.train``.  Runs on the
GPU unless ``device=cpu``.  Trains in chunks of ``train.eval_every`` steps up
to ``steps`` (default ``train.optim.total_steps``), with a greedy eval on 8
batches after each chunk, and resumes from the newest checkpoint in
``train.checkpoint_dir``.  ``tb_dir`` and ``init_from_torch`` are not ported
yet and raise.
"""

from __future__ import annotations

import sys

from pytorch_asr_tpu_torch.configs import CONFIGS, get_config


def parse_args(argv: list[str]):
    """-> (config, steps or None, runtime keyword arguments of ``Trainer``)."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("configs:", ", ".join(sorted(CONFIGS)))
        raise SystemExit(0)
    overrides = dict(a.split("=", 1) for a in argv[1:])
    steps = int(overrides.pop("steps", "0")) or None
    runtime = {
        "metrics_path": overrides.pop("metrics_path", None),
        "tensorboard_dir": overrides.pop("tb_dir", None),
        "init_from_torch": overrides.pop("init_from_torch", None),
        "device": overrides.pop("device", "cuda"),
    }
    return get_config(argv[0], **overrides), steps, runtime


def main(argv: list[str] | None = None) -> dict:
    """Returns the last train record and the last eval result."""
    from pytorch_asr_tpu_torch.training.trainer import Trainer

    cfg, steps, runtime = parse_args(sys.argv[1:] if argv is None else argv)
    trainer = Trainer(cfg, **runtime)
    last = {"train": {}, "eval": {}}
    try:
        total = steps or cfg.train.optim.total_steps
        while trainer.state.step < total:
            chunk = min(cfg.train.eval_every, total - trainer.state.step)
            last["train"] = trainer.train(num_steps=chunk)
            last["eval"] = trainer.evaluate(max_batches=8)
    finally:
        trainer.close()
    return last


if __name__ == "__main__":
    main()
