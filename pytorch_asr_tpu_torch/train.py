"""Training CLI of the port:

    python -m pytorch_asr_tpu_torch.train <config> [k=v ...] [device=cpu] [steps=N]
        [metrics_path=<file.jsonl>] [tb_dir=<dir>]

``k=v`` overrides read as in ``python -m pytorch_asr_tpu.train``.  Runs on the
GPU unless ``device=cpu``.  Trains in chunks of ``train.eval_every`` steps up
to ``steps`` (default ``train.optim.total_steps``), with a greedy eval on 8
batches after each chunk, and resumes from the newest checkpoint in
``train.checkpoint_dir``.  With ``data.librispeech_root=<tree>`` it trains on
``data.split`` of a LibriSpeech-layout tree (pseudo-splits such as
``train-960`` resolve to their members) and evaluates on ``data.eval_split``,
e.g.

    python -m pytorch_asr_tpu_torch.train ctc_bilstm_dev1h \
        data.librispeech_root=/data/LibriSpeech data.split=train-960 \
        data.eval_split=dev-clean

``tb_dir`` mirrors the metrics to TensorBoard (needs the ``tensorboard``
package); ``train.remat_encoder=true`` recomputes the encoder's activations
in the backward.  ``init_from_torch`` is not ported yet and raises.

Across ranks, one job:

    torchrun --nproc_per_node=N -m pytorch_asr_tpu_torch.train <config> \
        [mesh.data_axis=D] [mesh.model_axis=M]

(from Python, ``parallel.launch.spawn(train.main, N, argv)``).  Each data
row of the mesh trains on its shard of the corpus, ``data.batch_size`` is
the global batch, and the step is JAX's on it; the model axis splits a
bidirectional BiLSTM's directions (M = 2) or the TCN's blocks (M dividing
the channels), and any other model axis raises ``NotImplementedError``
before the first step.  Rank 0 logs, writes the checkpoints and prints.
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
