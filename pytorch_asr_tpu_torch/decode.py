"""Decode CLI of the port:

    python -m pytorch_asr_tpu_torch.decode <config> [k=v ...] [device=cpu]
        [params=<file.npz>] [max_batches=N] [dump_path=<prefix>]

``k=v`` overrides read as in ``python -m pytorch_asr_tpu.decode``.  Runs on
the GPU unless ``device=cpu``.  The weights come from ``params`` when given,
else from the newest checkpoint in ``train.checkpoint_dir`` when there is
one (its EMA copy when kept), else they are drawn from ``train.seed``.
``decode.method`` is ``greedy``, ``prefix_beam`` (the CTC prefix beam
search), ``attention_beam`` (the LAS decoder's beam search, configs 4 and 5)
or ``joint_beam`` (the same with the CTC prefix scorer at weight
``decode.joint_ctc_weight``, config 5); the beam searches take dense n-gram
shallow fusion when ``decode.lm_path=<file.arpa>``, e.g. one written by
``python -m pytorch_asr_tpu_torch.train_ngram``, or char RNN-LM fusion when
``decode.lm_path=<file.npz>``, one written by ``python -m
pytorch_asr_tpu_torch.train_lm`` or the JAX package's CLI.
``dump_path`` writes ``<prefix>.ref.tsv`` and ``<prefix>.hyp.tsv`` for
``python -m pytorch_asr_tpu_torch.eval_wer`` (beam methods).  Prints the
result dict, with the run's ``world_size`` and ``dist_backend``.  The
utterances are those the JAX CLI decodes: ``data.eval_split`` of a
LibriSpeech tree (``data.librispeech_root``) when it is set and differs from
``data.split``, else ``data.split`` (or the synthetic corpus).

Over several ranks, one process each, started by torchrun:

    torchrun --nproc_per_node=2 -m pytorch_asr_tpu_torch.decode ctc_bilstm_beam_lm \
        decode.lm_path=<lm> decode.shard_beams=true mesh.model_axis=2
    torchrun --nproc_per_node=4 -m pytorch_asr_tpu_torch.decode ctc_bilstm_beam_lm \
        decode.lm_path=<lm> decode.shard_beams=true mesh.data_axis=2 mesh.model_axis=2

Utterances shard over the mesh's data axis; with ``decode.shard_beams`` each
utterance's beams shard over its model axis, and with a model axis of 2 the
BiLSTM's two directions run on the two model ranks.  Each rank runs on
``cuda:{LOCAL_RANK % device_count}``; ranks talk over NCCL when each has a
card of its own, else over gloo (on the CPU, or ranks sharing a card).
Rank 0 prints; ``dump_path`` is written per rank as
``<prefix>.p<rank>.{ref,hyp}.tsv``.
"""

from __future__ import annotations

import sys

from pytorch_asr_tpu_torch.configs import CONFIGS, get_config
from pytorch_asr_tpu_torch.parallel import distributed

METHODS = ("greedy", "prefix_beam", "attention_beam", "joint_beam")


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
        raise ValueError(f"unknown decode.method={cfg.decode.method!r}: one of "
                         f"{', '.join(METHODS)}")
    return cfg, runtime


def main(argv: list[str] | None = None) -> dict:
    from pytorch_asr_tpu_torch.decoding.driver import decode_dataset
    from pytorch_asr_tpu_torch.evaluate import build_model, evaluate
    from pytorch_asr_tpu_torch.training.checkpoint import restore_eval_weights

    cfg, runtime = parse_args(sys.argv[1:] if argv is None else argv)
    topo = distributed.initialize(runtime["device"])
    model = build_model(cfg, runtime["device"], runtime["params"])
    step = restore_eval_weights(cfg, model) if runtime["params"] is None else None
    if cfg.decode.method == "greedy":
        result = evaluate(cfg, model, max_batches=runtime["max_batches"])
        if step is not None:
            result["step"] = step
    else:
        result = decode_dataset(cfg, model, max_batches=runtime["max_batches"],
                                dump_path=runtime["dump_path"], step=step)
    result.update(world_size=topo["world_size"], dist_backend=topo["dist_backend"])
    if distributed.is_primary():
        print(result)
    return result


if __name__ == "__main__":
    main()
