"""Forced-alignment CLI of the port (counterpart of ``python -m pytorch_asr_tpu.align``):

    python -m pytorch_asr_tpu_torch.align <config> [k=v ...] [device=cpu]
        [max_batches=N] [dump_path=<file.tsv>]

Aligns each utterance's reference transcript to its frames with the CTC
Viterbi pass (``decoding/align.py``) and writes one segment a line:

    utt<TAB>token<TAB>start_sec<TAB>end_sec

to ``dump_path`` (default stdout).  Frame times count the frontend's hop and
the encoder's subsampling (the BiLSTM's time strides, the TCN's
``subsample``).  ``k=v`` overrides read as in ``python -m
pytorch_asr_tpu_torch.train``; the weights are the newest checkpoint in
``train.checkpoint_dir`` (its EMA copy when kept), else drawn from
``train.seed``.  The utterances are the trainer's eval dataset, as the JAX
CLI's: ``data.eval_split`` of a LibriSpeech tree (``data.librispeech_root``)
when it is set and differs from ``data.split``, else the training data.
``max_batches`` stops after that many batches.
Runs on the GPU unless ``device=cpu``: the encoder and head go through K1 and
K2 (K5 for the TCN), the Viterbi pass through torch.  Returns {"segments",
"utts", "frame_sec"}.
"""

from __future__ import annotations

import sys

import torch

from pytorch_asr_tpu_torch import train


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    own = {k: v for k, v in (a.split("=", 1) for a in argv[1:]) if k in ("dump_path",
                                                                       "max_batches")}
    rest = argv[:1] + [a for a in argv[1:] if a.split("=", 1)[0] not in own]
    cfg, _steps, runtime = train.parse_args(rest)
    max_batches = int(own["max_batches"]) if "max_batches" in own else None
    from pytorch_asr_tpu_torch.decoding.align import ctc_forced_align
    from pytorch_asr_tpu_torch.evaluate import model_outputs
    from pytorch_asr_tpu_torch.training.state import eval_params
    from pytorch_asr_tpu_torch.training.trainer import Trainer

    trainer = Trainer(cfg, **runtime)
    model, tok = eval_params(trainer.state), trainer.eval_dataset.tokenizer

    # seconds per encoder frame = hop * (input frames / encoder frames)
    hop_sec = cfg.frontend.hop_length / cfg.frontend.sample_rate
    sub = 1
    enc = cfg.model.encoder
    if enc.kind == "bilstm":
        for _ in enc.conv_channels:
            sub *= enc.conv_stride[0]
    elif enc.kind == "tcn":
        sub = enc.subsample
    frame_sec = hop_sec * sub

    lines = []
    utt = 0
    try:
        with torch.inference_mode():
            for i, host_batch in enumerate(trainer.eval_dataset.epoch_batches(seed=0)):
                if max_batches is not None and i >= max_batches:
                    break
                out = model_outputs(model, host_batch)
                dev = out["ctc_logits"].device
                res = ctc_forced_align(out["ctc_logits"], out["enc_len"],
                                       torch.from_numpy(host_batch["tokens"]).to(dev),
                                       torch.from_numpy(host_batch["token_len"]).to(dev))
                starts, ends = res["starts"].cpu().numpy(), res["ends"].cpu().numpy()
                for b in range(len(host_batch["audio_len"])):
                    if host_batch["audio_len"][b] <= 0:
                        continue
                    for j in range(int(host_batch["token_len"][b])):
                        ch = tok.decode([int(host_batch["tokens"][b, j])])
                        lines.append(f"utt{utt:06d}\t{ch}\t{starts[b, j] * frame_sec:.3f}\t"
                                     f"{ends[b, j] * frame_sec:.3f}")
                    utt += 1
    finally:
        trainer.close()
    text = "\n".join(lines) + "\n"
    dump_path = own.get("dump_path")
    if dump_path:
        with open(dump_path, "w") as fh:
            fh.write(text)
        print(f"wrote {len(lines)} segments ({utt} utts) to {dump_path}")
    else:
        sys.stdout.write(text)
    return {"segments": len(lines), "utts": utt, "frame_sec": frame_sec}


if __name__ == "__main__":
    main()
