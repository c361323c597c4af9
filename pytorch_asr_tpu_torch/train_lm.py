"""Char RNN LM training CLI of the port:

    python -m pytorch_asr_tpu_torch.train_lm out.npz [text=corpus.txt] [k=v ...] [device=cpu]

Trains a char LSTM LM for neural shallow fusion and saves it as ``.npz`` in
the JAX package's format (pass it as ``decode.lm_path=out.npz`` to the
``decode`` CLI of either package).  Runs on the GPU unless ``device=cpu``.

keys: text= (one transcript per line; default: ``synthetic_num_utts=256``
transcripts of the synthetic corpus), steps= (500), batch_size= (32),
max_len= (128), lr= (1e-3), seed= (0), log_every= (100), and the
``RNNLMConfig`` fields embed_dim= (128), hidden_dim= (256), num_layers= (2).
Unknown keys exit before training.  Prints ``lm_train`` JSON lines and a
last ``lm_saved`` line, and returns that record.
"""

from __future__ import annotations

import json
import math
import sys

from pytorch_asr_tpu_torch.models.lm_rnn import RNNLMConfig
from pytorch_asr_tpu_torch.runtime import resolve_device, set_fp32_math
from pytorch_asr_tpu_torch.training.lm import save_rnn_lm, train_rnn_lm


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    out_path = argv[0]
    kv = dict(a.split("=", 1) for a in argv[1:])
    device = resolve_device(kv.pop("device", "cuda"))

    text_path = kv.pop("text", "")
    if text_path:
        with open(text_path) as fh:
            texts = [line.strip() for line in fh if line.strip()]
    else:
        from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts

        texts = synthetic_texts(int(kv.pop("synthetic_num_utts", "256")),
                                seed=int(kv.get("seed", "0")))

    cfg = RNNLMConfig(embed_dim=int(kv.pop("embed_dim", "128")),
                      hidden_dim=int(kv.pop("hidden_dim", "256")),
                      num_layers=int(kv.pop("num_layers", "2")))
    steps = int(kv.pop("steps", "500"))
    train_kw = dict(batch_size=int(kv.pop("batch_size", "32")),
                    max_len=int(kv.pop("max_len", "128")), lr=float(kv.pop("lr", "1e-3")),
                    seed=int(kv.pop("seed", "0")), log_every=int(kv.pop("log_every", "100")))
    if kv:  # fail on mistyped keys before the training run
        raise SystemExit(f"unknown keys: {sorted(kv)}")

    set_fp32_math()
    model, nll = train_rnn_lm(texts, cfg, steps=steps, device=device, **train_kw)
    save_rnn_lm(out_path, model)
    record = {"event": "lm_saved", "path": out_path, "steps": steps, "num_texts": len(texts),
              "nll": nll, "ppl": math.exp(nll)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
