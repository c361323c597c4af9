"""n-gram LM training CLI of the port:

    python -m pytorch_asr_tpu_torch.train_ngram out.arpa [k=v ...]

Builds an interpolated modified Kneser-Ney char LM and writes standard ARPA,
which ``python -m pytorch_asr_tpu_torch.decode ... decode.lm_path=out.arpa``
loads (and so does the JAX package's decode CLI: the text is the same).

Keys:
  text=FILE        training text, one sentence per line (default: the
                   synthetic corpus transcripts)
  order=N          n-gram order (default 4)
  eos=true         append eos to every sentence
  heldout=FILE     optional held-out text; reports per-char perplexity
  num_synthetic=N  synthetic sentences when text= is not given (default 512)
"""

from __future__ import annotations

import sys


def _read_lines(path: str) -> list[str]:
    with open(path) as fh:
        return [ln.strip().lower() for ln in fh if ln.strip()]


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    out_path = argv[0]
    kv = dict(a.split("=", 1) for a in argv[1:])

    from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
    from pytorch_asr_tpu_torch.decoding import lm as lm_mod

    texts = (_read_lines(kv["text"]) if "text" in kv
             else synthetic_texts(int(kv.get("num_synthetic", "512"))))
    order = int(kv.get("order", "4"))
    include_eos = kv.get("eos", "false").lower() in ("1", "true", "yes")
    lm = lm_mod.train_char_ngram_kn(texts, order=order, include_eos=include_eos)
    lm_mod.write_arpa(lm, out_path)
    print(f"wrote {out_path}: order={order} ngrams={len(lm.logprobs)} "
          f"sentences={len(texts)}")
    if "heldout" in kv:
        print(f"held-out per-char perplexity: "
              f"{lm_mod.perplexity(lm, _read_lines(kv['heldout'])):.3f}")


if __name__ == "__main__":
    main()
