"""BPE subword vocabulary training CLI of the port:

    python -m pytorch_asr_tpu_torch.train_bpe out.json [k=v ...]

Learns BPE merges (``data/bpe.py``) and writes the version-1 JSON vocab that
``data.vocab=bpe:out.json`` loads in either package (the JAX package's
``train_bpe`` writes the same file from the same text).

Keys:
  merges=N          number of BPE merges to learn (default 256; the final
                    vocab is chars + marker-chars + merges + blank/sos/eos)
  text=FILE         training text, one sentence per line
  librispeech_root=DIR  read transcripts from a LibriSpeech tree instead
  split=NAME        LibriSpeech split (default train-clean-100; pseudo-splits
                    such as train-960 resolve as in ``data/librispeech.py``)
  num_synthetic=N   synthetic sentences when neither source is given (512)
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    out_path = argv[0]
    kv = dict(a.split("=", 1) for a in argv[1:])

    if "text" in kv:
        with open(kv["text"], encoding="utf-8") as fh:
            texts = [ln.strip() for ln in fh if ln.strip()]
    elif "librispeech_root" in kv:
        from pytorch_asr_tpu_torch.data.librispeech import scan_manifest

        utts = scan_manifest(kv["librispeech_root"], kv.get("split", "train-clean-100"))
        texts = [u.transcript for u in utts]
    else:
        from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts

        texts = synthetic_texts(int(kv.get("num_synthetic", "512")))

    from pytorch_asr_tpu_torch.data.bpe import train_bpe

    tok = train_bpe(texts, num_merges=int(kv.get("merges", "256")))
    tok.save(out_path)
    n_tok = sum(len(tok.encode(t)) for t in texts)
    n_chr = sum(len(t) for t in texts)
    print(f"wrote {out_path}: pieces={len(tok.pieces)} "
          f"vocab_size={tok.vocab_size} sentences={len(texts)} "
          f"tokens/char={n_tok / max(n_chr, 1):.3f}")


if __name__ == "__main__":
    main()
