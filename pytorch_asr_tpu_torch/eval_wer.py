"""Standalone WER/CER scoring CLI of the port:

    python -m pytorch_asr_tpu_torch.eval_wer ref.tsv hyp.tsv [detail=N]

Scores two line-aligned transcript files (such as the ``dump_path`` files of
``python -m pytorch_asr_tpu_torch.decode``) and prints one JSON line:
{"wer": ..., "cer": ..., "num_utts": ...}.  Lines may start with an
utterance id (``id<TAB>text``); ids are matched when both files have them,
otherwise lines pair by position.

``detail=N`` adds a substitution/insertion/deletion breakdown to the JSON and
prints the N worst utterances (ref vs hyp) to stderr.
"""

from __future__ import annotations

import json
import sys

from pytorch_asr_tpu_torch.decoding.wer import corpus_breakdown, corpus_cer, corpus_wer


def _read(path: str) -> tuple[list[str], list[str] | None]:
    texts, ids = [], []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if "\t" in line:
                uid, _, text = line.partition("\t")
                ids.append(uid)
                texts.append(text)
            else:
                ids.append("")
                texts.append(line)
    return texts, ids if all(ids) else None


def score(ref_path: str, hyp_path: str, detail: int = 0) -> dict:
    refs, ref_ids = _read(ref_path)
    hyps, hyp_ids = _read(hyp_path)
    if ref_ids and hyp_ids:
        hyp_map = dict(zip(hyp_ids, hyps))
        missing = [i for i in ref_ids if i not in hyp_map]
        if missing:
            raise SystemExit(f"eval_wer: {len(missing)} reference ids missing "
                             f"from hypotheses (first: {missing[0]!r})")
        hyps = [hyp_map[i] for i in ref_ids]
    elif len(refs) != len(hyps):
        raise SystemExit(f"eval_wer: line-count mismatch ({len(refs)} refs vs "
                         f"{len(hyps)} hyps) and no utterance ids to align by")
    out = {"wer": corpus_wer(refs, hyps), "cer": corpus_cer(refs, hyps),
           "num_utts": len(refs)}
    if detail:
        b = corpus_breakdown(refs, hyps)
        per_utt = b.pop("per_utt")
        out.update({k: b[k] for k in ("sub", "ins", "del", "sub_rate", "ins_rate",
                                      "del_rate", "ref_tokens")})
        for i in sorted(range(len(refs)), key=lambda i: -per_utt[i])[:detail]:
            uid = ref_ids[i] if ref_ids else str(i)
            print(f"[{uid}] wer={per_utt[i]:.3f}\n  REF: {refs[i]}\n  HYP: {hyps[i]}",
                  file=sys.stderr)
    return out


def main(argv: list[str] | None = None) -> dict:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2 or args[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if args and args[0] in ("-h", "--help") else 2)
    kv = dict(a.split("=", 1) for a in args[2:])
    result = score(args[0], args[1], int(kv.get("detail", "0")))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
