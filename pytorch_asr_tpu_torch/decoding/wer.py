"""WER/CER counts: the port's copy of ``pytorch_asr_tpu.decoding.wer`` (pure Python)."""

from __future__ import annotations


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance with O(min) rows."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def corpus_counts(refs: list[str], hyps: list[str],
                  unit: str = "word") -> tuple[int, int]:
    """(total edit errors, total reference tokens) at word or char granularity."""
    split = str.split if unit == "word" else list
    errors = tokens = 0
    for r, h in zip(refs, hyps):
        r, h = split(r), split(h)
        errors += edit_distance(r, h)
        tokens += len(r)
    return errors, tokens
