"""WER/CER scoring: the port's copy of ``pytorch_asr_tpu.decoding.wer`` (pure Python)."""

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


def corpus_wer(refs: list[str], hyps: list[str]) -> float:
    errors, tokens = corpus_counts(refs, hyps, unit="word")
    return errors / max(tokens, 1)


def corpus_cer(refs: list[str], hyps: list[str]) -> float:
    errors, tokens = corpus_counts(refs, hyps, unit="char")
    return errors / max(tokens, 1)


def error_breakdown(ref: list, hyp: list) -> dict:
    """Full DP alignment with backtrace: substitutions / insertions /
    deletions / hits (a sclite-style report).  Ties prefer substitutions,
    then deletions."""
    R, H = len(ref), len(hyp)
    dist = [[0] * (H + 1) for _ in range(R + 1)]
    for i in range(1, R + 1):
        dist[i][0] = i
    for j in range(1, H + 1):
        dist[0][j] = j
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            dist[i][j] = min(dist[i - 1][j] + 1,          # deletion
                             dist[i][j - 1] + 1,          # insertion
                             dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]))
    sub = ins = dele = hits = 0
    i, j = R, H
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            sub += ref[i - 1] != hyp[j - 1]
            hits += ref[i - 1] == hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            dele += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return {"sub": sub, "ins": ins, "del": dele, "hits": hits, "ref_tokens": R}


def corpus_breakdown(refs: list[str], hyps: list[str], unit: str = "word") -> dict:
    """Corpus S/I/D totals and WER, plus each utterance's own rate (for
    worst-utterance reports)."""
    split = str.split if unit == "word" else list
    tot = {"sub": 0, "ins": 0, "del": 0, "hits": 0, "ref_tokens": 0}
    per_utt = []
    for r, h in zip(refs, hyps):
        b = error_breakdown(split(r), split(h))
        per_utt.append((b["sub"] + b["ins"] + b["del"]) / max(b["ref_tokens"], 1))
        for k in tot:
            tot[k] += b[k]
    n = max(tot["ref_tokens"], 1)
    tot["wer"] = (tot["sub"] + tot["ins"] + tot["del"]) / n
    tot["sub_rate"] = tot["sub"] / n
    tot["ins_rate"] = tot["ins"] / n
    tot["del_rate"] = tot["del"] / n
    tot["per_utt"] = per_utt
    return tot
