"""Hypothesis collection + metric reduction for eval and decode, over one
rank or many: the counterpart of ``pytorch_asr_tpu.decoding.eval_metrics``
with the same metric names.  Each rank scores the rows it decoded and one
count-sum over the ranks gives the corpus metrics.
"""

from __future__ import annotations

import numpy as np

from pytorch_asr_tpu_torch.decoding.wer import corpus_counts
from pytorch_asr_tpu_torch.parallel.distributed import sum_across_processes


def local_hyps_refs(tokenizer, batch: dict, ids, lens, sample_rate: int):
    """(refs, hyps, audio_seconds) for one decoded batch; ``batch`` holds the
    host arrays (tokens, token_len, audio_len), ``ids``/``lens`` the decoded
    output.  Padding rows (audio_len 0) are skipped."""
    ids, lens = np.asarray(ids), np.asarray(lens)
    alen = np.asarray(batch["audio_len"])
    refs, hyps = [], []
    for b in np.where(alen > 0)[0]:
        hyps.append(tokenizer.decode(ids[b, : lens[b]]))
        refs.append(tokenizer.decode(batch["tokens"][b, : batch["token_len"][b]]))
    return refs, hyps, float(alen.sum()) / sample_rate


def reduce_decode_metrics(refs, hyps, audio_sec: float, wall_s: float) -> dict:
    """Corpus WER/CER, utterance count and decode real-time factor from every
    rank's refs and hyps, by one count-sum (every rank calls it once per
    eval; a rank whose rows another rank scores passes none).  Counts reduce
    as integers, exactly; audio seconds as float64 and only feed the RTF of
    this rank's wall time."""
    werr, wtok = corpus_counts(refs, hyps, unit="word")
    cerr, ctok = corpus_counts(refs, hyps, unit="char")
    g = sum_across_processes(np.asarray([werr, wtok, cerr, ctok, len(refs)], np.int64))
    a = sum_across_processes(np.asarray([audio_sec], np.float64))
    return {
        "wer": float(g[0] / max(g[1], 1)),
        "cer": float(g[2] / max(g[3], 1)),
        "num_utts": int(g[4]),
        "decode_rtf": float(wall_s / max(a[0], 1e-9)),
    }
