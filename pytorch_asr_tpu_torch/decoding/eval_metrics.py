"""Hypothesis collection + metric reduction for greedy eval (single process).

Counterpart of ``pytorch_asr_tpu.decoding.eval_metrics`` with the same metric
names; the cross-process count sum waits for the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np

from pytorch_asr_tpu_torch.decoding.wer import corpus_counts


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
    """Corpus WER/CER, utterance count and decode real-time factor."""
    werr, wtok = corpus_counts(refs, hyps, unit="word")
    cerr, ctok = corpus_counts(refs, hyps, unit="char")
    return {
        "wer": float(werr / max(wtok, 1)),
        "cer": float(cerr / max(ctok, 1)),
        "num_utts": len(refs),
        "decode_rtf": float(wall_s / max(audio_sec, 1e-9)),
    }
