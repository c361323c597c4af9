"""Host reference CTC prefix beam search, the slow Python oracle the searches
are held to: the port's copy of ``pytorch_asr_tpu.decoding.prefix_beam_ref``
(numpy and plain Python).

Beams are a dict from prefix tuples to (p_blank, p_nonblank, LM score);
every frame each prefix continues by blank, by repeating its last token and
by each non-blank token, duplicates merge by log-sum-exp, and the
``beam_size`` best by fused score survive.  Shallow fusion adds
``lm_alpha * lm.score(prefix, c) + lm_beta`` a token, for any ``lm`` with
that method: ``decoding.lm.BackoffLM`` or ``models.lm_rnn.HostRNNLM``.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

NEG_INF = -math.inf


def _lse(*xs: float) -> float:
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


def prefix_beam_search_ref(
    logp: np.ndarray,            # (T, V) log-softmax
    logit_len: int,
    beam_size: int,
    blank: int = 0,
    lm=None,                     # BackoffLM or None
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
) -> list[int]:
    """Returns the best prefix (list of token ids)."""
    # beams: prefix tuple -> [p_blank, p_nonblank, lm_score]
    beams = {(): [0.0, NEG_INF, 0.0]}
    for t in range(logit_len):
        new: dict[tuple, list] = defaultdict(lambda: [NEG_INF, NEG_INF, 0.0])
        for prefix, (pb, pnb, lms) in beams.items():
            last = prefix[-1] if prefix else None
            total = _lse(pb, pnb)
            # same prefix via blank
            ent = new[prefix]
            ent[0] = _lse(ent[0], total + logp[t, blank])
            ent[2] = lms
            # same prefix via repeat of last char
            if last is not None:
                ent[1] = _lse(ent[1], pnb + logp[t, last])
            for c in range(len(logp[t])):
                if c == blank:
                    continue
                ext = prefix + (c,)
                lm_add = 0.0
                if lm is not None:
                    lm_add = lm_alpha * lm.score(prefix, c) + lm_beta
                e = new[ext]
                if c == last:
                    # extension must come via the blank path
                    contrib = pb + logp[t, c]
                else:
                    contrib = total + logp[t, c]
                e[1] = _lse(e[1], contrib)
                e[2] = lms + lm_add
        # prune to beam_size by fused score
        scored = sorted(new.items(), key=lambda kv: -(_lse(kv[1][0], kv[1][1]) + kv[1][2]))
        beams = dict(scored[:beam_size])
    best = max(beams.items(), key=lambda kv: _lse(kv[1][0], kv[1][1]) + kv[1][2])
    return list(best[0])
