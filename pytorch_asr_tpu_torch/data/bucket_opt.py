"""Optimal bucket-ladder design from a corpus length profile: the port's
copy of ``pytorch_asr_tpu.data.bucket_opt`` (same ladders for the same corpus).

Given the utterance length distribution and a bucket budget K, dynamic
programming picks the K boundaries minimizing total padded samples.

Cost model: every utterance pads to the smallest bucket boundary >= its
length, so for sorted lengths l_1..l_n split into K contiguous groups, the
cost of a group ending at index j is sum over the group of (l_j - l_i).
This is the classic 1-D K-segmentation; n distinct lengths are first
collapsed to (length, count) pairs, so the DP is O(K * u^2) in the number of
unique lengths u (histogram-quantized to keep u bounded).

Label ladders follow the same boundaries by taking the max label length
observed per bucket (plus headroom) -- label padding is cheap (int32 tokens)
next to audio samples, so it never drives the split.
"""

from __future__ import annotations

import numpy as np


def optimize_buckets(
    audio_lens,                  # per-utterance audio lengths (samples)
    label_lens,                  # per-utterance label lengths (tokens)
    num_buckets: int,
    quantize: int = 1600,        # length resolution (0.1 s at 16 kHz)
    label_headroom: float = 1.25,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Returns (bucket_audio_lens, bucket_label_lens), ascending."""
    audio_lens = np.asarray(audio_lens, np.int64)
    label_lens = np.asarray(label_lens, np.int64)
    if audio_lens.size == 0:
        raise ValueError("empty corpus")
    K = max(1, min(num_buckets, len(np.unique(audio_lens))))

    # quantize lengths UP so every utterance still fits its bucket
    q = max(int(quantize), 1)
    ql = ((audio_lens + q - 1) // q) * q
    uniq, counts = np.unique(ql, return_counts=True)      # ascending
    u = len(uniq)
    csum_n = np.concatenate([[0], np.cumsum(counts)])
    csum_l = np.concatenate([[0], np.cumsum(counts * uniq)])

    def seg_cost(i: int, j: int) -> float:
        """Padding cost of one bucket covering uniq[i..j] (inclusive)."""
        n = csum_n[j + 1] - csum_n[i]
        tot = csum_l[j + 1] - csum_l[i]
        return float(n * uniq[j] - tot)

    INF = float("inf")
    dp = np.full((K + 1, u), INF)
    back = np.zeros((K + 1, u), np.int64)
    for j in range(u):
        dp[1, j] = seg_cost(0, j)
    for k in range(2, K + 1):
        for j in range(k - 1, u):
            best, arg = INF, k - 2
            for i in range(k - 2, j):
                c = dp[k - 1, i] + seg_cost(i + 1, j)
                if c < best:
                    best, arg = c, i
            dp[k, j] = best
            back[k, j] = arg
    # recover boundaries
    bounds = []
    j = u - 1
    for k in range(K, 0, -1):
        bounds.append(int(uniq[j]))
        j = int(back[k, j])
    bounds = tuple(sorted(bounds))

    # label ladder: max label length observed per audio bucket + headroom,
    # rounded to 8 (sublane-friendly), monotone non-decreasing
    lab = []
    prev_b = -1
    running = 8
    for b in bounds:
        in_bucket = (ql > prev_b) & (ql <= b)
        m = int(label_lens[in_bucket].max()) if in_bucket.any() else running
        m = int(np.ceil(m * label_headroom / 8) * 8)
        running = max(running, m)
        lab.append(running)
        prev_b = b
    return bounds, tuple(lab)


def padding_efficiency(audio_lens, bucket_audio_lens) -> float:
    """valid audio / padded bucket capacity for a ladder (dropping misfits)."""
    audio_lens = np.asarray(audio_lens, np.int64)
    bounds = np.asarray(sorted(bucket_audio_lens), np.int64)
    idx = np.searchsorted(bounds, audio_lens, side="left")
    fits = idx < len(bounds)
    if not fits.any():
        return 0.0
    padded = bounds[idx[fits]].sum()
    return float(audio_lens[fits].sum()) / float(padded)
