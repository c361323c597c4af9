"""Synthetic learnable ASR corpus: the port's copy of ``pytorch_asr_tpu.data.synthetic``.

Each character is rendered as a fixed-duration tone whose frequency identifies
the character, plus noise.  The same seed gives the same corpus as the JAX
package (both draw from ``np.random.default_rng``).
"""

from __future__ import annotations

import numpy as np

from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer

_WORDS = (
    "the quick brown fox jumps over lazy dog speech model learns tones "
    "hello world open source jax pallas kernel beam search decode train"
).split()

CHAR_TONE_SEC = 0.08   # 80 ms per character
_BASE_HZ = 220.0
_STEP_HZ = 110.0


def render_text(text: str, sample_rate: int, rng: np.random.Generator) -> np.ndarray:
    """Render text as a sequence of per-character tones + background noise."""
    ids = CharTokenizer().encode(text)
    n_per = int(CHAR_TONE_SEC * sample_rate)
    t = np.arange(n_per, dtype=np.float32) / sample_rate
    segs = []
    for i in ids:
        freq = _BASE_HZ + _STEP_HZ * float(i)
        phase = rng.uniform(0, 2 * np.pi)
        segs.append(np.sin(2 * np.pi * freq * t + phase).astype(np.float32))
    audio = np.concatenate(segs) if segs else np.zeros(n_per, dtype=np.float32)
    audio += rng.normal(0, 0.05, size=audio.shape).astype(np.float32)
    return audio


def synthetic_corpus(
    num_utts: int,
    sample_rate: int,
    seed: int = 0,
    min_words: int = 2,
    max_words: int = 8,
    min_sec: float | None = None,
    max_sec: float | None = None,
) -> list[tuple[np.ndarray, str]]:
    """Deterministic list of (audio, transcript) pairs.

    ``min_sec``/``max_sec`` override the word-count range with a target
    duration range (duration = chars * CHAR_TONE_SEC, ~6 chars/word).
    """
    if min_sec is not None or max_sec is not None:
        per_word = (sum(len(w) for w in _WORDS) / len(_WORDS) + 1) * CHAR_TONE_SEC
        if min_sec is not None:
            min_words = max(1, round(min_sec / per_word))
        if max_sec is not None:
            max_words = max(min_words, round(max_sec / per_word))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_utts):
        n = int(rng.integers(min_words, max_words + 1))
        text = " ".join(rng.choice(_WORDS) for _ in range(n))
        out.append((render_text(text, sample_rate, rng), text))
    return out
