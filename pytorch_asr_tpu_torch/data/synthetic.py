"""Synthetic learnable ASR corpus: the port's copy of ``pytorch_asr_tpu.data.synthetic``.

Each character is rendered as a fixed-duration tone whose frequency identifies
the character, plus noise.  The same seed gives the same corpus as the JAX
package (both draw from ``np.random.default_rng``).  ``materialize_wav_tree``
and ``materialize_flac_tree`` write a corpus as a LibriSpeech-layout tree on
disk, for the file-backed data path.
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


def materialize_wav_tree(corpus, root: str, split: str = "dev-clean",
                         sample_rate: int = 16000) -> str:
    """Write (audio, transcript) pairs as a LibriSpeech-layout WAV tree
    (16-bit PCM mono, transcripts upper-cased), as the JAX package's
    function of this name writes it: ``root/<split>/1/1/1-1-<i>.wav`` and
    ``1-1.trans.txt``.  Lets tests and the chip smoke test drive the
    file-backed path (``librispeech.load_corpus`` -> ``LazyCorpus`` ->
    on-demand decode) without LibriSpeech on disk.  Returns ``root``."""
    import os
    import wave

    d = os.path.join(root, split, "1", "1")
    os.makedirs(d, exist_ok=True)
    lines = []
    for i, (audio, text) in enumerate(corpus):
        utt_id = f"1-1-{i:04d}"
        pcm = np.clip(np.asarray(audio, np.float32) * 32767.0,
                      -32768, 32767).astype("<i2")
        with wave.open(os.path.join(d, utt_id + ".wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
        lines.append(f"{utt_id} {text.upper()}\n")
    with open(os.path.join(d, "1-1.trans.txt"), "w") as fh:
        fh.writelines(lines)
    return root


def flac_pcm(audio, bps: int = 16) -> np.ndarray:
    """The int64 PCM ``materialize_flac_tree`` encodes for ``audio``: scaled
    by 2^(bps-1) - 1 and clipped (at 16 bits the WAV tree's samples)."""
    lim = 1 << (bps - 1)
    pcm = np.clip(np.asarray(audio, np.float32) * float(lim - 1), -lim, lim - 1)
    return pcm.astype(np.int64)


def _write_flac_utt(job: tuple) -> None:
    from pytorch_asr_tpu_torch.data.flac import write_flac

    path, audio, sample_rate, kw = job
    write_flac(path, flac_pcm(audio, kw.get("bps", 16)), sample_rate, **kw)


def materialize_flac_tree(corpus, root: str, split: str = "dev-clean",
                          sample_rate: int = 16000, flac_kw=None, pool=None) -> str:
    """``materialize_wav_tree``'s layout in FLAC: ``root/<split>/1/1/1-1-<i>.flac``
    with ``1-1.trans.txt`` (transcripts upper-cased, as LibriSpeech's are),
    encoded by the port's ``write_flac``.  Samples are ``flac_pcm(audio,
    bps)``; an audio of shape (N, 2) makes a stereo file.  ``flac_kw(i)``
    gives file i's ``write_flac`` keywords, e.g. ``{"subframe":
    "lpc", "order": 8, "lpc_coefs": [...]}`` or ``{"bps": 24}``.  The encoder
    is pure Python (about 1 s a core for 15 s of 16 kHz audio): ``pool``, an executor
    such as a process pool, spreads the files over its workers (its ``map``
    runs them).  Returns ``root``."""
    import os

    d = os.path.join(root, split, "1", "1")
    os.makedirs(d, exist_ok=True)
    jobs, lines = [], []
    for i, (audio, text) in enumerate(corpus):
        utt_id = f"1-1-{i:04d}"
        kw = flac_kw(i) if flac_kw else {}
        jobs.append((os.path.join(d, utt_id + ".flac"), audio, sample_rate, kw))
        lines.append(f"{utt_id} {text.upper()}\n")
    list((pool.map if pool is not None else map)(_write_flac_utt, jobs))
    with open(os.path.join(d, "1-1.trans.txt"), "w") as fh:
        fh.writelines(lines)
    return root


def synthetic_texts(num: int, seed: int = 0, min_words: int = 2,
                    max_words: int = 8) -> list[str]:
    """Transcripts only (no audio rendering), e.g. for LM training; the same
    texts as the JAX package's ``synthetic_texts`` for the same seed."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS)
                     for _ in range(int(rng.integers(min_words, max_words + 1))))
            for _ in range(num)]
