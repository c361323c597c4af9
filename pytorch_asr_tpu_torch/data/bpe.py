"""Subword (BPE) tokenizer trained in the framework: the port's copy of
``pytorch_asr_tpu.data.bpe`` (numpy and plain Python).

Classic byte-pair-encoding merges with the SentencePiece word-boundary
convention: every word-initial symbol carries the marker "▁", so decoding is
a plain concatenation with "▁" -> " ".

The id layout mirrors ``CharTokenizer``, so every consumer (CTC blank, LAS
sos/eos, LM training, beam search) works unchanged:

  0                 CTC blank (== padding)
  1 .. P            subword pieces
  P+1 (sos), P+2 (eos)

Merge ties are broken lexicographically, so the same corpus and
``num_merges`` give the same vocabulary on any host, and the JAX package's.
A vocabulary saved by either package (version-1 JSON) loads in the other.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np

MARKER = "▁"  # '▁' SentencePiece word-boundary marker

# Characters a transcript may contain after normalization (matches the
# CharTokenizer charset minus the space, which BPE encodes via MARKER).
_CHARSET = "abcdefghijklmnopqrstuvwxyz'"


def _normalize_words(text: str) -> list[str]:
    """Lowercase, strip characters outside the charset, split into words."""
    text = text.lower()
    cleaned = "".join(c if c in _CHARSET else " " for c in text)
    return cleaned.split()


def _word_symbols(word: str) -> tuple[str, ...]:
    """Base segmentation: marker-attached first char, then bare chars."""
    return (MARKER + word[0],) + tuple(word[1:])


def train_bpe(texts: list[str], num_merges: int,
              min_pair_freq: int = 2) -> "BPETokenizer":
    """Learn BPE merges from raw transcripts.

    Stops early when no adjacent pair occurs ``min_pair_freq`` times, so tiny
    corpora yield small vocabularies rather than degenerate merges.
    """
    word_freq: Counter[str] = Counter()
    for t in texts:
        word_freq.update(_normalize_words(t))
    # Work on the unique-word level, weighted by frequency.
    seqs: list[list[str]] = [list(_word_symbols(w)) for w in word_freq]
    freqs = list(word_freq.values())

    merges: list[tuple[str, str]] = []
    for _ in range(num_merges):
        pair_freq: Counter[tuple[str, str]] = Counter()
        for seq, f in zip(seqs, freqs):
            for a, b in zip(seq, seq[1:]):
                pair_freq[(a, b)] += f
        if not pair_freq:
            break
        # Max frequency; ties broken lexicographically for determinism.
        best = min(pair_freq.items(), key=lambda kv: (-kv[1], kv[0]))
        (a, b), f = best
        if f < min_pair_freq:
            break
        merges.append((a, b))
        ab = a + b
        for seq in seqs:
            i = 0
            while i < len(seq) - 1:
                if seq[i] == a and seq[i + 1] == b:
                    seq[i : i + 2] = [ab]
                else:
                    i += 1

    # Base pieces guarantee total coverage of any normalized text: every bare
    # char plus every marker-attached char (any word's first symbol).
    base = [MARKER + c for c in _CHARSET] + list(_CHARSET)
    pieces = base + [a + b for a, b in merges]
    return BPETokenizer(pieces, merges)


class BPETokenizer:
    """Same interface as ``CharTokenizer``: blank/sos/eos ids, encode/decode."""

    blank_id: int = 0

    def __init__(self, pieces: list[str], merges: list[tuple[str, str]]) -> None:
        if len(set(pieces)) != len(pieces):
            raise ValueError("duplicate pieces in BPE vocabulary")
        self.pieces = list(pieces)
        self.merges = [tuple(m) for m in merges]
        self._piece_to_id = {p: i + 1 for i, p in enumerate(self.pieces)}
        self._rank = {m: r for r, m in enumerate(self.merges)}
        self.sos_id = len(self.pieces) + 1
        self.eos_id = len(self.pieces) + 2
        self.vocab_size = len(self.pieces) + 3
        self._word_cache: dict[str, list[int]] = {}

    # -- encoding ---------------------------------------------------------

    def _encode_word(self, word: str) -> list[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        seq = list(_word_symbols(word))
        # Classic BPE application: repeatedly merge the lowest-rank pair.
        while len(seq) > 1:
            ranked = [
                (self._rank[(a, b)], i)
                for i, (a, b) in enumerate(zip(seq, seq[1:]))
                if (a, b) in self._rank
            ]
            if not ranked:
                break
            _, i = min(ranked)
            seq[i : i + 2] = [seq[i] + seq[i + 1]]
        ids = [self._piece_to_id[s] for s in seq]
        self._word_cache[word] = ids
        return ids

    def encode(self, text: str) -> np.ndarray:
        ids: list[int] = []
        for w in _normalize_words(text):
            ids.extend(self._encode_word(w))
        return np.asarray(ids, dtype=np.int32)

    # -- decoding ---------------------------------------------------------

    def decode(self, ids) -> str:
        parts = [self.pieces[int(i) - 1] for i in ids
                 if 1 <= int(i) <= len(self.pieces)]
        return "".join(parts).replace(MARKER, " ").strip()

    def decode_ctc(self, ids) -> str:
        """Collapse repeats then strip blanks (greedy CTC rule)."""
        out = []
        prev = -1
        for i in ids:
            i = int(i)
            if i != prev and i != self.blank_id:
                out.append(i)
            prev = i
        return self.decode(out)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": 1, "pieces": self.pieces,
                       "merges": [list(m) for m in self.merges]}, fh)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as fh:
            blob = json.load(fh)
        if blob.get("version") != 1:
            raise ValueError(f"unsupported BPE vocab version in {path!r}")
        return cls(blob["pieces"], [tuple(m) for m in blob["merges"]])
