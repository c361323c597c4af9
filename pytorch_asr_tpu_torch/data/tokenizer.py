"""Character tokenizer: the port's copy of ``pytorch_asr_tpu.data.tokenizer``.

Vocabulary layout (CTC-compatible):
  0            : CTC blank
  1..27        : ' ' a-z
  28           : apostrophe
  29 (sos)     : LAS start-of-sequence (never emitted by CTC)
  30 (eos)     : LAS end-of-sequence
"""

from __future__ import annotations

import functools

import numpy as np

_CHARS = " abcdefghijklmnopqrstuvwxyz'"


@functools.lru_cache(maxsize=16)
def get_tokenizer(vocab: str = "char"):
    """Tokenizer for ``DataConfig.vocab``, cached by the string as the JAX
    package caches it:

    ``"char"``        -> the char vocabulary below
    ``"bpe:<path>"``  -> the subword tokenizer of the JSON vocab at <path>
                         (``python -m pytorch_asr_tpu_torch.train_bpe``;
                         ``data/bpe.py``)
    """
    if vocab == "char":
        return CharTokenizer()
    if vocab.startswith("bpe:"):
        from pytorch_asr_tpu_torch.data.bpe import BPETokenizer

        return BPETokenizer.load(vocab[len("bpe:"):])
    raise ValueError(
        f"unsupported vocab {vocab!r}: expected 'char' or 'bpe:<vocab.json>'")


class CharTokenizer:
    blank_id: int = 0

    def __init__(self) -> None:
        self._char_to_id = {c: i + 1 for i, c in enumerate(_CHARS)}
        self._id_to_char = {i + 1: c for i, c in enumerate(_CHARS)}
        self.sos_id = len(_CHARS) + 1
        self.eos_id = len(_CHARS) + 2
        # blank + chars + sos + eos, so one output head serves CTC and LAS.
        self.vocab_size = len(_CHARS) + 3

    def encode(self, text: str) -> np.ndarray:
        text = text.lower()
        ids = [self._char_to_id[c] for c in text if c in self._char_to_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self._id_to_char.get(int(i), "") for i in ids)

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
