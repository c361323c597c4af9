"""Character tokenizer: the port's copy of ``pytorch_asr_tpu.data.tokenizer``.

Vocabulary layout (CTC-compatible):
  0            : CTC blank
  1..27        : ' ' a-z
  28           : apostrophe
  29 (sos)     : LAS start-of-sequence (never emitted by CTC)
  30 (eos)     : LAS end-of-sequence
"""

from __future__ import annotations

import numpy as np

_CHARS = " abcdefghijklmnopqrstuvwxyz'"


def get_tokenizer(vocab: str = "char") -> "CharTokenizer":
    """Tokenizer for ``DataConfig.vocab``.  The port reads only ``"char"``;
    BPE vocabularies wait for the slice that ports ``data/bpe.py``."""
    if vocab == "char":
        return CharTokenizer()
    raise NotImplementedError(f"vocab {vocab!r}: BPE is not ported yet; the port "
                              "reads only 'char'")


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
