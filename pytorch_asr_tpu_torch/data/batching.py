"""Length-bucketed batching: the port's copy of ``pytorch_asr_tpu.data.batching``.

Batches are plain dicts of numpy arrays:
    audio      (B, A)  float32   zero-padded waveform
    audio_len  (B,)    int32     valid samples
    tokens     (B, L)  int32     zero-padded label ids (0 is CTC blank == pad)
    token_len  (B,)    int32     valid labels
The batch dim is padded to full batch_size (pad rows have audio_len=token_len=0).
Bucketing bounds the number of distinct shapes a run sees; the same seed gives
the same batches, in the same order, as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer


@dataclass(frozen=True)
class Bucket:
    audio_len: int
    label_len: int


def assign_bucket(buckets: Sequence[Bucket], audio_len: int, label_len: int) -> int | None:
    """Smallest bucket that fits both lengths; None if the utterance is too long."""
    for i, b in enumerate(buckets):
        if audio_len <= b.audio_len and label_len <= b.label_len:
            return i
    return None


def make_buckets(audio_lens: Sequence[int], label_lens: Sequence[int]) -> list[Bucket]:
    if len(audio_lens) != len(label_lens):
        raise ValueError("bucket_audio_lens and bucket_label_lens must have equal length")
    return [Bucket(a, l) for a, l in zip(audio_lens, label_lens)]


def _emit(examples: list[tuple[np.ndarray, np.ndarray]], bucket: Bucket,
          batch_size: int) -> dict[str, np.ndarray]:
    B = batch_size
    audio = np.zeros((B, bucket.audio_len), dtype=np.float32)
    audio_len = np.zeros((B,), dtype=np.int32)
    tokens = np.zeros((B, bucket.label_len), dtype=np.int32)
    token_len = np.zeros((B,), dtype=np.int32)
    for i, (a, t) in enumerate(examples):
        audio[i, : len(a)] = a
        audio_len[i] = len(a)
        tokens[i, : len(t)] = t
        token_len[i] = len(t)
    return {"audio": audio, "audio_len": audio_len, "tokens": tokens, "token_len": token_len}


class BucketedDataset:
    """Tokenizes, buckets and batches an in-memory corpus of (audio, transcript) pairs.

    ``epoch_batches(seed)`` reshuffles per epoch; iteration order interleaves
    buckets deterministically given the seed, and every utterance appears
    exactly once per epoch (final partial batches are zero-padded rows).
    """

    def __init__(
        self,
        corpus: Sequence[tuple[np.ndarray, str]],
        batch_size: int,
        bucket_audio_lens: Sequence[int],
        bucket_label_lens: Sequence[int],
        tokenizer: CharTokenizer | None = None,
    ) -> None:
        self.tokenizer = tokenizer or CharTokenizer()
        self.batch_size = batch_size
        self.buckets = make_buckets(bucket_audio_lens, bucket_label_lens)
        self._corpus = corpus
        # per bucket: (corpus index, audio samples, encoded tokens)
        self.per_bucket: list[list[tuple[int, int, np.ndarray]]] = [
            [] for _ in self.buckets
        ]
        self.num_dropped = 0
        for i, (audio, text) in enumerate(corpus):
            toks = self.tokenizer.encode(text)
            bi = assign_bucket(self.buckets, len(audio), len(toks))
            if bi is None:
                self.num_dropped += 1
                continue
            self.per_bucket[bi].append((i, len(audio), toks))
        self.num_examples = sum(len(b) for b in self.per_bucket)
        if self.num_examples == 0 and len(corpus) > 0:
            raise ValueError(
                f"no utterance fits any bucket: all {self.num_dropped} "
                f"utterances exceed the largest bucket {self.buckets[-1]} "
                f"(audio samples x label chars); raise bucket_audio_lens / "
                f"bucket_label_lens")

    def epoch_batches(self, seed: int = 0,
                      sort_by_length: bool = False) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of batches.  ``sort_by_length`` yields the SortaGrad
        ordering (ascending audio length, no shuffle: Deep Speech 2's
        first-epoch curriculum)."""
        rng = np.random.default_rng(seed)
        pending: list[tuple[int, list[tuple[int, int, np.ndarray]]]] = []
        for bi, examples in enumerate(self.per_bucket):
            if sort_by_length:
                order = np.argsort([alen for _, alen, _ in examples], kind="stable")
            else:
                order = rng.permutation(len(examples))
            for start in range(0, len(examples), self.batch_size):
                chunk = [examples[j] for j in order[start : start + self.batch_size]]
                pending.append((bi, chunk))
        if sort_by_length:
            # ascending by the longest utterance actually in the batch
            pending.sort(key=lambda bc: max(alen for _, alen, _ in bc[1]))
        else:
            rng.shuffle(pending)  # interleave buckets
        for bi, chunk in pending:
            examples = [(np.asarray(self._corpus[i][0], np.float32), toks)
                        for i, _alen, toks in chunk]
            yield _emit(examples, self.buckets[bi], self.batch_size)

    def repeat_batches(self, seed: int = 0, sortagrad: bool = False
                       ) -> Iterator[dict[str, np.ndarray]]:
        """Epoch after epoch, epoch e shuffled with ``seed + e``; with
        ``sortagrad`` the first epoch is length-sorted."""
        epoch = 0
        while True:
            yield from self.epoch_batches(seed + epoch,
                                          sort_by_length=sortagrad and epoch == 0)
            epoch += 1
