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


class CorpusShard:
    """Records ``[index::count]`` of a corpus, as grain's
    ``ds[shard_index::num_shards]`` takes a host's shard: a view that reads
    the corpus only as it is read."""

    def __init__(self, corpus, index: int, count: int) -> None:
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        self._corpus = corpus
        self.indices = range(index, len(corpus), count)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self._corpus[self.indices[i]]


class LazyCorpusShard(CorpusShard):
    """A ``CorpusShard`` of a lazy corpus (``data/librispeech.py::LazyCorpus``):
    header lengths and transcripts without decoding, as the corpus gives them."""

    def audio_lengths(self) -> np.ndarray:
        return np.asarray(self._corpus.audio_lengths())[np.asarray(self.indices, np.int64)]

    def transcript(self, i: int) -> str:
        return self._corpus.transcript(self.indices[i])


def corpus_shard(corpus, index: int, count: int):
    """Records ``[index::count]`` of ``corpus``; the corpus itself for one shard."""
    if count == 1:
        return corpus
    lazy = hasattr(corpus, "audio_lengths") and hasattr(corpus, "transcript")
    return (LazyCorpusShard if lazy else CorpusShard)(corpus, index, count)


class BucketedDataset:
    """Tokenizes, buckets and batches a corpus of (audio, transcript) pairs.

    ``epoch_batches(seed)`` reshuffles per epoch; iteration order interleaves
    buckets deterministically given the seed, and every utterance appears
    exactly once per epoch (final partial batches are zero-padded rows).

    RAM stays bounded for lazy corpora (``data/librispeech.py::LazyCorpus``):
    construction reads header lengths and transcripts only, and audio decodes
    one batch at a time during iteration (``epoch_plan`` orders the batches
    without decoding; ``emit`` decodes one of them).  An utterance longer
    than the largest bucket is dropped (counted in ``num_dropped``), or with
    ``drop_too_long=False`` raises.
    """

    def __init__(
        self,
        corpus: Sequence[tuple[np.ndarray, str]],
        batch_size: int,
        bucket_audio_lens: Sequence[int],
        bucket_label_lens: Sequence[int],
        tokenizer: CharTokenizer | None = None,
        drop_too_long: bool = True,
    ) -> None:
        from pytorch_asr_tpu_torch.data import corpus_audio_lengths, corpus_transcripts

        self.tokenizer = tokenizer or CharTokenizer()
        self.batch_size = batch_size
        self.buckets = make_buckets(bucket_audio_lens, bucket_label_lens)
        self._corpus = corpus
        # per bucket: (corpus index, audio samples, encoded tokens)
        self.per_bucket: list[list[tuple[int, int, np.ndarray]]] = [
            [] for _ in self.buckets
        ]
        self.num_dropped = 0
        audio_lens = corpus_audio_lengths(corpus)
        texts = corpus_transcripts(corpus)
        for i, (alen, text) in enumerate(zip(audio_lens, texts)):
            toks = self.tokenizer.encode(text)
            bi = assign_bucket(self.buckets, int(alen), len(toks))
            if bi is None:
                if drop_too_long:
                    self.num_dropped += 1
                    continue
                raise ValueError(
                    f"utterance of {alen} samples / {len(toks)} labels "
                    f"exceeds the largest bucket {self.buckets[-1]}")
            self.per_bucket[bi].append((i, int(alen), toks))
        self.num_examples = sum(len(b) for b in self.per_bucket)
        if self.num_examples == 0 and len(corpus) > 0:
            raise ValueError(
                f"no utterance fits any bucket: all {self.num_dropped} "
                f"utterances exceed the largest bucket {self.buckets[-1]} "
                f"(audio samples x label chars); raise bucket_audio_lens / "
                f"bucket_label_lens")

    def epoch_plan(self, seed: int = 0, sort_by_length: bool = False
                   ) -> list[tuple[int, list[tuple[int, int, np.ndarray]]]]:
        """One epoch's batches as (bucket, [(corpus index, samples, tokens)]),
        in order, with no audio decoded.  ``sort_by_length`` gives the
        SortaGrad ordering (ascending audio length, no shuffle: Deep Speech
        2's first-epoch curriculum).  Every epoch has the same number of
        batches."""
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
        return pending

    def emit(self, bi: int, chunk: list[tuple[int, int, np.ndarray]],
             decode_map=map) -> dict[str, np.ndarray]:
        """The batch of one ``epoch_plan`` entry; its audio is read (decoded,
        for a lazy corpus) through ``decode_map(fn, indices)``, e.g. a thread
        pool's ``map``."""
        audios = decode_map(lambda i: np.asarray(self._corpus[i][0], np.float32),
                            [i for i, _alen, _toks in chunk])
        examples = [(a, toks) for a, (_i, _alen, toks) in zip(audios, chunk)]
        return _emit(examples, self.buckets[bi], self.batch_size)

    def epoch_batches(self, seed: int = 0,
                      sort_by_length: bool = False) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of batches (``epoch_plan``'s order), decoded one batch
        at a time."""
        for bi, chunk in self.epoch_plan(seed, sort_by_length):
            yield self.emit(bi, chunk)

    def repeat_batches(self, seed: int = 0, sortagrad: bool = False
                       ) -> Iterator[dict[str, np.ndarray]]:
        """Epoch after epoch, epoch e shuffled with ``seed + e``; with
        ``sortagrad`` the first epoch is length-sorted."""
        epoch = 0
        while True:
            yield from self.epoch_batches(seed + epoch,
                                          sort_by_length=sortagrad and epoch == 0)
            epoch += 1
