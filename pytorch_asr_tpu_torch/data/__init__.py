"""Data pipeline: tokenizer, LibriSpeech reader, synthetic corpus, bucketed
batching and the prefetching training stream.

``build_dataset`` reads ``data.librispeech_root`` lazily (manifest and
headers at start-up, one file decoded an access) or renders the synthetic
corpus when no root is set; across data ranks each reads its shard,
records ``[d::D]`` before bucketing as grain shards; ``eval_data_config`` names the split the
trainer and the decode, evaluate and align CLIs evaluate on, by the JAX
package's rule.
"""

from __future__ import annotations

import dataclasses

from pytorch_asr_tpu_torch.configs.base import DataConfig
from pytorch_asr_tpu_torch.data.batching import Bucket, BucketedDataset, corpus_shard
from pytorch_asr_tpu_torch.data.librispeech import load_corpus, scan_manifest
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus, synthetic_texts
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer, get_tokenizer

__all__ = [
    "Bucket",
    "BucketedDataset",
    "CharTokenizer",
    "build_dataset",
    "build_eval_dataset",
    "corpus_audio_lengths",
    "corpus_transcripts",
    "eval_data_config",
    "get_tokenizer",
    "load_corpus",
    "load_corpus_for",
    "resolve_buckets",
    "scan_manifest",
    "synthetic_corpus",
    "synthetic_texts",
]


def load_corpus_for(cfg: DataConfig, sample_rate: int, max_utts: int | None = None):
    """(audio, transcript) pairs for the configured source: a ``LazyCorpus``
    over ``cfg.split`` of ``cfg.librispeech_root`` (manifest-only start-up,
    one file decoded an access), else the synthetic corpus."""
    if cfg.librispeech_root:
        return load_corpus(cfg.librispeech_root, cfg.split, max_utts=max_utts,
                           subset_seed=cfg.subset_seed)
    return synthetic_corpus(
        max_utts or cfg.synthetic_num_utts, sample_rate, seed=cfg.shuffle_seed,
        min_sec=cfg.synthetic_min_sec or None,
        max_sec=cfg.synthetic_max_sec or None)


def corpus_audio_lengths(corpus) -> list[int]:
    """Per-utterance sample counts, without decoding where the corpus can
    (``LazyCorpus`` reads headers only); in-memory corpora just measure."""
    if hasattr(corpus, "audio_lengths"):
        return [int(n) for n in corpus.audio_lengths()]
    return [len(a) for a, _ in corpus]


def corpus_transcripts(corpus) -> list[str]:
    """Per-utterance transcripts, without decoding audio."""
    if hasattr(corpus, "transcript"):
        return [corpus.transcript(i) for i in range(len(corpus))]
    return [t for _, t in corpus]


def resolve_buckets(cfg: DataConfig, corpus, tokenizer):
    """Bucket ladders from the config, or optimized from the corpus length
    profile when ``cfg.auto_buckets > 0`` (``data/bucket_opt.py``); lazy
    corpora are profiled from their headers, never decoded."""
    if cfg.auto_buckets <= 0:
        return cfg.bucket_audio_lens, cfg.bucket_label_lens
    from pytorch_asr_tpu_torch.data.bucket_opt import optimize_buckets

    audio_lens = corpus_audio_lengths(corpus)
    label_lens = [len(tokenizer.encode(t)) for t in corpus_transcripts(corpus)]
    return optimize_buckets(audio_lens, label_lens, cfg.auto_buckets)


def build_dataset(cfg: DataConfig, sample_rate: int, max_utts: int | None = None,
                  num_shards: int = 1, shard_index: int = 0) -> BucketedDataset:
    """The bucketed dataset named by ``cfg`` (synthetic when no data root).

    With ``num_shards`` > 1 it holds records ``[shard_index::num_shards]``
    of the corpus, in batches of ``data.batch_size / num_shards``: a data
    rank's share of the global batch.  The bucket ladders are the whole
    corpus's, as the JAX package resolves them before grain shards the
    records, so every shard pads to the same shapes."""
    corpus = load_corpus_for(cfg, sample_rate, max_utts)
    tok = get_tokenizer(cfg.vocab)
    audio_b, label_b = resolve_buckets(cfg, corpus, tok)
    if cfg.batch_size % num_shards:
        raise ValueError(f"data.batch_size {cfg.batch_size} does not divide over "
                         f"{num_shards} data shards")
    return BucketedDataset(corpus_shard(corpus, shard_index, num_shards),
                           batch_size=cfg.batch_size // num_shards,
                           bucket_audio_lens=audio_b, bucket_label_lens=label_b,
                           tokenizer=tok)


def eval_data_config(cfg: DataConfig) -> DataConfig:
    """The data config to evaluate, decode and align on, by the JAX
    trainer's rule: ``eval_split`` when a LibriSpeech root is set and
    ``eval_split`` is set and differs from ``split``; else ``cfg`` itself
    (the training split, or the synthetic corpus)."""
    if cfg.librispeech_root and cfg.eval_split and cfg.eval_split != cfg.split:
        return dataclasses.replace(cfg, split=cfg.eval_split)
    return cfg


def build_eval_dataset(cfg: DataConfig, sample_rate: int) -> BucketedDataset:
    """``build_dataset`` of ``eval_data_config(cfg)``."""
    return build_dataset(eval_data_config(cfg), sample_rate)
