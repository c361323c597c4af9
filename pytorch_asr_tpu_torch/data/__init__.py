"""Data pipeline: tokenizer, synthetic corpus, bucketed batching.

The LibriSpeech/FLAC reader of the JAX package is not ported yet, so
``build_dataset`` refuses a ``librispeech_root``.
"""

from __future__ import annotations

from pytorch_asr_tpu_torch.configs.base import DataConfig
from pytorch_asr_tpu_torch.data.batching import Bucket, BucketedDataset
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus, synthetic_texts
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer, get_tokenizer

__all__ = [
    "Bucket",
    "BucketedDataset",
    "CharTokenizer",
    "build_dataset",
    "corpus_audio_lengths",
    "corpus_transcripts",
    "get_tokenizer",
    "resolve_buckets",
    "synthetic_corpus",
    "synthetic_texts",
]


def corpus_audio_lengths(corpus) -> list[int]:
    """Per-utterance sample counts of an in-memory (audio, transcript) corpus."""
    return [len(a) for a, _ in corpus]


def corpus_transcripts(corpus) -> list[str]:
    """Per-utterance transcripts of an in-memory (audio, transcript) corpus."""
    return [t for _, t in corpus]


def resolve_buckets(cfg: DataConfig, corpus, tokenizer):
    """Bucket ladders from the config, or optimized from the corpus length
    profile when ``cfg.auto_buckets > 0`` (data/bucket_opt.py)."""
    if cfg.auto_buckets <= 0:
        return cfg.bucket_audio_lens, cfg.bucket_label_lens
    from pytorch_asr_tpu_torch.data.bucket_opt import optimize_buckets

    audio_lens = corpus_audio_lengths(corpus)
    label_lens = [len(tokenizer.encode(t)) for t in corpus_transcripts(corpus)]
    return optimize_buckets(audio_lens, label_lens, cfg.auto_buckets)


def build_dataset(cfg: DataConfig, sample_rate: int) -> BucketedDataset:
    """The bucketed synthetic dataset named by ``cfg``."""
    if cfg.librispeech_root:
        raise NotImplementedError("the LibriSpeech reader is not ported yet: the port "
                                  "reads only the synthetic corpus; leave "
                                  "data.librispeech_root empty")
    corpus = synthetic_corpus(
        cfg.synthetic_num_utts, sample_rate, seed=cfg.shuffle_seed,
        min_sec=cfg.synthetic_min_sec or None,
        max_sec=cfg.synthetic_max_sec or None)
    tok = get_tokenizer(cfg.vocab)
    audio_b, label_b = resolve_buckets(cfg, corpus, tok)
    return BucketedDataset(corpus, batch_size=cfg.batch_size,
                           bucket_audio_lens=audio_b, bucket_label_lens=label_b,
                           tokenizer=tok)
