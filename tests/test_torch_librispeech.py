"""The port's LibriSpeech reader and lazy dataset against the JAX package's,
over a LibriSpeech-layout FLAC tree of utterances of 1.5 s or less.

Split names, manifests (unions, pseudo-splits and the missing-member
errors), seeded duration subsets, the bucket ladder from headers and every
batch of ``build_dataset`` (shuffled and SortaGrad) equal JAX's; building
the corpus, the dataset and the auto-bucket ladder decodes no audio; the
tree writers write JAX's WAV bytes and the same PCM in FLAC; ``train_bpe
librispeech_root=`` writes JAX's vocab.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from pytorch_asr_tpu import configs as jax_configs
from pytorch_asr_tpu import train_bpe as jax_train_bpe
from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
from pytorch_asr_tpu.data import librispeech as jax_ls
from pytorch_asr_tpu.data import synthetic as jax_synthetic
from pytorch_asr_tpu_torch import configs, native, train_bpe
from pytorch_asr_tpu_torch.data import (
    build_dataset,
    eval_data_config,
    load_corpus_for,
    resolve_buckets,
)
from pytorch_asr_tpu_torch.data import flac
from pytorch_asr_tpu_torch.data import librispeech as ls
from pytorch_asr_tpu_torch.data import synthetic
from pytorch_asr_tpu_torch.data.batching import BucketedDataset
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer

SR = 16000
WORDS = ("HELLO", "WORLD", "SPEECH", "MODEL", "TONES", "BEAM", "SEARCH", "DECODE")


def make_split(root: str, split: str, speakers, seed: int, utts: int = 3,
               sec_lo: float = 0.3, sec_hi: float = 1.5) -> dict:
    """A LibriSpeech-layout split of FLAC files; returns {utt_id: samples}."""
    rng = np.random.default_rng(seed)
    made = {}
    for spk in speakers:
        for chap in (10, 11):
            d = os.path.join(root, split, str(spk), str(chap))
            os.makedirs(d, exist_ok=True)
            lines = []
            for u in range(utts):
                utt_id = f"{spk}-{chap}-{u:04d}"
                n = int(rng.uniform(sec_lo, sec_hi) * SR)
                t = np.arange(n)
                pcm = np.clip((4000 * np.sin(t / (20.0 + u))).astype(np.int64)
                              + rng.integers(-200, 200, size=n), -32768, 32767)
                flac.write_flac(os.path.join(d, utt_id + ".flac"), pcm, SR)
                made[utt_id] = n
                words = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 5))))
                lines.append(f"{utt_id} {words}\n")
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as fh:
                fh.writelines(lines)
    return made


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("librispeech"))
    sizes = {}
    sizes.update(make_split(root, "train-clean-100", [19, 26], seed=1))
    sizes.update(make_split(root, "train-clean-360", [33], seed=2))
    sizes.update(make_split(root, "train-other-500", [41], seed=3))
    sizes.update(make_split(root, "dev-clean", [84, 174], seed=4))
    return root, sizes


SPLITS = ["train-clean-100", "train-960", "train-460", "dev-clean",
          "train-clean-100+dev-clean", "dev-clean-1h"]


def test_resolve_split_equals_jax():
    for name in SPLITS + ["a+b", "+a+", "test-other"]:
        assert ls.resolve_split(name) == jax_ls.resolve_split(name)
    assert ls.UNION_SPLITS == jax_ls.UNION_SPLITS
    assert ls.DURATION_SPLITS == jax_ls.DURATION_SPLITS


@pytest.mark.parametrize("split", SPLITS)
def test_scan_manifest_equals_jax(tree, split):
    root, _ = tree
    ours = ls.scan_manifest(root, split)
    ref = jax_ls.scan_manifest(root, split)
    assert len(ours) == len(ref) > 0
    assert [dataclasses.astuple(u) for u in ours] == [dataclasses.astuple(u) for u in ref]


def test_missing_members_raise_as_jax(tree, tmp_path):
    for root in (str(tmp_path), None):
        if root is None:        # a partial tree: one member of three
            root = str(tmp_path)
            os.makedirs(tmp_path / "train-clean-100" / "1" / "1")
        with pytest.raises(FileNotFoundError) as ours:
            ls.scan_manifest(root, "train-960")
        with pytest.raises(FileNotFoundError) as ref:
            jax_ls.scan_manifest(root, "train-960")
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed,cap", [(1, 3.0), (2, 3.0), (7, 5.5)])
def test_duration_subset_equals_jax(tree, seed, cap):
    root, sizes = tree
    utts = ls.scan_manifest(root, "dev-clean")
    native.reset_decodes()
    ours = ls._duration_subset(utts, cap, seed)
    assert native.DECODES == {"audio_decode_native": 0, "audio_decode_python": 0}
    ref = jax_ls._duration_subset(jax_ls.scan_manifest(root, "dev-clean"), cap, seed)
    assert [u.utt_id for u in ours] == [u.utt_id for u in ref]
    assert 0 < len(ours) < len(utts)
    assert sum(sizes[u.utt_id] for u in ours) / SR >= cap


def test_lazy_corpus_decodes_one_file_an_access(tree):
    root, sizes = tree
    native.reset_decodes()
    corpus = ls.load_corpus(root, "train-960")
    lens = corpus.audio_lengths()
    assert list(lens) == [sizes[u.utt_id] for u in corpus.utts]
    assert sum(native.DECODES.values()) == 0
    audio, text = corpus[0]
    assert sum(native.DECODES.values()) == 1
    assert len(audio) == lens[0] and corpus.transcript(0) == text
    ref_audio, ref_text = jax_ls.load_corpus(root, "train-960")[0]
    np.testing.assert_array_equal(audio, ref_audio)
    assert text == ref_text
    assert len(ls.load_corpus(root, "train-960", max_utts=5)) == 5


def _cfg(root: str, split: str, **extra):
    kw = {"data.librispeech_root": root, "data.split": split, "data.batch_size": "4",
          "data.bucket_audio_lens": "12000,24000", "data.bucket_label_lens": "40,60",
          **extra}
    return configs.get_config("ctc_bilstm_dev1h", **kw), \
        jax_configs.get_config("ctc_bilstm_dev1h", **kw)


@pytest.mark.parametrize("split,auto", [("train-960", "0"), ("train-960", "3"),
                                        ("dev-clean", "2"), ("dev-clean-1h", "0")])
def test_build_dataset_equals_jax_batch_for_batch(tree, split, auto):
    root, _ = tree
    cfg, jcfg = _cfg(root, split, **{"data.auto_buckets": auto})
    native.reset_decodes()
    ds = build_dataset(cfg.data, SR)
    assert sum(native.DECODES.values()) == 0
    ref = jax_build_dataset(jcfg.data, SR)
    assert [(b.audio_len, b.label_len) for b in ds.buckets] == \
        [(b.audio_len, b.label_len) for b in ref.buckets]
    assert ds.num_examples == ref.num_examples and ds.num_dropped == ref.num_dropped
    for seed, sort in ((0, False), (3, False), (0, True)):
        ours = list(ds.epoch_batches(seed, sort_by_length=sort))
        want = list(ref.epoch_batches(seed, sort_by_length=sort))
        assert len(ours) == len(want) > 0
        for a, b in zip(ours, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert native.DECODES["audio_decode_python"] == 0


def test_construction_and_auto_buckets_decode_nothing(tree):
    root, _ = tree
    cfg, _ = _cfg(root, "train-960", **{"data.auto_buckets": "3", "data.sortagrad": "true"})
    native.reset_decodes()
    corpus = load_corpus_for(cfg.data, SR)
    audio_b, label_b = resolve_buckets(cfg.data, corpus, CharTokenizer())
    ds = BucketedDataset(corpus, 4, audio_b, label_b)
    plan = ds.epoch_plan(0, sort_by_length=True)
    assert sum(native.DECODES.values()) == 0
    batch = ds.emit(*plan[0])
    assert sum(native.DECODES.values()) == int((batch["audio_len"] > 0).sum()) <= 4


def test_drop_too_long_as_jax(tree):
    root, sizes = tree
    corpus = ls.load_corpus(root, "dev-clean")
    cut = sorted(sizes[u.utt_id] for u in corpus.utts)[len(corpus) // 2]
    ds = BucketedDataset(corpus, 4, (cut,), (100,))
    assert ds.num_dropped == sum(sizes[u.utt_id] > cut for u in corpus.utts) > 0
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        BucketedDataset(corpus, 4, (cut,), (100,), drop_too_long=False)
    with pytest.raises(ValueError, match="no utterance fits any bucket"):
        BucketedDataset(corpus, 4, (10,), (100,))


def test_eval_data_config_follows_jax_rule(tree):
    root, _ = tree
    cfg, _ = _cfg(root, "train-clean-100", **{"data.eval_split": "dev-clean"})
    assert eval_data_config(cfg.data).split == "dev-clean"
    for kw in ({"data.eval_split": ""}, {"data.eval_split": "train-clean-100"}):
        cfg, _ = _cfg(root, "train-clean-100", **kw)
        assert eval_data_config(cfg.data) is cfg.data
    syn = configs.get_config("ctc_bilstm_dev1h", **{"data.eval_split": "dev-clean"})
    assert eval_data_config(syn.data) is syn.data


def test_tree_writers(tmp_path):
    corpus = synthetic.synthetic_corpus(3, SR, seed=5, max_sec=0.8)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    synthetic.materialize_wav_tree(corpus, ours, "dev-clean")
    jax_synthetic.materialize_wav_tree(corpus, ref, "dev-clean")
    for f in sorted(os.listdir(os.path.join(ref, "dev-clean", "1", "1"))):
        with open(os.path.join(ours, "dev-clean", "1", "1", f), "rb") as a, \
                open(os.path.join(ref, "dev-clean", "1", "1", f), "rb") as b:
            assert a.read() == b.read(), f
    synthetic.materialize_flac_tree(corpus, ours, "dev-other")
    wavs = ls.scan_manifest(ours, "dev-clean")
    flacs = ls.scan_manifest(ours, "dev-other")
    assert [u.transcript for u in flacs] == [t.upper() for _, t in corpus]
    for w, f in zip(wavs, flacs):
        np.testing.assert_array_equal(ls.read_wav(w.audio_path)[0], flac.read_flac(f.audio_path)[0])


def test_train_bpe_from_a_tree_equals_jax(tree, tmp_path):
    root, _ = tree
    for split in ("train-clean-100", "train-960"):
        argv = [f"librispeech_root={root}", f"split={split}", "merges=20"]
        train_bpe.main([str(tmp_path / "ours.json"), *argv])
        jax_train_bpe.main([str(tmp_path / "ref.json"), *argv])
        assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
