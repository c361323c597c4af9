"""The eval split: with a LibriSpeech-layout tree holding ``train-clean-100``
and ``dev-clean`` and ``data.eval_split=dev-clean``, the port's
``Trainer.eval_dataset``, ``decode.main`` and ``align.main`` read the
utterances, in the order, that the JAX package's trainer evaluates, decodes
and aligns (``Trainer.eval_dataset``, ``pytorch_asr_tpu/decode.py``,
``pytorch_asr_tpu/align.py``); without an eval split they read the training
split, as JAX's do.
"""

from __future__ import annotations

import threading

import pytest
import torch

from pytorch_asr_tpu import configs as jax_configs
from pytorch_asr_tpu.data import librispeech as jax_ls
from pytorch_asr_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_asr_tpu_torch import align, configs, decode
from pytorch_asr_tpu_torch.data import librispeech as ls
from pytorch_asr_tpu_torch.training.trainer import Trainer
from tests.test_torch_librispeech import make_split


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("librispeech"))
    make_split(root, "train-clean-100", [19, 26], seed=21)
    make_split(root, "dev-clean", [84, 174], seed=22, utts=2)
    return root


def _overrides(root: str, eval_split: str) -> dict:
    return {"data.librispeech_root": root, "data.split": "train-clean-100",
            "data.eval_split": eval_split, "data.batch_size": "3",
            "data.bucket_audio_lens": "12000,24000", "data.bucket_label_lens": "40,60",
            "model.encoder.hidden_dim": "8", "model.encoder.num_layers": "1",
            "model.encoder.conv_channels": "2,2", "model.encoder.use_pallas": "false",
            "frontend.use_pallas": "false", "model.compute_dtype": "float32"}


@pytest.fixture
def reads(monkeypatch):
    """The audio paths each package's lazy corpus decodes on this thread."""
    got = {"jax": [], "port": []}
    main = threading.current_thread()
    for key, mod in (("jax", jax_ls), ("port", ls)):
        real = mod.LazyCorpus.__getitem__

        def recording(self, idx, real=real, key=key):
            if threading.current_thread() is main:
                got[key].append(self.utts[int(idx)].audio_path)
            return real(self, idx)

        monkeypatch.setattr(mod.LazyCorpus, "__getitem__", recording)
    return got


def _jax_eval_paths(root: str, eval_split: str, reads: dict) -> list[str]:
    """The utterances JAX's evaluate, decode and align read: its trainer's
    ``eval_dataset`` in ``epoch_batches(seed=0)`` order."""
    jcfg = jax_configs.get_config("ctc_bilstm_dev1h", **_overrides(root, eval_split))
    with JaxTrainer(jcfg, enable_checkpoints=False) as jtrainer:
        reads["jax"].clear()
        list(jtrainer.eval_dataset.epoch_batches(seed=0))
    return list(reads["jax"])


@pytest.mark.parametrize("eval_split", ["dev-clean", ""])
def test_trainer_decode_and_align_read_jax_eval_utterances(tree, tmp_path, reads, eval_split):
    want = _jax_eval_paths(tree, eval_split, reads)
    split = eval_split or "train-clean-100"
    assert sorted(want) == sorted(u.audio_path for u in ls.scan_manifest(tree, split))
    over = _overrides(tree, eval_split)
    argv = ["ctc_bilstm_dev1h", *(f"{k}={v}" for k, v in over.items()), "device=cpu",
            f"train.checkpoint_dir={tmp_path / 'ck'}"]

    with Trainer(configs.get_config("ctc_bilstm_dev1h", **over), device="cpu",
                 enable_checkpoints=False) as trainer:
        assert (trainer.eval_dataset is trainer.dataset) == (not eval_split)
        reads["port"].clear()
        result = trainer.evaluate()
    assert reads["port"] == want and result["num_utts"] == len(want)

    reads["port"].clear()
    result = decode.main(argv)
    assert reads["port"] == want and result["num_utts"] == len(want)

    reads["port"].clear()
    result = align.main([*argv, f"dump_path={tmp_path / 'segs.tsv'}"])
    assert reads["port"] == want and result["utts"] == len(want)
