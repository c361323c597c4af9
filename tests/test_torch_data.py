"""The port's own copies of the configs, tokenizer and data pipeline agree
with the JAX package's: same config values, same ids, same batches."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from pytorch_asr_tpu import configs as jax_configs
from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
from pytorch_asr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from pytorch_asr_tpu_torch import configs
from pytorch_asr_tpu_torch.data import build_dataset, synthetic_corpus
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer, get_tokenizer


@pytest.mark.parametrize("name", sorted(jax_configs.CONFIGS))
def test_configs_and_overrides_match_jax(name):
    overrides = {"model.encoder.hidden_dim": "64", "data.bucket_audio_lens": "16000,32000",
                 "frontend.normalize": "false", "train.seed": "7"}
    if name == "tcn_ctc_devclean":
        overrides.pop("model.encoder.hidden_dim")
    ours = dataclasses.asdict(configs.get_config(name, **overrides))
    ref = dataclasses.asdict(jax_configs.get_config(name, **overrides))
    assert ours == ref


def test_unknown_override_raises():
    with pytest.raises(KeyError, match="no_such"):
        configs.get_config("ctc_bilstm_dev1h", **{"model.no_such": "1"})


def test_tokenizer_matches_jax():
    text = "Hello world, it's a TEST"
    ours, ref = CharTokenizer(), JaxCharTokenizer()
    np.testing.assert_array_equal(ours.encode(text), ref.encode(text))
    assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    assert ours.vocab_size == ref.vocab_size == 31
    with pytest.raises(ValueError, match="bpe:<vocab.json>"):
        get_tokenizer("wordpiece")


@pytest.mark.parametrize("auto_buckets", [0, 6])
def test_synthetic_batches_match_jax(auto_buckets):
    overrides = {"data.synthetic_num_utts": "20", "data.auto_buckets": str(auto_buckets),
                 "data.batch_size": "4"}
    cfg = configs.get_config("ctc_bilstm_dev1h", **overrides).data
    jcfg = jax_configs.get_config("ctc_bilstm_dev1h", **overrides).data
    ours = list(build_dataset(cfg, 16000).epoch_batches(seed=0))
    ref = list(jax_build_dataset(jcfg, 16000).epoch_batches(seed=0))
    assert len(ours) == len(ref) > 1
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_librispeech_root_is_refused(tmp_path):
    """``data.librispeech_root`` is read, no longer refused: ``build_dataset``
    over a small WAV tree gives JAX's batches."""
    from pytorch_asr_tpu.data.synthetic import materialize_wav_tree

    materialize_wav_tree(synthetic_corpus(6, 16000, seed=3, max_sec=1.0), str(tmp_path))
    overrides = {"data.librispeech_root": str(tmp_path), "data.split": "dev-clean",
                 "data.batch_size": "4", "data.auto_buckets": "2"}
    cfg = configs.get_config("ctc_bilstm_dev1h", **overrides).data
    jcfg = jax_configs.get_config("ctc_bilstm_dev1h", **overrides).data
    ours = list(build_dataset(cfg, 16000).epoch_batches(seed=0))
    ref = list(jax_build_dataset(jcfg, 16000).epoch_batches(seed=0))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        build_dataset(dataclasses.replace(cfg, librispeech_root=str(tmp_path / "none")), 16000)
