"""The port's config-2 serving slice on the CPU against the JAX package: a
tiny ``ctc_bilstm_beam_lm`` (H 32, one layer, batch 4) with the same weights
(through ``weights.py``) and the same ARPA file decodes to the same
hypotheses, WER and CER on the same decode ladder; and the CLIs
(``decode``, ``train_ngram``, ``eval_wer``) run end to end."""

from __future__ import annotations

import ast
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_asr_tpu import native
from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
from pytorch_asr_tpu.decoding import driver as jax_driver
from pytorch_asr_tpu.training.state import eval_params as jax_eval_params
from pytorch_asr_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_asr_tpu_torch import decode, eval_wer, evaluate, train_ngram, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.decoding import driver
from pytorch_asr_tpu_torch.training.trainer import Trainer

TINY = {"model.encoder.hidden_dim": "32", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
        "model.compute_dtype": "float32", "frontend.specaugment": "false",
        "data.batch_size": "4", "data.synthetic_num_utts": "8",
        "data.synthetic_max_sec": "2.5"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "syn4.arpa"
    train_ngram.main([str(path), "num_synthetic=256"])
    return str(path)


def _overrides(arpa, **extra):
    return {**TINY, "decode.lm_path": arpa, **extra}


@pytest.fixture(scope="module")
def jax_run(arpa, tmp_path_factory):
    """JAX ``Trainer.decode_eval`` of the tiny config 2 with a 2-bucket decode
    ladder (one scan compile a bucket), and its eval weights."""
    out = tmp_path_factory.mktemp("jax")
    cfg = jax_get_config("ctc_bilstm_beam_lm", **_overrides(arpa, **{"decode.auto_buckets": "2"}))
    trainer = JaxTrainer(cfg, dataset=jax_build_dataset(cfg.data, cfg.frontend.sample_rate),
                         enable_checkpoints=False)
    # The JAX driver expands ARPA with its C++ helper when that is built;
    # the helper floors the <s>/</s> columns (tests/test_torch_lm.py), so the
    # reference here takes its own tensorize, as the port does.
    available = native.available
    native.available = lambda: False
    try:
        result = trainer.decode_eval(dump_path=str(out / "d"))
    finally:
        native.available = available
    params = jax.tree.map(np.asarray, jax_eval_params(trainer.state))
    return result, params, out / "d"


def test_ladder_matches_jax(arpa):
    cfg = get_config("ctc_bilstm_beam_lm", **_overrides(arpa))
    jcfg = jax_get_config("ctc_bilstm_beam_lm", **_overrides(arpa))
    assert cfg.decode.auto_buckets == 14
    jtrainer = JaxTrainer(jcfg, dataset=jax_build_dataset(jcfg.data, jcfg.frontend.sample_rate),
                          enable_checkpoints=False)
    jds, jeff = jax_driver._decode_dataset_with_ladder(jtrainer)
    ds, eff = driver.decode_ladder(cfg, build_dataset(cfg.data, cfg.frontend.sample_rate))
    assert eff == jeff
    assert [(b.audio_len, b.label_len) for b in ds.buckets] == \
        [(b.audio_len, b.label_len) for b in jds.buckets]
    for ours, ref in zip(ds.epoch_batches(seed=0), jds.epoch_batches(seed=0)):
        assert ours.keys() == ref.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], ref[k])


def test_decode_dataset_matches_jax_decode_eval(arpa, jax_run, tmp_path):
    ref, params, jax_dump = jax_run
    cfg = get_config("ctc_bilstm_beam_lm", **_overrides(arpa, **{"decode.auto_buckets": "2"}))
    model = evaluate.build_model(cfg, "cpu", weights.load_jax_params(params))
    got = driver.decode_dataset(cfg, model, dump_path=str(tmp_path / "d"), step=ref["step"])
    assert set(got) == set(ref) == {"method", "wer", "cer", "num_utts", "decode_rtf", "step",
                                    "padding_efficiency_decode"}
    for key in ("method", "wer", "cer", "num_utts", "step", "padding_efficiency_decode"):
        assert got[key] == ref[key], key
    for suffix in (".ref.tsv", ".hyp.tsv"):
        assert (tmp_path / f"d{suffix}").read_text() == \
            jax_dump.with_name(f"d{suffix}").read_text()
    assert got["num_utts"] == 8


def test_trainer_decode_eval_routes_by_method(arpa, jax_run):
    ref, params, _ = jax_run
    cfg = get_config("ctc_bilstm_beam_lm", **_overrides(arpa, **{"decode.auto_buckets": "2"}))
    with Trainer(cfg, enable_checkpoints=False, device="cpu") as trainer:
        trainer.state.model.load_state_dict(weights.load_jax_params(params))
        beam = trainer.decode_eval()
        trainer.cfg = get_config("ctc_bilstm_beam_lm", **_overrides(
            arpa, **{"decode.method": "greedy"}))
        greedy = trainer.decode_eval()
    assert beam["method"] == "prefix_beam" and beam["wer"] == ref["wer"]
    assert "method" not in greedy and greedy["num_utts"] == 8


def test_decode_without_lm(arpa):
    """No ``decode.lm_path``: the search runs with alpha = beta = 0 and no
    table, on every row of the batch."""
    cfg = get_config("ctc_bilstm_beam_lm", **{**TINY, "decode.auto_buckets": "2"})
    result = driver.decode_dataset(cfg, evaluate.build_model(cfg, "cpu"), max_batches=1)
    assert result["method"] == "prefix_beam" and result["num_utts"] >= 1


@pytest.mark.parametrize("key,value,err", [
    ("data.librispeech_root", "/nonexistent", FileNotFoundError)])
def test_later_slices_raise(arpa, key, value, err):
    """The LibriSpeech reader is ported: a root with no such split raises
    ``FileNotFoundError``, as the JAX package's reader does
    (tests/test_torch_librispeech.py); ``decode.lm_backend=hashed`` is ported
    (tests/test_torch_prefix_beam_hashed.py)."""
    cfg = get_config("ctc_bilstm_beam_lm", **_overrides(arpa, **{key: value}))
    with pytest.raises(err):
        driver.decode_dataset(cfg, evaluate.build_model(cfg, "cpu"), max_batches=1)


@pytest.mark.parametrize("method", ["joint_beam", "attention_beam"])
def test_attention_methods_decode_through_the_driver(arpa, method, tmp_path):
    """The LAS model's attention and joint beam searches, with the 4-gram's
    dense table fused, over every batch of the tiny corpus on its decode
    ladder."""
    cfg = get_config("las_attention", **_overrides(arpa, **{
        "decode.method": method, "decode.auto_buckets": "2", "decode.beam_size": "3",
        "decode.max_decode_len": "8", "model.decoder.embed_dim": "8",
        "model.decoder.hidden_dim": "16", "model.decoder.attention_dim": "8",
        "model.decoder.location_kernel": "5", "model.decoder.location_filters": "2"}))
    result = driver.decode_dataset(cfg, evaluate.build_model(cfg, "cpu"),
                                   dump_path=str(tmp_path / "d"))
    assert result["method"] == method and result["num_utts"] == 8
    assert np.isfinite(result["wer"]) and result["decode_rtf"] > 0
    hyps = (tmp_path / "d.hyp.tsv").read_text().splitlines()
    assert len(hyps) == 8 and all(len(h.split("\t", 1)[1]) <= 8 for h in hyps)


def test_decode_cli_beam_dump_and_eval_wer(arpa, tmp_path, capsys):
    argv = ["ctc_bilstm_beam_lm", *(f"{k}={v}" for k, v in TINY.items()), "device=cpu",
            f"decode.lm_path={arpa}", "decode.ext_top_a=4", f"dump_path={tmp_path / 'd'}",
            "max_batches=2", f"train.checkpoint_dir={tmp_path / 'none'}"]
    result = decode.main(argv)
    assert str(result) in capsys.readouterr().out
    assert result["method"] == "prefix_beam" and "step" not in result
    assert not (tmp_path / "none").exists()
    scored = eval_wer.main([str(tmp_path / "d.ref.tsv"), str(tmp_path / "d.hyp.tsv"), "detail=2"])
    assert scored["wer"] == result["wer"] and scored["num_utts"] == result["num_utts"]
    assert scored["sub"] + scored["ins"] + scored["del"] >= 0


def test_decode_cli_restores_the_newest_checkpoint(arpa, tmp_path):
    ckpt = tmp_path / "ckpt"
    cfg = get_config("ctc_bilstm_beam_lm", **{**TINY, "train.checkpoint_dir": str(ckpt)})
    with Trainer(cfg, device="cpu") as trainer:
        trainer.train(2)
        want = driver.decode_dataset(cfg, trainer.state.model, max_batches=1)
    argv = ["ctc_bilstm_beam_lm", *(f"{k}={v}" for k, v in TINY.items()), "device=cpu",
            f"train.checkpoint_dir={ckpt}", "max_batches=1"]
    got = decode.main(argv)
    assert got["step"] == 2 and got["wer"] == want["wer"] and got["cer"] == want["cer"]
    greedy = decode.main(argv + ["decode.method=greedy"])
    assert greedy["step"] == 2 and "method" not in greedy


def test_decode_cli_rejects_unported_methods():
    with pytest.raises(ValueError, match="joint_beam"):
        decode.parse_args(["ctc_bilstm_beam_lm", "decode.method=joint"])


def test_cli_subprocesses(arpa, tmp_path):
    """``python -m`` entry points of the three CLIs, on the CPU."""
    lm_path = tmp_path / "cli.arpa"
    runs = [["pytorch_asr_tpu_torch.train_ngram", str(lm_path), "num_synthetic=64",
             "order=3"],
            ["pytorch_asr_tpu_torch.decode", "ctc_bilstm_beam_lm",
             *(f"{k}={v}" for k, v in TINY.items()), "device=cpu", f"decode.lm_path={arpa}",
             f"dump_path={tmp_path / 'd'}", "max_batches=1",
             f"train.checkpoint_dir={tmp_path / 'none'}"],
            ["pytorch_asr_tpu_torch.eval_wer", str(tmp_path / "d.ref.tsv"),
             str(tmp_path / "d.hyp.tsv")]]
    outs = []
    for args in runs:
        proc = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                              timeout=180)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.strip().splitlines()[-1])
    assert lm_path.exists() and outs[0].startswith("wrote")
    result = ast.literal_eval(outs[1])
    assert result["method"] == "prefix_beam" and result["num_utts"] > 0
    assert ast.literal_eval(outs[2].replace("true", "True"))["num_utts"] == result["num_utts"]


def test_lm_table_lands_on_the_model_device(arpa):
    cfg = get_config("ctc_bilstm_beam_lm", **_overrides(arpa))
    table = driver.load_lm(cfg, torch.device("cpu"))
    assert table.shape == (31 ** 3, 31) and table.dtype == torch.float32
    assert driver.load_lm(get_config("ctc_bilstm_beam_lm"), "cpu") is None
