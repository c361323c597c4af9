"""The TensorBoard mirror of the port's metrics logger (``tb_dir``).

The same ``log`` calls through the port's and the JAX package's loggers
write the same (tag, step, value) triples: JAX's as tensorflow tensor
summaries, the port's as ``torch.utils.tensorboard`` simple values, both
read back with tensorboard's event reader.  ``train.main ... tb_dir=``
mirrors its JSONL records; where tensorboard cannot be imported ``tb_dir``
is refused at construction, naming the package; only the primary rank
writes.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

from pytorch_asr_tpu_torch import train
from pytorch_asr_tpu_torch.parallel import distributed
from pytorch_asr_tpu_torch.training import trainer as trainer_mod
from pytorch_asr_tpu_torch.training.metrics import MetricsLogger

LOGS = [("train", {"step": 1, "loss": 2.5, "lr": 1e-3, "note": "strings are skipped"}),
        ("eval", {"step": 1, "wer": 0.4, "num_utts": 8, "tokens_equal": True}),
        ("restore", {"step": 7}),
        ("decode", {"wer": 0.3, "decode_rtf": 0.0125}),
        ("train", {"step": 3, "loss": 1.25, "grad_norm": 7.5})]


def read_events(log_dir: str) -> set[tuple[str, int, float]]:
    """Every scalar in the event files under ``log_dir``: simple values and
    scalar tensor summaries, as float32."""
    from tensorboard.backend.event_processing import event_accumulator
    from tensorboard.util import tensor_util

    acc = event_accumulator.EventAccumulator(log_dir, size_guidance={"scalars": 0,
                                                                     "tensors": 0})
    acc.Reload()
    out = set()
    for tag in acc.Tags()["scalars"]:
        out |= {(tag, e.step, float(np.float32(e.value))) for e in acc.Scalars(tag)}
    for tag in acc.Tags()["tensors"]:
        out |= {(tag, e.step, float(np.float32(tensor_util.make_ndarray(e.tensor_proto))))
                for e in acc.Tensors(tag)}
    return out


def want_triples(logs) -> set[tuple[str, int, float]]:
    """The JAX logger's rule: numbers only, never ``step``; a record with no
    step goes one past the largest step so far."""
    out, nxt = set(), 0
    for event, fields in logs:
        step = int(fields.get("step", nxt))
        nxt = max(nxt, step) + 1
        out |= {(f"{event}/{k}", step, float(np.float32(float(v)))) for k, v in fields.items()
                if isinstance(v, (int, float)) and k != "step"}
    return out


def test_port_and_jax_loggers_write_the_same_scalars(tmp_path):
    from pytorch_asr_tpu.training.metrics import MetricsLogger as JaxMetricsLogger

    ours = MetricsLogger(str(tmp_path / "ours.jsonl"), stdout=False,
                         tensorboard_dir=str(tmp_path / "ours"))
    ref = JaxMetricsLogger(str(tmp_path / "ref.jsonl"), stdout=False,
                           tensorboard_dir=str(tmp_path / "ref"))
    for event, fields in LOGS:
        ours.log(event, **fields)
        ref.log(event, **fields)
    ours.close()
    ref.close()
    got, want = read_events(str(tmp_path / "ours")), read_events(str(tmp_path / "ref"))
    assert got == want == want_triples(LOGS)
    for name in ("ours", "ref"):
        with open(tmp_path / f"{name}.jsonl") as fh:
            recs = [json.loads(line) for line in fh]
        assert [(r.pop("event"), r.pop("ts") > 0) for r in recs] == [(e, True) for e, _ in LOGS]
        assert recs == [f for _, f in LOGS]


def test_stdout_switch(capsys):
    MetricsLogger(stdout=False).log("train", step=1, loss=1.0)
    assert capsys.readouterr().out == ""
    MetricsLogger().log("train", step=1, loss=1.0)
    assert json.loads(capsys.readouterr().out)["loss"] == 1.0


def test_tb_dir_is_refused_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard' package"):
        MetricsLogger(str(tmp_path / "m.jsonl"), tensorboard_dir=str(tmp_path / "tb"))
    assert not (tmp_path / "m.jsonl").exists() and not (tmp_path / "tb").exists()
    MetricsLogger(str(tmp_path / "m.jsonl")).close()      # without tb_dir it works


TINY = ["ctc_bilstm_dev1h", "device=cpu", "steps=2", "train.eval_every=1", "train.log_every=1",
        "model.encoder.hidden_dim=8", "model.encoder.num_layers=1",
        "model.encoder.conv_channels=2,2", "data.synthetic_num_utts=4", "data.batch_size=2",
        "data.auto_buckets=1", "data.synthetic_max_sec=1.5"]


def test_train_main_mirrors_its_records(tmp_path):
    metrics = tmp_path / "m.jsonl"
    train.main([*TINY, f"train.checkpoint_dir={tmp_path / 'ck'}", f"metrics_path={metrics}",
                f"tb_dir={tmp_path / 'tb'}"])
    with open(metrics) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["event"] for r in recs] == ["train", "eval", "train", "eval"]
    logs = [(r.pop("event"), {k: v for k, v in r.items() if k != "ts"}) for r in recs]
    assert read_events(str(tmp_path / "tb")) == want_triples(logs)


def test_only_the_primary_rank_writes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(distributed, "is_primary", lambda: False)
    argv = [*TINY, "steps=1", f"train.checkpoint_dir={tmp_path / 'ck'}",
            f"metrics_path={tmp_path / 'm.jsonl'}", f"tb_dir={tmp_path / 'tb'}"]
    cfg, _steps, runtime = train.parse_args(argv)
    with trainer_mod.Trainer(cfg, **runtime) as tr:
        tr.train(1)
    assert not (tmp_path / "m.jsonl").exists() and not (tmp_path / "tb").exists()
    assert '"event": "train"' not in capsys.readouterr().out
