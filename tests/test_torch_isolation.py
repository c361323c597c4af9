"""The port stands alone: no module of it, nor ``chip_smoke.py``, loads JAX or
the JAX package; and ``chip_smoke.py`` fails without a GPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# The modules of the seven slices (greedy serving, training, beam serving,
# config 3, RNN-LM fusion, the beam decode across ranks, the benchmark
# scripts of the last four kernels), each of which the probe must import
# without JAX.
SLICE_MODULES = [f"pytorch_asr_tpu_torch.{m}" for m in (
    "decode", "evaluate", "ops.stft_cuda", "ops.lstm_cuda", "ops.ctc", "ops.ctc_cuda",
    "frontend.specaugment", "models.encoder_bilstm", "models.asr_model", "data.batching",
    "training.state", "training.metrics", "training.checkpoint", "training.trainer", "train",
    "data.synthetic", "data.bucket_opt", "decoding.wer", "decoding.lm", "decoding.prefix_beam",
    "decoding.driver", "ops.beam_cuda", "train_ngram", "eval_wer", "models.encoder_tcn",
    "ops.tcn_cuda", "models.lm_rnn", "training.lm", "train_lm", "parallel.distributed",
    "parallel.mesh", "parallel.launch", "decoding.prefix_beam_sharded",
    "scripts.bench_prefix_beam", "scripts.bench_beam_compile")]

_PROBE = """
import importlib, json, pkgutil, sys
import pytorch_asr_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "pytorch_asr_tpu") or m.startswith(("jax.", "pytorch_asr_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _PROBE], ROOT)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(SLICE_MODULES) <= set(report["modules"])
    assert report["bad"] == []


def test_chip_smoke_fails_without_a_gpu_or_the_port(tmp_path):
    """Alone in a directory it has no port to import, and without a GPU it
    refuses to run: both exit non-zero and print no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    runs = [tmp_path] + ([] if torch.cuda.is_available() else [ROOT])
    for cwd in runs:
        proc = _run(["chip_smoke.py"], cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


_ENDS_ALONE = """
import json, os, subprocess
import chip_smoke
from pytorch_asr_tpu_torch.parallel import launch
chip_smoke.adopt_orphans()
ranks = launch.spawn(os.getpid, 2, timeout=120)
orphan = int(subprocess.run(["sh", "-c", "sleep 60 >/dev/null 2>&1 & echo $!"],
                            capture_output=True, text=True, check=True).stdout)
child = subprocess.Popen(["sleep", "60"]).pid
started = sorted(chip_smoke.descendants())
chip_smoke.stop_descendants()
print(json.dumps({"ranks": ranks, "started": started, "orphan": orphan, "child": child,
                  "left": sorted(chip_smoke.descendants())}))
"""


def test_chip_smoke_ends_every_process_it_started():
    """After spawned ranks (which leave multiprocessing's resource tracker),
    an orphaned grandchild and a child left running, ``stop_descendants``
    leaves no process of the run."""
    proc = _run(["-c", _ENDS_ALONE], ROOT)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(report["ranks"]) == 2
    # The tracker, the orphan (adopted by the subreaper) and the child.
    assert {report["orphan"], report["child"]} < set(report["started"])
    assert len(report["started"]) == 3
    assert report["left"] == []
    assert not [p for p in report["started"] if Path(f"/proc/{p}").exists()]
