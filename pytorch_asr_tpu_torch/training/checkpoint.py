"""Checkpoint and resume: the port's counterpart of
``pytorch_asr_tpu.training.checkpoint``.

Each save is one ``torch.save`` of the model, optimizer, EMA, step and
generator state (``ckpt_{step}.pt``), beside the data iterator's position
(``iterator_{step}.json``).  ``experiment.json`` records the config; a resume
under another experiment name or another ``train.rng_impl`` raises instead of
failing deep inside a restore.  Only the newest ``train.keep_checkpoints``
saves are kept.

Across ranks (a manager given the run's mesh with more than one data row)
every rank calls ``save`` at the same steps: each data row's stream
position and generator state are gathered, rank 0 writes them with the
state (the positions as ``{"data_axis": D, "positions": [...]}``), and
every rank waits for the write.  A resume gives each data rank its own
position and generator; one under another data axis is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import torch
import torch.distributed as dist

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.parallel import distributed
from pytorch_asr_tpu_torch.training.state import TrainState

_CKPT = re.compile(r"ckpt_(\d+)\.pt")


def _meta(cfg: ExperimentConfig) -> dict[str, Any]:
    meta: dict[str, Any] = {"config_name": cfg.name, "config": dataclasses.asdict(cfg),
                            "vocab": "char_v1" if cfg.data.vocab == "char" else cfg.data.vocab,
                            "format_version": 1}
    if cfg.data.vocab.startswith("bpe:"):
        # The subword inventory rides in the meta, so the checkpoint stays
        # whole if the vocab JSON moves.
        from pytorch_asr_tpu_torch.data.tokenizer import get_tokenizer

        tok = get_tokenizer(cfg.data.vocab)
        meta["bpe"] = {"pieces": tok.pieces, "merges": [list(m) for m in tok.merges]}
    return meta


class CheckpointManager:
    def __init__(self, cfg: ExperimentConfig, directory: str | None = None, mesh=None) -> None:
        self.cfg = cfg
        self.directory = os.path.abspath(directory or cfg.train.checkpoint_dir)
        # The data rows whose positions a save keeps (one: the plain format).
        self.data_axis = mesh.data if mesh is not None else 1
        self.data_index = mesh.data_index if mesh is not None and mesh.has_rows else 0
        os.makedirs(self.directory, exist_ok=True)
        if not distributed.is_primary():
            return
        meta_path = os.path.join(self.directory, "experiment.json")
        if not os.path.exists(meta_path):
            with open(meta_path, "w") as fh:
                json.dump(_meta(cfg), fh, indent=2, default=str)
            return
        with open(meta_path) as fh:
            stored = json.load(fh)
        stored_impl = stored.get("config", {}).get("train", {}).get("rng_impl")
        if stored_impl is not None and stored_impl != cfg.train.rng_impl:
            raise ValueError(
                f"checkpoint dir {self.directory} was written with train.rng_impl="
                f"{stored_impl!r} but the current config uses {cfg.train.rng_impl!r}; "
                "resume with the original rng_impl or use a fresh checkpoint_dir")
        if stored.get("config_name") not in (None, cfg.name):
            raise ValueError(
                f"checkpoint dir {self.directory} belongs to experiment "
                f"{stored.get('config_name')!r}, not {cfg.name!r}; use a fresh "
                "checkpoint_dir")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.fullmatch(f)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, iterator_state: dict | None = None) -> None:
        step = state.step
        generators = None
        if self.data_axis > 1:
            # Every rank's (data index, position, generator); the model
            # ranks of a row hold the same ones.
            mine = (self.data_index, iterator_state, state.generator.get_state().cpu())
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            rows = {d: (pos, gen) for d, pos, gen in ranks}
            iterator_state = {"data_axis": self.data_axis,
                              "positions": [rows[d][0] for d in range(self.data_axis)]}
            generators = [rows[d][1] for d in range(self.data_axis)]
        if distributed.is_primary():
            self._write(state, step, iterator_state, generators)
        if self.data_axis > 1:
            dist.barrier()

    def _write(self, state: TrainState, step: int, iterator_state, generators) -> None:
        blob = {"step": step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema.state_dict() if state.ema is not None else None,
                "generator": state.generator.get_state()}
        if generators is not None:
            blob["generators"] = generators
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        if iterator_state is not None:
            with open(os.path.join(self.directory, f"iterator_{step}.json"), "w") as fh:
                json.dump(iterator_state, fh)
        for old in self.steps()[:-max(self.cfg.train.keep_checkpoints, 1)]:
            os.remove(self._path(old))
            it = os.path.join(self.directory, f"iterator_{old}.json")
            if os.path.exists(it):
                os.remove(it)

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load the checkpoint of ``step`` (the latest by default) into ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        saved_axis = len(blob["generators"]) if "generators" in blob else 1
        self._check_axis(saved_axis, self._path(step))
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        if state.ema is not None:
            state.ema.load_state_dict(blob["ema"])
        state.generator.set_state(blob["generators"][self.data_index] if saved_axis > 1
                                  else blob["generator"])
        state.step = int(blob["step"])
        return state

    def _check_axis(self, saved_axis: int, path: str) -> None:
        if saved_axis != self.data_axis:
            raise ValueError(
                f"{path} was saved by a run of data axis {saved_axis}, and this run's data "
                f"axis is {self.data_axis}: each data row resumes its own stream position, "
                "so resume under the same data axis (mesh.data_axis, or the ranks over "
                "mesh.model_axis) or use a fresh checkpoint_dir")

    def restore_iterator_state(self, step: int | None = None) -> dict | None:
        """This data row's stream position at ``step`` (the latest by default)."""
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.directory, f"iterator_{step}.json")
        if step is None or not os.path.exists(path):
            return None
        with open(path) as fh:
            saved = json.load(fh)
        self._check_axis(saved.get("data_axis", 1), path)
        return saved["positions"][self.data_index] if "positions" in saved else saved


def restore_eval_weights(cfg: ExperimentConfig, model: torch.nn.Module,
                         directory: str | None = None) -> int | None:
    """Load the newest checkpoint's eval weights (the EMA copy when one is
    kept) into ``model`` and return its step; None, with nothing read or
    created, when ``directory`` (default ``cfg.train.checkpoint_dir``) holds
    no checkpoint."""
    directory = os.path.abspath(directory or cfg.train.checkpoint_dir)
    if not os.path.isdir(directory) or not any(_CKPT.fullmatch(f)
                                               for f in os.listdir(directory)):
        return None
    manager = CheckpointManager(cfg, directory)   # raises for another experiment's dir
    step = manager.latest_step()
    blob = torch.load(manager._path(step), map_location="cpu", weights_only=True)
    model.load_state_dict(blob["ema"] if blob["ema"] is not None else blob["model"])
    return int(blob["step"])
