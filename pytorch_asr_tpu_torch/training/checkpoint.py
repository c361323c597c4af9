"""Checkpoint and resume: the port's counterpart of
``pytorch_asr_tpu.training.checkpoint``.

Each save is one ``torch.save`` of the model, optimizer, EMA, step and
generator state (``ckpt_{step}.pt``), beside the data iterator's position
(``iterator_{step}.json``).  ``experiment.json`` records the config; a resume
under another experiment name or another ``train.rng_impl`` raises instead of
failing deep inside a restore.  Only the newest ``train.keep_checkpoints``
saves are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.training.state import TrainState

_CKPT = re.compile(r"ckpt_(\d+)\.pt")


def _meta(cfg: ExperimentConfig) -> dict[str, Any]:
    return {"config_name": cfg.name, "config": dataclasses.asdict(cfg),
            "vocab": "char_v1" if cfg.data.vocab == "char" else cfg.data.vocab,
            "format_version": 1}


class CheckpointManager:
    def __init__(self, cfg: ExperimentConfig, directory: str | None = None) -> None:
        self.cfg = cfg
        self.directory = os.path.abspath(directory or cfg.train.checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
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
        blob = {"step": step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema.state_dict() if state.ema is not None else None,
                "generator": state.generator.get_state()}
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
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        if state.ema is not None:
            state.ema.load_state_dict(blob["ema"])
        state.generator.set_state(blob["generator"])
        state.step = int(blob["step"])
        return state

    def restore_iterator_state(self, step: int | None = None) -> dict | None:
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.directory, f"iterator_{step}.json")
        if step is None or not os.path.exists(path):
            return None
        with open(path) as fh:
            return json.load(fh)
