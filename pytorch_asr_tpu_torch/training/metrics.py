"""Structured JSONL metrics: the port's counterpart of
``pytorch_asr_tpu.training.metrics``, with the same metric names:
``audio_seconds_per_sec_per_chip`` (training throughput) and ``steps_per_sec``.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any


class MetricsLogger:
    """JSONL event log to stdout and, given ``path``, to a file.  The
    TensorBoard mirror of the JAX package needs ``tensorflow`` and is not
    ported: ``tensorboard_dir`` raises."""

    def __init__(self, path: str | None = None, tensorboard_dir: str | None = None) -> None:
        if tensorboard_dir:
            raise NotImplementedError("the TensorBoard mirror (tb_dir) is not ported yet")
        self._fh: IO[str] | None = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        line = json.dumps({"event": event, "ts": time.time(), **fields})
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        print(line, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class Throughput:
    """Audio seconds per second per chip, and steps per second, since ``reset``,
    for the one device the port trains on.

    Host clock: the caller reads it after a device sync (the trainer reads
    it where it fetches the logged values), so queued work is counted."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._audio_sec = 0.0
        self._steps = 0

    def update(self, batch_audio_sec: float) -> None:
        self._audio_sec += batch_audio_sec
        self._steps += 1

    def value(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "audio_seconds_per_sec_per_chip": self._audio_sec / dt,
            "steps_per_sec": self._steps / dt,
        }
