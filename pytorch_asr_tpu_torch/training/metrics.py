"""Structured JSONL metrics: the port's counterpart of
``pytorch_asr_tpu.training.metrics``, with the same metric names:
``audio_seconds_per_sec_per_chip`` (training throughput) and ``steps_per_sec``.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any, Callable


class MetricsLogger:
    """JSONL event log to stdout (``stdout``) and, given ``path``, to a file;
    with ``tensorboard_dir`` every number of a record is mirrored to
    TensorBoard as the scalar ``<event>/<key>`` (never ``step``), at the
    record's ``step``, or, for a record with none, one past the largest step
    written so far: the JAX package's tags and steps.  The mirror writes
    through ``torch.utils.tensorboard``, which needs the ``tensorboard``
    package; where it does not import, ``tensorboard_dir`` raises here."""

    def __init__(self, path: str | None = None, stdout: bool = True,
                 tensorboard_dir: str | None = None) -> None:
        self._fh: IO[str] | None = None
        self.stdout = stdout
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "tb_dir= mirrors metrics to TensorBoard, which needs the 'tensorboard' "
                    f"package; it does not import here ({e}). Drop tb_dir= or install "
                    "tensorboard") from e
            self._tb = SummaryWriter(log_dir=tensorboard_dir)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        line = json.dumps({"event": event, "ts": time.time(), **fields})
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stdout:
            print(line, flush=True)
        if self._tb is not None:
            step = int(fields.get("step", self._tb_step))
            self._tb_step = max(self._tb_step, step) + 1
            for k, v in fields.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(f"{event}/{k}", float(v), global_step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class Throughput:
    """Audio seconds per second per chip, and steps per second, since ``reset``.

    ``num_chips`` divides the audio, as JAX's (the mesh's devices: data x
    model across ranks); ``total`` (when given) turns this rank's audio
    seconds into the run's, e.g. a sum over the data group, which counts
    each data row's batches once: every rank of a run calls ``value`` at the
    same steps.  Host clock: the caller reads it after a device sync (the
    trainer reads it where it fetches the logged values), so queued work is
    counted."""

    def __init__(self, num_chips: int = 1,
                 total: Callable[[float], float] | None = None) -> None:
        self.num_chips = max(num_chips, 1)
        self.total = total
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
        audio = self._audio_sec if self.total is None else self.total(self._audio_sec)
        return {
            "audio_seconds_per_sec_per_chip": audio / dt / self.num_chips,
            "steps_per_sec": self._steps / dt,
        }
