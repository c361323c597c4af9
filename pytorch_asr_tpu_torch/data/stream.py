"""The training stream: ``BucketedDataset.repeat_batches`` with a position a
checkpoint can hold, made ahead in a thread.

The port's counterpart of the JAX package's ``data/grain_pipeline.py``
(``GrainBucketedIterator``), without ``grain``.  The batches are
``repeat_batches``'s, bit for bit (epoch e shuffled with ``seed + e``, the
first length-sorted under SortaGrad): JAX's trainer yields that sequence when
it is handed a dataset, and the port's stream always does.  Grain's own
index shuffle is not reproduced.

With ``prefetch`` > 0 a daemon thread makes that many batches ahead of the
consumer; each batch's files decode in parallel on a pool of
``decode_workers`` threads (0: ``min(8, max(2, cpu_count - 1))``, JAX's
rule), which overlap because the native decoder releases the GIL.  Each batch
travels with its position, so ``get_state`` returns the position of the
oldest batch not yet delivered and a checkpoint taken with batches in flight
resumes exactly.  An exception in the producer reaches the consumer at
``next()``, after the batches made before it.  ``close()`` stops the thread
and the pool; it may be called more than once.  The thread starts at the
first ``next()``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from pytorch_asr_tpu_torch.data.batching import BucketedDataset

THREAD_PREFIX = "batch-stream"


def decode_pool_width(decode_workers: int) -> int:
    """Threads a batch's files decode on: ``decode_workers``, or with 0
    JAX's auto rule ``min(8, max(2, cpu_count - 1))``."""
    return int(decode_workers) or min(8, max(2, (os.cpu_count() or 2) - 1))


class BatchStream:
    """Endless batches with a position ``{"epoch", "batch"}`` that rebuilds
    the stream: epoch e is reshuffled with ``seed + e`` (sorted by length
    first when ``sortagrad`` and e == 0).  ``wait_s`` sums the seconds
    ``next()`` took: waiting for the producer, or making the batch itself
    when ``prefetch`` is 0."""

    def __init__(self, dataset: BucketedDataset, seed: int, sortagrad: bool,
                 state: dict | None = None, prefetch: int = 0,
                 decode_workers: int = 0) -> None:
        self.dataset, self.seed, self.sortagrad = dataset, seed, sortagrad
        self.epoch, self.batch = (int(state["epoch"]), int(state["batch"])) if state else (0, 0)
        self.prefetch = int(prefetch)
        self.name = f"{THREAD_PREFIX}-{id(self):x}"
        self.wait_s = 0.0
        # A lazy corpus decodes each batch's files on the pool; an in-memory
        # one is only copied.
        self._lazy = hasattr(dataset._corpus, "audio_lengths")
        self._workers = decode_pool_width(decode_workers)
        self._plan: list | None = None
        self._plan_epoch = -1
        self._pool: ThreadPoolExecutor | None = None
        self._cond = threading.Condition()
        self._queue: deque[tuple[dict, dict]] = deque()   # (position, batch)
        self._producing: dict | None = None
        self._error: BaseException | None = None
        self._stop = False
        self._thread: threading.Thread | None = None

    # -------------------------------------------------------------- batches
    def _epoch_plan(self) -> list:
        if self._plan_epoch != self.epoch:
            self._plan = self.dataset.epoch_plan(
                self.seed + self.epoch, sort_by_length=self.sortagrad and self.epoch == 0)
            self._plan_epoch = self.epoch
        return self._plan

    def _make_batch(self) -> dict:
        """The batch at the live position, which then moves on by one."""
        plan = self._epoch_plan()
        if self.batch >= len(plan):
            if not plan:
                raise RuntimeError("the dataset yields no batches")
            self.epoch, self.batch = self.epoch + 1, 0
            plan = self._epoch_plan()
        bi, chunk = plan[self.batch]
        decode_map = map
        if self._lazy:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self._workers,
                                                thread_name_prefix=f"{self.name}-decode")
            decode_map = self._pool.map
        batch = self.dataset.emit(bi, chunk, decode_map)
        self.batch += 1
        return batch

    def _position(self) -> dict:
        return {"epoch": self.epoch, "batch": self.batch}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        if self.prefetch <= 0:
            batch = self._make_batch()
            self.wait_s += time.perf_counter() - t0
            return batch
        with self._cond:
            if self._thread is None and not self._stop:
                self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
                self._thread.start()
            while not self._queue and self._error is None:
                if self._stop:
                    raise RuntimeError("the batch stream is closed")
                self._cond.wait()
            if not self._queue:
                raise self._error
            _position, batch = self._queue.popleft()
            self._cond.notify_all()
        self.wait_s += time.perf_counter() - t0
        return batch

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while len(self._queue) >= self.prefetch and not self._stop:
                        self._cond.wait()
                    if self._stop:
                        return
                    # The position from which THIS batch, and all after it,
                    # reproduce: it travels with the batch.
                    self._producing = self._position()
                batch = self._make_batch()
                with self._cond:
                    self._queue.append((self._producing, batch))
                    self._producing = None
                    self._cond.notify_all()
        except BaseException as e:  # handed to the consumer at next()
            with self._cond:
                self._error = e
                self._producing = None
                self._cond.notify_all()

    # ----------------------------------------------------------- checkpoint
    def get_state(self) -> dict:
        """The position of the next batch ``next()`` will deliver."""
        with self._cond:
            if self._queue:
                return dict(self._queue[0][0])
            if self._producing is not None:
                return dict(self._producing)
            return self._position()

    def close(self) -> None:
        """Stop the producer thread and the decode pool (idempotent)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass
