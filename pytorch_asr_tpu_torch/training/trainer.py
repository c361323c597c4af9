"""One-device training loop: the port's counterpart of
``pytorch_asr_tpu.training.trainer``.

Host loop: take a bucketed batch, copy it to the device, run one
``train_step`` (frontend -> encoder, BiLSTM or TCN, with waveform
augmentation, SpecAugment and dropout from the train state's generator ->
CTC, CE or joint loss -> gradients -> update), log JSONL metrics every
``train.log_every`` steps, checkpoint, and greedy-eval WER with the eval
weights (the EMA copy when kept); ``decode_eval`` runs the configured decode
method (greedy, the prefix beam search, or the attention or joint beam
search, with the LM of ``decode.lm_path``: none, an ARPA n-gram or an
``.npz`` char RNN LM).  No mesh, no grain iterator and no
``init_from_torch`` yet.
"""

from __future__ import annotations

import time
from typing import Iterator

import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.data import BucketedDataset, build_dataset
from pytorch_asr_tpu_torch.decoding.driver import decode_dataset
from pytorch_asr_tpu_torch.evaluate import evaluate
from pytorch_asr_tpu_torch.runtime import resolve_device, set_fp32_math
from pytorch_asr_tpu_torch.training.checkpoint import CheckpointManager
from pytorch_asr_tpu_torch.training.metrics import MetricsLogger, Throughput
from pytorch_asr_tpu_torch.training.state import (
    TrainState,
    batch_to_device,
    build_model,
    eval_params,
    init_train_state,
    train_step,
)


class BatchStream:
    """``dataset.repeat_batches`` with a position that a checkpoint can hold:
    ``{"epoch", "batch"}``.  Epoch e is reshuffled with ``seed + e`` (sorted by
    length first when ``sortagrad`` and e == 0), so the position alone
    rebuilds the stream."""

    def __init__(self, dataset: BucketedDataset, seed: int, sortagrad: bool,
                 state: dict | None = None) -> None:
        self.dataset, self.seed, self.sortagrad = dataset, seed, sortagrad
        self.epoch, self.batch = (state["epoch"], state["batch"]) if state else (0, 0)
        self._it = self._epoch_iter()

    def _epoch_iter(self) -> Iterator[dict]:
        it = self.dataset.epoch_batches(self.seed + self.epoch,
                                        sort_by_length=self.sortagrad and self.epoch == 0)
        for _ in range(self.batch):
            next(it)
        return it

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        for _ in range(2):
            try:
                batch = next(self._it)
            except StopIteration:
                self.epoch, self.batch = self.epoch + 1, 0
                self._it = self._epoch_iter()
                continue
            self.batch += 1
            return batch
        raise RuntimeError("the dataset yields no batches")

    def get_state(self) -> dict:
        return {"epoch": self.epoch, "batch": self.batch}


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        dataset: BucketedDataset | None = None,
        metrics_path: str | None = None,
        checkpoint_dir: str | None = None,
        enable_checkpoints: bool = True,
        init_from_torch: str | None = None,
        tensorboard_dir: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if init_from_torch:
            raise NotImplementedError("init_from_torch is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        set_fp32_math()
        self.dataset = dataset or build_dataset(cfg.data, cfg.frontend.sample_rate)
        self.metrics = MetricsLogger(metrics_path, tensorboard_dir=tensorboard_dir)
        self.throughput = Throughput()
        self.state: TrainState = init_train_state(cfg, build_model(cfg, self.device))
        self._ckpt = CheckpointManager(cfg, checkpoint_dir) if enable_checkpoints else None
        it_state = None
        if self._ckpt is not None and self._ckpt.latest_step() is not None:
            self._ckpt.restore(self.state)
            it_state = self._ckpt.restore_iterator_state()
            self.metrics.log("restore", step=self.state.step)
        self.stream = BatchStream(self.dataset, cfg.data.shuffle_seed, cfg.data.sortagrad,
                                  it_state)

    # ------------------------------------------------------------------ train
    def train(self, num_steps: int) -> dict:
        """``num_steps`` train steps; logs every ``train.log_every`` steps and
        at step 1, checkpoints every ``train.checkpoint_every`` and at the end.
        Returns the last logged record plus ``wall_s``."""
        cfg = self.cfg
        sr = cfg.frontend.sample_rate
        last = {}
        self.throughput.reset()
        t_step0 = time.perf_counter()
        for _ in range(num_steps):
            host_batch = next(self.stream)
            aux = train_step(cfg, self.state, batch_to_device(host_batch, self.device))
            self.throughput.update(float(host_batch["audio_len"].sum()) / sr)
            step = self.state.step
            if step % cfg.train.log_every == 0 or step == 1:
                aux_host = {k: float(v) for k, v in aux.items()
                            if not torch.is_tensor(v) or v.dim() == 0}
                last = {"step": step, **aux_host, **self.throughput.value()}
                self.metrics.log("train", **last)
                self.throughput.reset()
            if self._ckpt is not None and step % cfg.train.checkpoint_every == 0:
                self._ckpt.save(self.state, self.stream.get_state())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        last["wall_s"] = time.perf_counter() - t_step0
        if self._ckpt is not None:
            self._ckpt.save(self.state, self.stream.get_state())
        return last

    # ------------------------------------------------------------------- eval
    def decode_eval(self, max_batches: int | None = None, dump_path: str | None = None) -> dict:
        """Decode with ``cfg.decode.method``: greedy is ``evaluate``; any other
        method (prefix, attention or joint beam) goes through
        ``decoding.driver.decode_dataset``, which loads the fusion LM of
        ``cfg.decode.lm_path`` (ARPA table or RNN LM)."""
        if self.cfg.decode.method == "greedy":
            return self.evaluate(max_batches=max_batches)
        result = decode_dataset(self.cfg, eval_params(self.state), self.dataset,
                                max_batches=max_batches, dump_path=dump_path,
                                step=self.state.step)
        self.metrics.log("decode", **result)
        return result

    def evaluate(self, max_batches: int | None = None) -> dict:
        """Greedy-decode WER/CER and decode RTF over the training dataset
        (the port reads no separate eval split yet)."""
        result = evaluate(self.cfg, eval_params(self.state), max_batches,
                          dataset=self.dataset)
        result["step"] = self.state.step
        self.metrics.log("eval", **result)
        return result

    def close(self) -> None:
        self.metrics.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
