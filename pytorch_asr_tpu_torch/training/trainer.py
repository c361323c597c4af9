"""One-device training loop: the port's counterpart of
``pytorch_asr_tpu.training.trainer``.

Host loop: take a bucketed batch from the prefetching stream
(``data/stream.py``: ``data.prefetch`` batches made ahead in a thread, a
LibriSpeech tree's files decoded on ``data.decode_workers`` threads), copy
it to the device, run one
``train_step`` (frontend -> encoder, BiLSTM or TCN, with waveform
augmentation, SpecAugment and dropout from the train state's generator ->
CTC, CE or joint loss -> gradients -> update), log JSONL metrics every
``train.log_every`` steps, checkpoint, and greedy-eval WER with the eval
weights (the EMA copy when kept) over the eval split
(``data.eval_data_config``: ``data.eval_split`` of a LibriSpeech tree, else
the training data); ``decode_eval`` runs the configured decode method
(greedy, the prefix beam search, or the attention or joint beam search, with
the LM of ``decode.lm_path``: none, an ARPA n-gram or an ``.npz`` char RNN
LM) over the same split.  Only the primary rank writes metrics.  No mesh, no
per-rank data shards and no ``init_from_torch`` yet.
"""

from __future__ import annotations

import time

import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.data import (
    BucketedDataset,
    build_dataset,
    build_eval_dataset,
    eval_data_config,
)
from pytorch_asr_tpu_torch.data.stream import BatchStream
from pytorch_asr_tpu_torch.decoding.driver import decode_dataset
from pytorch_asr_tpu_torch.evaluate import evaluate
from pytorch_asr_tpu_torch.parallel import distributed
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
        # Periodic eval reads data.eval_split of a LibriSpeech tree, as JAX's
        # trainer does; a dataset handed in evaluates on itself.
        self.eval_dataset = self.dataset
        if dataset is None and eval_data_config(cfg.data) is not cfg.data:
            self.eval_dataset = build_eval_dataset(cfg.data, cfg.frontend.sample_rate)
        primary = distributed.is_primary()
        self.metrics = MetricsLogger(metrics_path if primary else None, stdout=primary,
                                     tensorboard_dir=tensorboard_dir if primary else None)
        self.throughput = Throughput()
        self.state: TrainState = init_train_state(cfg, build_model(cfg, self.device))
        self._ckpt = CheckpointManager(cfg, checkpoint_dir) if enable_checkpoints else None
        it_state = None
        if self._ckpt is not None and self._ckpt.latest_step() is not None:
            self._ckpt.restore(self.state)
            it_state = self._ckpt.restore_iterator_state()
            self.metrics.log("restore", step=self.state.step)
        self.stream = BatchStream(self.dataset, cfg.data.shuffle_seed, cfg.data.sortagrad,
                                  it_state, prefetch=cfg.data.prefetch,
                                  decode_workers=cfg.data.decode_workers)

    # ------------------------------------------------------------------ train
    def train(self, num_steps: int) -> dict:
        """``num_steps`` train steps; logs every ``train.log_every`` steps and
        at step 1, checkpoints every ``train.checkpoint_every`` and at the end.
        Returns the last logged record plus ``wall_s`` and ``stream_wait_s``
        (the seconds ``next()`` waited for the stream's producer)."""
        cfg = self.cfg
        sr = cfg.frontend.sample_rate
        last = {}
        self.throughput.reset()
        wait0 = self.stream.wait_s
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
        last["stream_wait_s"] = self.stream.wait_s - wait0
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
        result = decode_dataset(self.cfg, eval_params(self.state), self.eval_dataset,
                                max_batches=max_batches, dump_path=dump_path,
                                step=self.state.step)
        self.metrics.log("decode", **result)
        return result

    def evaluate(self, max_batches: int | None = None) -> dict:
        """Greedy-decode WER/CER and decode RTF over the eval dataset."""
        result = evaluate(self.cfg, eval_params(self.state), max_batches,
                          dataset=self.eval_dataset)
        result["step"] = self.state.step
        self.metrics.log("eval", **result)
        return result

    def close(self) -> None:
        """Stop the stream's thread and pool and close the metrics (idempotent)."""
        self.stream.close()
        self.metrics.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
