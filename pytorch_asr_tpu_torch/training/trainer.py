"""Training loop, on one device or across ranks: the port's counterpart of
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
LM) over the same split.  Only the primary rank writes metrics.

Across ranks (torchrun's variables, or ``parallel.launch.spawn``) the trainer
joins the job and builds the ('data', 'model') mesh of ``cfg.mesh``: data
index d of D streams records ``[d::D]`` of the corpus in batches of
``data.batch_size / D`` (the model ranks of a row read the same ones), the
step is JAX's on the global batch (``training/state.py``), every rank
evaluates its rows of the same eval batches, and checkpoints keep each data
row's position.  The model axis picks JAX's mode (``sharding.tp_mode``):
``directions`` (a bidirectional BiLSTM at model axis 2) or ``tcn_pallas``
(a TCN whose channels the axis divides); JAX's ``gate_dims`` raises before
any step.  A ``mesh`` record logs the layout, the mode and the parameters
JAX's rules would shard.  ``init_from_torch`` is not ported yet.
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
from pytorch_asr_tpu_torch.parallel import distributed, sharding
from pytorch_asr_tpu_torch.parallel.mesh import make_mesh, use_mesh
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
        world = distributed.initialize(self.device)["world_size"]
        self.mesh = make_mesh(cfg.mesh, batch_size=cfg.data.batch_size)
        mesh = self.mesh
        if mesh.data * mesh.model != world:
            raise ValueError(f"the mesh {mesh.data} x {mesh.model} (data.batch_size "
                             f"{cfg.data.batch_size} caps the data axis) leaves ranks of "
                             f"the {world} idle; train on data x model ranks")
        self.tp_mode = sharding.tp_mode(cfg, mesh)     # gate_dims raises here
        shards, index = distributed.data_shard(mesh)
        # A dataset handed in is this rank's share of the data.
        self.dataset = dataset or build_dataset(cfg.data, cfg.frontend.sample_rate,
                                                num_shards=shards, shard_index=index)
        # Periodic eval reads data.eval_split of a LibriSpeech tree, as JAX's
        # trainer does, whole on every rank (each keeps its rows); a dataset
        # handed in evaluates on itself.
        self.eval_dataset = self.dataset
        if dataset is None and (shards > 1 or eval_data_config(cfg.data) is not cfg.data):
            self.eval_dataset = build_eval_dataset(cfg.data, cfg.frontend.sample_rate)
        primary = distributed.is_primary()
        self.metrics = MetricsLogger(metrics_path if primary else None, stdout=primary,
                                     tensorboard_dir=tensorboard_dir if primary else None)
        total = None
        if mesh.data > 1:
            total = lambda a: float(  # noqa: E731 -- every data row's audio once
                distributed.sum_across_processes([a], group=mesh.data_group)[0])
        self.throughput = Throughput(num_chips=mesh.data * mesh.model, total=total)
        model = build_model(cfg, self.device)
        self.state: TrainState = init_train_state(cfg, model, mesh)
        if world > 1:
            self.metrics.log("mesh", layout=dict(mesh.shape), tp_mode=self.tp_mode,
                             sharded_params=sorted(sharding.describe_shardings(
                                 model.named_parameters(), mesh,
                                 sharding.rules_for(self.tp_mode))))
        self._ckpt = (CheckpointManager(cfg, checkpoint_dir, mesh) if enable_checkpoints
                      else None)
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
        Returns the last logged record plus ``wall_s``, ``stream_wait_s``
        (the seconds ``next()`` waited for the stream's producer) and
        ``exchange_s`` (the seconds of the gradient exchange across ranks,
        synchronised; 0 on one rank)."""
        cfg = self.cfg
        sr = cfg.frontend.sample_rate
        last = {}
        self.throughput.reset()
        wait0, exchange0 = self.stream.wait_s, self.state.exchange_s
        t_step0 = time.perf_counter()
        for _ in range(num_steps):
            host_batch = next(self.stream)
            with use_mesh(self.mesh):
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
        last["exchange_s"] = self.state.exchange_s - exchange0
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
                                step=self.state.step, mesh=self.mesh)
        self.metrics.log("decode", **result)
        return result

    def evaluate(self, max_batches: int | None = None) -> dict:
        """Greedy-decode WER/CER and decode RTF over the eval dataset."""
        result = evaluate(self.cfg, eval_params(self.state), max_batches,
                          dataset=self.eval_dataset, mesh=self.mesh)
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
