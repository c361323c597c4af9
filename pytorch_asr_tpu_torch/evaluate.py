"""Greedy-CTC evaluation: the counterpart of ``Trainer.evaluate`` and
``make_eval_step`` of the JAX package, without a trainer around it; over
several ranks each decodes its rows of the mesh and the metrics are a
count-sum."""

from __future__ import annotations

import time
from typing import Mapping

import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig
from pytorch_asr_tpu_torch.data import BucketedDataset, build_eval_dataset, get_tokenizer
from pytorch_asr_tpu_torch.decoding.eval_metrics import local_hyps_refs, reduce_decode_metrics
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch_global, use_mesh
from pytorch_asr_tpu_torch.runtime import resolve_device, set_fp32_math
from pytorch_asr_tpu_torch.weights import load_npz


def build_model(cfg: ExperimentConfig, device: str | torch.device = "cuda",
                params: str | Mapping[str, torch.Tensor] | None = None) -> ASRModel:
    """The eval-mode model on ``device``: weights from ``params`` (an ``.npz``
    of the JAX tree, or a port ``state_dict``), else drawn from ``train.seed``."""
    dev = resolve_device(device)
    set_fp32_math()
    model = ASRModel(cfg.frontend, cfg.model, get_tokenizer(cfg.data.vocab).vocab_size,
                     seed=cfg.train.seed)
    if params is not None:
        model.load_state_dict(load_npz(params) if isinstance(params, str) else params)
    return model.to(dev).eval()


def model_outputs(model: ASRModel, batch: dict) -> dict:
    """The model's outputs (ctc_logits, enc, enc_len) for one host batch,
    on the model's device."""
    device = model.ctc_head.weight.device
    audio = torch.from_numpy(batch["audio"]).to(device)
    audio_len = torch.from_numpy(batch["audio_len"]).to(device)
    return model(audio, audio_len)


def eval_step(model: ASRModel, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One host batch -> (packed greedy ids (B, T'), lengths (B,)) on the model's device."""
    out = model_outputs(model, batch)
    return greedy_ctc(out["ctc_logits"], out["enc_len"])


def evaluate(cfg: ExperimentConfig, model: ASRModel, max_batches: int | None = None,
             dataset: BucketedDataset | None = None, mesh: Mesh | None = None) -> dict:
    """Greedy-decode WER/CER and decode RTF over ``dataset`` (by default the
    eval split of ``cfg.data``: ``data.eval_data_config``), on ``mesh`` (by
    default one made from ``cfg.mesh``)."""
    dataset = dataset or build_eval_dataset(cfg.data, cfg.frontend.sample_rate)
    mesh = mesh or make_mesh(cfg.mesh, batch_size=dataset.batch_size)
    refs: list[str] = []
    hyps: list[str] = []
    audio_sec = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode(), use_mesh(mesh):
        for i, batch in enumerate(dataset.epoch_batches(seed=0)):
            if max_batches is not None and i >= max_batches:
                break
            rows = shard_batch_global(mesh, batch)
            if not mesh.has_rows:
                continue
            ids, n = eval_step(model, rows)
            if mesh.counts_rows:
                r, h, a_sec = local_hyps_refs(dataset.tokenizer, rows, ids.cpu().numpy(),
                                              n.cpu().numpy(), cfg.frontend.sample_rate)
                refs.extend(r)
                hyps.extend(h)
                audio_sec += a_sec
    return reduce_decode_metrics(refs, hyps, audio_sec, time.perf_counter() - t0)
