"""Train state, optimizer, loss and train step: the port's counterpart of
``pytorch_asr_tpu.training.state``.

One step runs frontend -> encoder (-> LAS decoder) -> the CTC, CE or joint
loss -> gradients -> a global-norm clip -> the optimizer -> the EMA blend.
The optimizer follows optax, not torch's defaults, where the two differ
(``Optimizer``).

Across ranks (a train state with a ``parallel.mesh.Mesh``) each rank's batch
is its data row's share of the global batch, and the step is JAX's on that
global batch: the loss divides by the global batch's valid rows and CE
tokens (summed over the data group), so each data rank's loss is its share
of the global loss; after the backward one flat collective over the model
group sums the gradients the model ranks computed in part (the mode's split
parameters, ``parallel/sharding.py::model_split``) and takes model rank 0's
of the rest, which every model rank computed whole (cuDNN's convolution
backward may choose an algorithm that is not deterministic, so two model
ranks can hold other bits for the same gradient: rank 0's make them equal
without a second summation order); then one over the data group sums every
gradient (never over the world, which would count a data row once a model
rank).  The clip, ``grad_norm``, the optimizer and the logged losses see
the reduced values, every micro-batch under accumulation.  Every rank
then holds the same parameters, bit for bit.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig, OptimConfig
from pytorch_asr_tpu_torch.data.tokenizer import get_tokenizer
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.ops import ctc_cuda
from pytorch_asr_tpu_torch.ops.ce import make_decoder_io, smoothed_ce_loss
from pytorch_asr_tpu_torch.parallel import sharding
from pytorch_asr_tpu_torch.parallel.mesh import Mesh, all_reduce_flat


def lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Warmup, then one of: inv-sqrt (noam), constant, cosine, exponential.

    Called with the optimizer's own update count, which is 0 at the first
    update; ``max(step, 1)`` lifts it as the JAX package does."""
    if cfg.schedule not in ("noam", "constant", "cosine", "exponential"):
        raise ValueError(f"unknown lr schedule {cfg.schedule!r}")

    def fn(step: int) -> float:
        step = float(max(step, 1))
        if step < cfg.warmup_steps:
            return cfg.peak_lr * step / cfg.warmup_steps
        frac = min(max((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        if cfg.schedule == "noam":
            return cfg.peak_lr * math.sqrt(cfg.warmup_steps / step)
        if cfg.schedule == "constant":
            return cfg.peak_lr
        if cfg.schedule == "cosine":
            floor = cfg.peak_lr * cfg.end_lr_fraction
            return floor + (cfg.peak_lr - floor) * 0.5 * (1 + math.cos(math.pi * frac))
        return cfg.peak_lr * cfg.end_lr_fraction ** frac

    return fn


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all entries of all tensors (float32)."""
    return torch.sqrt(sum(torch.sum(t.float().square()) for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax's clip: g unchanged when ||g|| < max_norm, else (g / ||g||) * max_norm.

    ``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6 instead.  The
    choice is made on the device, so no value is fetched to the host."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Optimizer:
    """optax ``chain(clip_by_global_norm, adamw | adam | sgd(nesterov))``,
    inside ``MultiSteps`` when ``accum_steps > 1``.

    adamw / adam: mu and nu moments, bias-corrected by the update count,
    ``mu_hat / (sqrt(nu_hat) + eps)`` with eps 1e-8 outside the square root,
    plus the decoupled decay ``wd * p`` for adamw; sgd: optax's nesterov
    trace.  The step is ``lr_schedule(count)`` with ``count`` the updates
    applied so far.  Accumulation keeps the running mean of the micro-batch
    gradients and applies the clip and the update to it every
    ``accum_steps``-th call, as ``MultiSteps`` does.
    """

    EPS = 1e-8

    def __init__(self, cfg: OptimConfig, params: list[torch.Tensor]) -> None:
        if cfg.optimizer not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.params = params
        self.schedule = lr_schedule(cfg)
        self.count = 0          # optimizer updates applied
        self.mini_step = 0      # micro-batches accumulated since the last update
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        self.slots = {"trace": zeros()} if cfg.optimizer == "sgd" else {
            "mu": zeros(), "nu": zeros()}
        if cfg.accum_steps > 1:
            self.slots["acc"] = zeros()

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients; returns True when the parameters moved."""
        cfg = self.cfg
        if cfg.accum_steps > 1:
            n = self.mini_step
            acc = self.slots["acc"]
            for a, g in zip(acc, grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < cfg.accum_steps:
                self.mini_step += 1
                return False
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            self.mini_step = 0
        grads = clip_by_global_norm(grads, cfg.grad_clip_norm)
        lr = self.schedule(self.count)
        self.count += 1
        if cfg.optimizer == "sgd":
            for p, g, tr in zip(self.params, grads, self.slots["trace"]):
                tr.mul_(cfg.momentum).add_(g)
                p.add_(g + cfg.momentum * tr, alpha=-lr)
            return True
        c1 = 1.0 - float(np.float32(cfg.b1) ** self.count)
        c2 = 1.0 - float(np.float32(cfg.b2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.slots["mu"], self.slots["nu"]):
            mu.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            if cfg.optimizer == "adamw":
                update = update + cfg.weight_decay * p
            p.add_(update, alpha=-lr)
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "slots": {k: [t.clone() for t in v] for k, v in self.slots.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for k, tensors in state["slots"].items():
            for dst, src in zip(self.slots[k], tensors):
                dst.copy_(src)


def make_optimizer(cfg: OptimConfig, params: list[torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, params)


@dataclass
class TrainState:
    """Model, optimizer, EMA copy (or None), micro-batch step and the
    generator that draws dropout and SpecAugment; across ranks the mesh,
    the parameters its mode splits over the model ranks, and the seconds
    spent in the gradient exchange (``exchange_s``, synchronised)."""

    model: ASRModel
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0
    ema: ASRModel | None = None
    mesh: Mesh | None = None
    split: frozenset = field(default_factory=frozenset)
    exchange_s: float = 0.0


def build_model(cfg: ExperimentConfig, device: torch.device) -> ASRModel:
    model = ASRModel(cfg.frontend, cfg.model, get_tokenizer(cfg.data.vocab).vocab_size,
                     seed=cfg.train.seed, remat_encoder=cfg.train.remat_encoder)
    return model.to(device)


def data_seed(seed: int, data_index: int) -> int:
    """The seed of data index d's generator: ``seed`` for d = 0 (a one-rank
    run draws as before), another stream for each other data row; the model
    ranks of a row share it, so they draw the same masks."""
    return seed + (data_index << 32)


def init_train_state(cfg: ExperimentConfig, model: ASRModel,
                     mesh: Mesh | None = None) -> TrainState:
    """The train state of ``model``; across ranks on ``mesh``, whose mode
    (``sharding.tp_mode``) raises before any step where the port has none."""
    device = next(model.parameters()).device
    ema = None
    if cfg.train.ema_decay > 0.0:
        ema = copy.deepcopy(model).requires_grad_(False)
    split = frozenset()
    if mesh is not None:
        split = frozenset(sharding.model_split((n for n, _ in model.named_parameters()),
                                               sharding.tp_mode(cfg, mesh)))
    d = mesh.data_index if mesh is not None and mesh.has_rows else 0
    return TrainState(
        model=model, optimizer=make_optimizer(cfg.train.optim, list(model.parameters())),
        generator=torch.Generator(device=device).manual_seed(data_seed(cfg.train.seed, d)),
        ema=ema, mesh=mesh, split=split)


def eval_params(state: TrainState) -> ASRModel:
    """The model to decode and evaluate with: the EMA copy when maintained."""
    return state.model if state.ema is None else state.ema


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def loss_counts(cfg: ExperimentConfig, batch: dict, mesh: Mesh | None = None) -> dict:
    """The loss normalizers of the global batch: its valid rows
    (``audio_len`` > 0) and, with a decoder, its CE positions (each valid
    row's labels and eos), as 0-d float32 tensors, summed over ``mesh``'s
    data group (one collective) when it has more than one data row."""
    valid = batch["audio_len"] > 0
    counts = {"n_valid": valid.float().sum()}
    if cfg.model.decoder is not None:
        counts["ce_tokens"] = torch.where(valid, batch["token_len"] + 1, 0).float().sum()
    if mesh is not None and mesh.data > 1:
        counts = dict(zip(counts, all_reduce_flat(list(counts.values()), mesh.data_group)))
    return counts


def compute_losses(cfg: ExperimentConfig, model: ASRModel, batch: dict,
                   generator: torch.Generator | None = None, train: bool = False,
                   step: int | None = None, counts: dict | None = None):
    """Forward + CTC / CE / joint loss -> (scalar loss, aux dict), as
    ``lambda * ctc + (1 - lambda) * ce`` with lambda = ``model.ctc_weight``:
    the CTC term only where lambda > 0, the CE term only where a decoder is
    configured and lambda < 1.

    CTC: per utterance over the float32 logits, divided by max(token_len, 1)
    and averaged over the rows with ``audio_len > 0`` (pad rows have
    audio_len = token_len = 0).  CE: label-smoothed over the decoder's
    teacher-forced logits (``ops/ce.py``), pad rows given dec_len 0.  In
    train mode with scheduled sampling its probability ramps over
    ``ss_ramp_steps`` optimizer steps: ``step`` counts micro-batches.
    ``counts`` (``loss_counts``) gives the global batch's normalizers when
    ``batch`` is a data rank's share of it; by default the batch's own."""
    tok = get_tokenizer(cfg.data.vocab)
    tokens, token_len = batch["tokens"], batch["token_len"]
    dec = cfg.model.decoder
    dec_in = dec_out = dec_len = None
    if dec is not None:
        dec_in, dec_out, dec_len = make_decoder_io(tokens, token_len, tok.sos_id, tok.eos_id)
    ss_prob = 0.0
    if dec is not None and train and step is not None and dec.scheduled_sampling > 0.0:
        opt_step = step // max(cfg.train.optim.accum_steps, 1)
        ramp = min(max(opt_step / max(dec.ss_ramp_steps, 1), 0.0), 1.0)
        ss_prob = dec.scheduled_sampling * ramp
    out = model(batch["audio"], batch["audio_len"], targets=dec_in, train=train,
                generator=generator, ss_prob=ss_prob)
    aux = {"enc_len": out["enc_len"]}
    lam = cfg.model.ctc_weight
    valid = batch["audio_len"] > 0
    loss = torch.zeros((), device=out["enc"].device)
    counts = counts or loss_counts(cfg, batch)
    if lam > 0.0:
        n_valid = torch.clamp(counts["n_valid"], min=1.0)
        per_utt = ctc_cuda.ctc_loss(out["ctc_logits"], out["enc_len"], tokens, token_len)
        denom = torch.clamp(token_len.float(), min=1.0)
        ctc = torch.sum(per_utt / denom * valid.float()) / n_valid
        aux["ctc_loss"] = ctc
        loss = loss + lam * ctc
    if dec is not None and lam < 1.0:
        # Pad rows would score their eos slot against garbage encoder rows.
        dec_len_m = torch.where(valid, dec_len, 0)
        ce = smoothed_ce_loss(out["dec_logits"], dec_out, dec_len_m, dec.label_smoothing,
                              count=counts["ce_tokens"])
        aux["ce_loss"] = ce
        loss = loss + (1.0 - lam) * ce
    aux["loss"] = loss
    return loss, aux


def reduce_gradients(state: TrainState, grads: list[torch.Tensor], aux: dict
                     ) -> list[torch.Tensor]:
    """The step's gradients and logged losses across ranks (module
    docstring): one flat collective over the model group, then one over the
    data group.  The losses in ``aux`` become the global batch's."""
    mesh = state.mesh
    groups = [g for n, g in ((mesh.model, mesh.model_group), (mesh.data, mesh.data_group))
              if n > 1]
    if not groups:
        return grads
    names = [n for n, _ in state.model.named_parameters()]
    keys = [k for k in ("loss", "ctc_loss", "ce_loss") if k in aux]
    whole = mesh.model_index == 0
    send = [g if whole or n in state.split else torch.zeros_like(g)
            for n, g in zip(names, grads)]
    send += [aux[k].detach().reshape(1) if whole else aux[k].new_zeros(1) for k in keys]
    cuda = grads[0].is_cuda
    if cuda:
        torch.cuda.synchronize(grads[0].device)
    t0 = time.perf_counter()
    out = all_reduce_flat(send, *groups)
    if cuda:
        torch.cuda.synchronize(grads[0].device)
    state.exchange_s += time.perf_counter() - t0
    for k, v in zip(keys, out[len(grads):]):
        aux[k] = v.reshape(())
    return out[:len(grads)]


def train_step(cfg: ExperimentConfig, state: TrainState, batch: dict) -> dict:
    """One micro-batch: gradients, the optimizer (an update every
    ``accum_steps``), and the EMA blend on real updates.  ``batch`` holds
    tensors on the model's device: across ranks, this data row's share of
    the global batch.  Returns the aux dict of 0-d tensors plus
    ``grad_norm`` (before the clip) and ``lr`` (the one applied)."""
    model, mesh = state.model, state.mesh
    for p in model.parameters():
        p.grad = None
    loss, aux = compute_losses(cfg, model, batch, state.generator, train=True,
                               step=state.step, counts=loss_counts(cfg, batch, mesh))
    loss.backward()
    params = list(model.parameters())
    # A parameter off the loss's graph (the CTC head at ctc_weight 0) gets a
    # zero gradient, as under jax.grad, so AdamW still decays it.
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if mesh is not None:
        grads = reduce_gradients(state, grads, aux)
    aux["grad_norm"] = global_norm(grads)
    accum = max(cfg.train.optim.accum_steps, 1)
    aux["lr"] = lr_schedule(cfg.train.optim)(state.step // accum)
    updated = state.optimizer.step(grads)
    if state.ema is not None and updated:
        d = cfg.train.ema_decay
        with torch.no_grad():
            for e, p in zip(state.ema.parameters(), params):
                e.mul_(d).add_((1.0 - d) * p)
    state.step += 1
    return {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}
