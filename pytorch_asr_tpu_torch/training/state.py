"""Train state, optimizer, loss and train step: the port's counterpart of
``pytorch_asr_tpu.training.state``.

One step runs frontend -> encoder -> CTC loss -> gradients -> a global-norm
clip -> the optimizer -> the EMA blend.  The optimizer follows optax, not
torch's defaults, where the two differ (``Optimizer``).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pytorch_asr_tpu_torch.configs.base import ExperimentConfig, OptimConfig
from pytorch_asr_tpu_torch.data.tokenizer import get_tokenizer
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.ops import ctc_cuda


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
    generator that draws dropout and SpecAugment."""

    model: ASRModel
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0
    ema: ASRModel | None = None


def build_model(cfg: ExperimentConfig, device: torch.device) -> ASRModel:
    if cfg.train.remat_encoder:
        raise NotImplementedError("train.remat_encoder is not ported yet")
    model = ASRModel(cfg.frontend, cfg.model, get_tokenizer(cfg.data.vocab).vocab_size,
                     seed=cfg.train.seed)
    return model.to(device)


def init_train_state(cfg: ExperimentConfig, model: ASRModel) -> TrainState:
    device = next(model.parameters()).device
    ema = None
    if cfg.train.ema_decay > 0.0:
        ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(
        model=model, optimizer=make_optimizer(cfg.train.optim, list(model.parameters())),
        generator=torch.Generator(device=device).manual_seed(cfg.train.seed), ema=ema)


def eval_params(state: TrainState) -> ASRModel:
    """The model to decode and evaluate with: the EMA copy when maintained."""
    return state.model if state.ema is None else state.ema


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def compute_losses(cfg: ExperimentConfig, model: ASRModel, batch: dict,
                   generator: torch.Generator | None = None, train: bool = False):
    """Forward + CTC loss -> (scalar loss, aux dict).

    Per-utterance CTC over the float32 logits, divided by max(token_len, 1)
    and averaged over the rows with ``audio_len > 0`` (pad rows have
    audio_len = token_len = 0)."""
    if cfg.model.decoder is not None or cfg.model.ctc_weight < 1.0:
        raise NotImplementedError("the attention decoder's loss (configs 4 and 5) is not "
                                  "ported yet")
    out = model(batch["audio"], batch["audio_len"], train=train, generator=generator)
    aux = {"enc_len": out["enc_len"]}
    valid = (batch["audio_len"] > 0).float()
    n_valid = torch.clamp(valid.sum(), min=1.0)
    per_utt = ctc_cuda.ctc_loss(out["ctc_logits"], out["enc_len"], batch["tokens"],
                                batch["token_len"])
    denom = torch.clamp(batch["token_len"].float(), min=1.0)
    ctc = torch.sum(per_utt / denom * valid) / n_valid
    aux["ctc_loss"] = ctc
    loss = cfg.model.ctc_weight * ctc
    aux["loss"] = loss
    return loss, aux


def train_step(cfg: ExperimentConfig, state: TrainState, batch: dict) -> dict:
    """One micro-batch: gradients, the optimizer (an update every
    ``accum_steps``), and the EMA blend on real updates.  ``batch`` holds
    tensors on the model's device.  Returns the aux dict of 0-d tensors plus
    ``grad_norm`` (before the clip) and ``lr`` (the one applied)."""
    model = state.model
    for p in model.parameters():
        p.grad = None
    loss, aux = compute_losses(cfg, model, batch, state.generator, train=True)
    loss.backward()
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
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
