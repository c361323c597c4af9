"""Char RNN LM training and its ``.npz`` file: the port's counterpart of
``pytorch_asr_tpu.training.lm``.

``lm_batches`` draws the same batches as the JAX package for a seed (the same
numpy generator), ``train_rnn_lm`` runs optax's ``chain(clip_by_global_norm
(5.0), adam(lr))`` through ``training/state.py::Optimizer`` on the masked-mean
NLL, and ``save_rnn_lm``/``load_rnn_lm`` write and read the JAX package's
``.npz``: ``/``-joined parameter keys plus ``__config__``, the config as JSON
bytes.  An LM saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from pytorch_asr_tpu_torch.configs.base import OptimConfig
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.training.state import Optimizer
from pytorch_asr_tpu_torch.weights import load_jax_rnn_lm


def lm_batches(texts: list[str], batch_size: int, max_len: int,
               tokenizer: CharTokenizer | None = None, seed: int = 0):
    """Infinite iterator of (inputs, targets, lengths) numpy LM batches:
    inputs = [sos, c1..cn], targets = [c1..cn, eos], both (B, max_len)
    int32 zero-padded, lengths = n + 1."""
    tok = tokenizer or CharTokenizer()
    enc = [tok.encode(t)[: max_len - 1] for t in texts if t.strip()]
    if not enc:
        raise ValueError("no non-empty training texts")
    rng = np.random.default_rng(seed)
    U = max_len
    while True:
        idx = rng.integers(0, len(enc), size=batch_size)
        inputs = np.zeros((batch_size, U), np.int32)
        targets = np.zeros((batch_size, U), np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        for row, j in enumerate(idx):
            ids = enc[j]
            n = len(ids)
            inputs[row, 0] = tok.sos_id
            inputs[row, 1: n + 1] = ids
            targets[row, :n] = ids
            targets[row, n] = tok.eos_id
            lengths[row] = n + 1
        yield inputs, targets, lengths


def lm_loss(model: CharRNNLM, inputs: torch.Tensor, targets: torch.Tensor,
            lengths: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the positions before each row's length.  The recurrence
    is causal and later positions carry mask 0, so the forward stops at the
    longest row instead of running all ``max_len`` positions."""
    U = int(lengths.max())
    logp = torch.log_softmax(model(inputs[:, :U]).float(), dim=-1)
    nll = -torch.gather(logp, 2, targets[:, :U, None].long())[..., 0]
    mask = torch.arange(U, device=inputs.device)[None, :] < lengths[:, None]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


def lm_optimizer(model: CharRNNLM, lr: float) -> Optimizer:
    """optax ``chain(clip_by_global_norm(5.0), adam(lr))``: a constant
    learning rate, no warm-up, adam's defaults b1 0.9, b2 0.999, eps 1e-8."""
    cfg = OptimConfig(optimizer="adam", peak_lr=lr, schedule="constant", warmup_steps=0,
                      weight_decay=0.0, grad_clip_norm=5.0, b1=0.9, b2=0.999)
    return Optimizer(cfg, list(model.parameters()))


def train_step(model: CharRNNLM, opt: Optimizer, batch) -> torch.Tensor:
    """One step on a numpy (inputs, targets, lengths) batch; returns the loss
    before the update (a 0-d tensor on the model's device)."""
    device = model.embed.device
    inputs, targets, lengths = (torch.from_numpy(a).to(device) for a in batch)
    for p in model.parameters():
        p.grad = None
    loss = lm_loss(model, inputs, targets, lengths)
    loss.backward()
    opt.step([p.grad if p.grad is not None else torch.zeros_like(p)
              for p in model.parameters()])
    return loss.detach()


def train_rnn_lm(texts: list[str], cfg: RNNLMConfig | None = None, steps: int = 500,
                 batch_size: int = 32, max_len: int = 128, lr: float = 1e-3, seed: int = 0,
                 log_every: int = 0, tokenizer: CharTokenizer | None = None,
                 device: str | torch.device = "cpu") -> tuple[CharRNNLM, float]:
    """Train a char RNN LM on transcript texts; returns (model, last NLL).

    The first batch drawn serves the first step, as the JAX package draws it
    for its init and its first step."""
    cfg = cfg or RNNLMConfig()
    tok = tokenizer or CharTokenizer()
    model = CharRNNLM(cfg, tok.vocab_size, seed=seed).to(device)
    opt = lm_optimizer(model, lr)
    it = lm_batches(texts, batch_size, max_len, tok, seed=seed)
    batch = next(it)
    loss = torch.tensor(math.inf)
    for i in range(steps):
        loss = train_step(model, opt, batch)
        if log_every and (i + 1) % log_every == 0:
            nll = float(loss)
            print(json.dumps({"event": "lm_train", "step": i + 1, "nll": nll,
                              "ppl": math.exp(nll)}))
        batch = next(it)
    return model, float(loss)


def save_rnn_lm(path: str, model: CharRNNLM) -> None:
    """The config and the parameters to one ``.npz``, as the JAX package writes it."""
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    arrays["__config__"] = np.frombuffer(json.dumps(dataclasses.asdict(model.cfg)).encode(),
                                         dtype=np.uint8)
    np.savez(path, **arrays)


def load_rnn_lm(path: str, tokenizer: CharTokenizer | None = None,
                device: str | torch.device = "cpu") -> CharRNNLM:
    """The model of a ``save_rnn_lm`` ``.npz`` of either package, in eval mode."""
    tok = tokenizer or CharTokenizer()
    with np.load(path) as data:
        cfg = RNNLMConfig(**json.loads(bytes(data["__config__"]).decode()))
        tree = {k: data[k] for k in data.files if k != "__config__"}
    model = CharRNNLM(cfg, tok.vocab_size)
    model.load_state_dict(load_jax_rnn_lm(tree))
    return model.to(device).eval()
