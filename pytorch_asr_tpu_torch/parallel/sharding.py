"""Tensor-parallel rules over the model axis: the port's counterpart of
``pytorch_asr_tpu.parallel.sharding``.

``RULES`` and ``DIRECTION_TP_RULES`` are the JAX package's regexes over its
parameter paths; ``describe_shardings`` applies them to the port's
parameters, each named by its JAX path (``weights.jax_path``), and feeds the
trainer's ``mesh`` record.  The port keeps every parameter whole on every
rank, as the JAX modes it runs do at rest (``directions`` and
``tcn_pallas``); the gate-dim layout that ``RULES`` places is JAX's
``gate_dims`` mode, which the port does not run (``tp_mode`` raises).

``tp_mode`` picks the mode as JAX's trainer does; ``model_split`` names the
parameters whose gradients each model rank computes only in part, so the
train step sums them over the model group.
"""

from __future__ import annotations

import re
from typing import Iterable

import torch

from pytorch_asr_tpu_torch.weights import jax_path

# (path regex, ndim, spec). First match wins; no match -> replicated.
_RECURRENT_RULES: tuple[tuple[str, int, tuple], ...] = (
    (r"encoder/.*lstm\d+_(fwd|bwd)/(wih|whh)$", 2, (None, "model")),
    (r"encoder/.*lstm\d+_(fwd|bwd)/bias$", 1, ("model",)),
)
_NON_RECURRENT_RULES: tuple[tuple[str, int, tuple], ...] = (
    (r"encoder/.*block\d+/w_conv$", 3, (None, None, "model")),
    (r"encoder/.*block\d+/b_conv$", 1, ("model",)),
    (r"encoder/.*block\d+/w_point$", 2, ("model", None)),
)
RULES = _RECURRENT_RULES + _NON_RECURRENT_RULES
DIRECTION_TP_RULES = _NON_RECURRENT_RULES

# The parameters each mode splits over the model ranks (port names).
_MODEL_SPLIT = {"directions": re.compile(r"encoder\.layers\.\d+\.(fwd|bwd)\..*"),
                "tcn_pallas": re.compile(r"encoder\.blocks\.\d+\..*")}


def spec_for(path: str, ndim: int, rules=None) -> tuple:
    """The partition spec of one parameter path, as a tuple (() replicated)."""
    for rx, nd, spec in RULES if rules is None else rules:
        if nd == ndim and re.search(rx, path):
            return spec
    return ()


def describe_shardings(params: Iterable[tuple[str, torch.Tensor]], mesh,
                       rules=None) -> dict[str, tuple]:
    """{JAX path: spec} for every parameter the rules would shard on
    ``mesh`` (a dim that does not divide its axis stays replicated), from
    the port's ``named_parameters()``."""
    out = {}
    for name, value in params:
        path = jax_path(name)
        spec = spec_for(path, value.dim(), rules)
        if any(a is not None for a in spec) and all(
                a is None or value.shape[d] % mesh.shape[a] == 0 for d, a in enumerate(spec)):
            out[path] = spec
    return out


def tp_mode(cfg, mesh) -> str | None:
    """The model-axis mode of JAX's trainer (``trainer.py:84-123``): None
    for one model rank; ``directions`` for a bidirectional BiLSTM at model
    axis 2; ``tcn_pallas`` for a TCN whose channels the axis divides.  What
    JAX runs as ``gate_dims`` (a BiLSTM past model axis 2 or a
    unidirectional stack, a TCN the axis does not divide: the XLA scan with
    the gate dim sharded by ``RULES``) raises."""
    if mesh.model == 1:
        return None
    enc = cfg.model.encoder
    if mesh.model == 2 and enc.kind == "bilstm" and enc.bidirectional:
        return "directions"
    if enc.kind == "tcn" and enc.channels % mesh.model == 0:
        return "tcn_pallas"
    raise NotImplementedError(
        f"model axis {mesh.model} with this {enc.kind} encoder is JAX's gate_dims mode "
        "(the gate dim sharded under GSPMD), which the port does not run: see ROADMAP.md, "
        "'Modules still to port'. Use mesh.model_axis=2 with a bidirectional BiLSTM, or a "
        "model axis that divides the TCN's channels")


def rules_for(mode: str | None):
    """The rule set JAX's trainer describes a mode by."""
    return {"directions": DIRECTION_TP_RULES, "tcn_pallas": (), "gate_dims": None}.get(mode, ())


def model_split(names: Iterable[str], mode: str | None) -> set[str]:
    """The parameters that ``mode`` splits over the model ranks: each rank's
    gradient of them is its part, summed over the model group."""
    rx = _MODEL_SPLIT.get(mode)
    return {n for n in names if rx is not None and rx.fullmatch(n)}
