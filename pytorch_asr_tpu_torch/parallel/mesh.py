"""The ('data', 'model') mesh over ranks: the port's counterpart of
``pytorch_asr_tpu.parallel.mesh``.

Rank r sits at (r // model, r % model), as JAX's ``reshape(data, model)``
places devices.  Utterance batches shard over 'data': each data row of the
mesh holds one contiguous block of every host batch, and its model ranks
hold the same rows.  The model ranks of a row share one process group, over
which the beam-sharded search exchanges its candidates and the BiLSTM's
direction split its outputs (``model_all_gather``).  Ranks past
data x model hold no rows.

Training across ranks differentiates through the model group's exchanges:
``copy_to_model`` (identity forward, a sum over the model ranks backward),
``reduce_from_model`` (a sum forward, identity backward) and
``model_all_gather`` (its backward keeps this rank's slice), the
counterparts of the transposes JAX's ``shard_map`` gives its collectives.
``all_reduce_flat`` sums a list of tensors over a group in one collective.
Under gloo each exchange goes through host memory (``collective_device``),
and a 2-byte float is summed as float32 and rounded back, as adding two of
them in torch rounds.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from pytorch_asr_tpu_torch.configs.base import MeshConfig
from pytorch_asr_tpu_torch.parallel.distributed import collective_device, topology

# Types gloo does not take for all_gather here; they travel as their bytes.
_BYTE_VIEW = (torch.bfloat16, torch.float16, torch.int16)


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    data_index: int | None          # None: a rank past data x model
    model_index: int | None
    model_group: object = None      # the process group of this rank's data row
    data_group: object = None       # the process group of this rank's model column

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def has_rows(self) -> bool:
        return self.data_index is not None

    @property
    def counts_rows(self) -> bool:
        """Whether this rank's rows enter the corpus metrics: model index 0
        of each data row (its model ranks hold the same rows)."""
        return self.model_index == 0


_ACTIVE: Mesh | None = None


def active_mesh() -> Mesh | None:
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the one the models read (the direction split) inside the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def make_mesh(cfg: MeshConfig | None = None, batch_size: int | None = None) -> Mesh:
    """The mesh over this run's ranks.  The model axis must divide the world;
    ``data_axis = -1`` takes the rest; with ``batch_size`` the data axis is
    capped at its gcd with the batch size, so batches always divide.  Every
    rank makes every group, in the same order, as ``dist.new_group`` needs."""
    cfg = cfg or MeshConfig()
    t = topology()
    n, rank = t["world_size"], t["rank"]
    model = max(1, cfg.model_axis)
    if n % model != 0:
        raise ValueError(f"{n} ranks not divisible by model axis {model}")
    data = n // model if cfg.data_axis == -1 else cfg.data_axis
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} ranks")
    if batch_size is not None:
        data = math.gcd(data, batch_size)
    inside = rank < data * model
    d, m = (rank // model, rank % model) if inside else (None, None)
    model_group = data_group = None
    if dist.is_initialized():
        for row in range(data):
            g = dist.new_group([row * model + i for i in range(model)])
            model_group = g if row == d else model_group
        for col in range(model):
            g = dist.new_group([row * model + col for row in range(data)])
            data_group = g if col == m else data_group
    return Mesh(data, model, d, m, model_group, data_group)


def shard_batch_global(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a host batch that every rank holds alike: data
    index d takes the d-th contiguous block.  A rank past data x model gets
    no rows.  One data row: the batch as it is."""
    if mesh.data == 1 and mesh.has_rows:
        return batch
    B = next(iter(batch.values())).shape[0]
    if B % mesh.data != 0:
        raise ValueError(f"eval batch size {B} not divisible by the data axis {mesh.data}; "
                         "set data.batch_size to a multiple of it")
    if not mesh.has_rows:
        return {k: v[:0] for k, v in batch.items()}
    lo, hi = mesh.data_index * B // mesh.data, (mesh.data_index + 1) * B // mesh.data
    return {k: v[lo:hi] for k, v in batch.items()}


def _gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    dim = dim % x.dim()
    send = x.contiguous().to(collective_device())
    as_bytes = send.dtype in _BYTE_VIEW
    if as_bytes:
        send = send.view(torch.uint8)     # the last dim counts bytes from here
    parts = [torch.empty_like(send) for _ in range(mesh.model)]
    dist.all_gather(parts, send, group=mesh.model_group)
    out = torch.cat(parts, dim=dim)
    if as_bytes:
        out = out.view(x.dtype)
    return out.to(x.device)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, a new tensor on ``x``'s device."""
    widen = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.detach().to(collective_device(), torch.float32 if widen else x.dtype, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device, x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim % x.dim(), mesh, x.shape[dim]
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.mesh.model_index * ctx.size, ctx.size), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_sum(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split(mesh: Mesh | None) -> Mesh | None:
    mesh = mesh or active_mesh()
    return None if mesh is None or mesh.model == 1 else mesh


def model_all_gather(x: torch.Tensor, dim: int, mesh: Mesh | None = None) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in model-index
    order, on ``x``'s device (every model rank of the row calls it alike).
    Under gloo a CUDA tensor goes through host memory, and a 2-byte type as
    its bytes: both exact.  Differentiable: the gradient of this rank's
    ``x`` is its own slice of the output's.  One model rank: ``x``."""
    mesh = _split(mesh)
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, dim, mesh)
    return _gather(x, dim, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """``x``, whose gradient is summed over the model ranks: the input of a
    computation that each model rank runs on its own part of the weights.
    One model rank: ``x``."""
    mesh = _split(mesh)
    if mesh is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of the model ranks' ``x``; its gradient passes to each rank's
    ``x`` as it is.  One model rank: ``x``."""
    mesh = _split(mesh)
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, mesh)
    return _all_reduce_sum(x, mesh.model_group)


def all_reduce_flat(tensors: list[torch.Tensor], *groups) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of each group in turn, through one
    collective a group on one flat float32 buffer, staged once (to the host
    under gloo); new tensors in the inputs' shapes, types and device.  Every
    rank of a group gets the same bits."""
    if not tensors:
        return []
    device = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = flat.to(collective_device())
    for group in groups:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat.to(device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out
