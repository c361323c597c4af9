"""The ('data', 'model') mesh over ranks: the port's counterpart of
``pytorch_asr_tpu.parallel.mesh``.

Rank r sits at (r // model, r % model), as JAX's ``reshape(data, model)``
places devices.  Utterance batches shard over 'data': each data row of the
mesh holds one contiguous block of every host batch, and its model ranks
hold the same rows.  The model ranks of a row share one process group, over
which the beam-sharded search exchanges its candidates and the BiLSTM's
direction split its outputs (``model_all_gather``).  Ranks past
data x model hold no rows.
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


def model_all_gather(x: torch.Tensor, dim: int, mesh: Mesh | None = None) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in model-index
    order, on ``x``'s device (every model rank of the row calls it alike).
    Under gloo a CUDA tensor goes through host memory, and a 2-byte type as
    its bytes: both exact.  One model rank: ``x``."""
    mesh = mesh or active_mesh()
    if mesh is None or mesh.model == 1:
        return x
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
