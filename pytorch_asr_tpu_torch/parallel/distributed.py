"""Multi-process runs on ``torch.distributed``: the port's counterpart of
``pytorch_asr_tpu.parallel.distributed``.

One process a rank, started by ``torchrun`` (or ``parallel.launch.spawn``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``.  Without them the run is one process
and no process group is made.  Each rank reads the same eval batches and
keeps its own rows (``parallel.mesh.shard_batch_global``); the corpus
metrics are a count-sum over the ranks (``sum_across_processes``).  In
training each data row of the mesh reads its own shard of the corpus
(``data_shard``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(device: str | torch.device = "cuda") -> dict:
    """Join the run that torchrun's variables describe, once; returns
    ``topology()``.  The backend is ``nccl`` when the ranks run on CUDA and
    every local rank has a card of its own, else ``gloo`` (on the CPU, or
    when ranks share a card: NCCL refuses two ranks on one device, while
    gloo stages CUDA tensors through host memory)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        cuda = torch.device(device).type == "cuda"
        own_card = cuda and torch.cuda.is_available() and torch.cuda.device_count() >= local_world
        addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        dist.init_process_group("nccl" if own_card else "gloo", init_method=addr,
                                world_size=world, rank=int(os.environ["RANK"]))
    return topology()


def topology() -> dict:
    """rank, world_size, local_rank and the backend (None for one process)."""
    on = dist.is_initialized()
    return {"rank": dist.get_rank() if on else 0,
            "world_size": dist.get_world_size() if on else 1,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")) if on else 0,
            "dist_backend": dist.get_backend() if on else None}


def is_primary() -> bool:
    """True on the rank that prints and writes the run's results (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def data_shard(mesh=None) -> tuple[int, int]:
    """(num_shards, shard_index) of the training corpus this rank reads: one
    shard a data row of ``mesh`` (a ``parallel.mesh.Mesh``), so the model
    ranks of a row read the same records and data index d of D reads shard
    d.  JAX's ``host_shard`` shards by process, each host feeding all its
    devices; here a process is a rank, and a rank's data index takes the
    host's place.  No mesh, or one data row: (1, 0)."""
    if mesh is None or mesh.data == 1:
        return 1, 0
    return mesh.data, mesh.data_index


def collective_device() -> torch.device:
    """Where this rank's collectives take their tensors: its card under
    NCCL, the host under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_across_processes(values, group=None) -> np.ndarray:
    """Element-wise sum of a small numeric vector over all ranks, or those of
    ``group`` (every rank calls it the same number of times).  Counts go as
    int64 and reduce exactly, so a multi-rank WER equals the one-process
    WER; anything else goes as float64.  One process: the values as they
    are."""
    arr = np.atleast_1d(np.asarray(values))
    arr = arr.astype(np.int64 if np.issubdtype(arr.dtype, np.integer) else np.float64)
    if not dist.is_initialized():
        return arr
    t = torch.from_numpy(arr).to(collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()
