"""Run a function as the ranks of one ``torch.distributed`` job on this host,
as ``torchrun --nproc_per_node=<world>`` would, from Python:

    results = spawn(fn, world, *args, timeout=300)

Each rank is a fresh process (the ``spawn`` start method) with torchrun's
variables set, so ``parallel.distributed.initialize`` joins it; ``fn`` must
be importable by its module path.  Returns each rank's return value in rank
order; raises when a rank fails or the timeout passes, after stopping every
rank.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback

import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, args: tuple, results) -> None:
    import os

    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # The ranks share this host: gloo talks over loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 300.0) -> list:
    """``fn(*args)`` on ranks 0..world-1; their return values in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline, dead_before = {}, time.monotonic() + timeout, False
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that ended without a result gets one more second:
                # what it put may still be on its way.
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                if time.monotonic() >= deadline or (dead and dead_before):
                    missing = sorted(set(range(world)) - set(out))
                    raise RuntimeError(f"ranks {missing} gave no result: ranks {dead} ended "
                                       f"without one, or the {timeout} s timeout "
                                       "passed") from None
                dead_before = bool(dead)
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
