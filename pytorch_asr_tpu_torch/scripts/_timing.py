"""Shared argument parsing and timing of the ported benchmark scripts."""

from __future__ import annotations

import time

import numpy as np
import torch

from pytorch_asr_tpu_torch.runtime import resolve_device


def parse(argv: list[str], defaults: dict) -> tuple[dict, torch.device]:
    """``key=value`` arguments over ``defaults`` (strings), plus ``device=``
    (default ``cuda``); an unknown key raises before anything runs."""
    kv = dict(a.split("=", 1) for a in argv)
    device = resolve_device(kv.pop("device", "cuda"))
    unknown = sorted(set(kv) - set(defaults))
    if unknown:
        raise ValueError(f"unknown keys {unknown}; known: {sorted(defaults)} and device")
    return {**defaults, **kv}, device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def random_logits(B: int, T: int, V: int, device: torch.device):
    """(logits (B, T, V) standard normal from numpy seed 0, lengths all T)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(np.float32)).to(device)
    return rng, logits, torch.full((B,), T, dtype=torch.int32, device=device)


def seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Wall seconds a call of ``fn`` over ``iters`` calls after one warm-up,
    the device synchronised before the clock starts and after each call."""
    fn()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        total += time.perf_counter() - t0
    return total / iters
