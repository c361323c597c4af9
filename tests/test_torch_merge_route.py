"""K10's route (``ops/beam_cuda.py::merge_fits``): which shapes keep a
block's working set in shared memory and which in its slice of a device
scratch (``merge_topk_wide``), with the byte counts read from the C source
(``csrc/prefix_beam.cu::merge_smem_bytes``, ``merge_slice_bytes``).  Pure
Python, no device; on the card ``tests/test_torch_kernels_cuda.py`` holds
both forms bit for bit to the plain merge."""

from __future__ import annotations

import re

import pytest
import torch

from pytorch_asr_tpu_torch.ops import beam_cuda, build

SMEM = 232448


def _c_formulas() -> dict:
    """The C source's functions of K10's bytes, as Python: each body's
    local size constants then its return expression, the casts dropped and
    / as floor division (every operand a non-negative size)."""
    text = (build.CSRC / "prefix_beam.cu").read_text()
    env = {}
    for name in ("merge_smem_bytes", "merge_slice_bytes"):
        m = re.search(r"inline size_t " + name + r"\(([^)]*)\) \{(.*?)\n\}", text, re.S)
        params = [p.split()[-1] for p in m.group(1).split(",")]
        lines = []
        for stmt in re.sub(r"\(size_t\)", "", m.group(2)).split(";"):
            stmt = " ".join(stmt.split())
            if stmt.startswith("const size_t "):
                lines += [f"    {a.strip()}" for a in stmt[len("const size_t "):].split(",")]
            elif stmt.startswith("return "):
                lines.append("    return " + stmt[len("return "):].replace("/", "//"))
        exec(f"def {name}({', '.join(params)}):\n" + "\n".join(lines) + "\n", env)
    return env


@pytest.mark.parametrize("Ks,nb", [(16, 30), (64, 30), (565, 30), (566, 30), (640, 30),
                                   (1024, 1), (1025, 1), (7, 3), (1, 1)])
def test_bytes_are_the_c_sources(Ks, nb):
    c = _c_formulas()
    assert beam_cuda.merge_smem_bytes(Ks, nb) == c["merge_smem_bytes"](Ks, nb)
    assert beam_cuda.merge_slice_bytes(Ks, nb) == c["merge_slice_bytes"](Ks, nb)
    assert beam_cuda.merge_slice_bytes(Ks, nb) % 16 == 0


@pytest.mark.parametrize("Ks,nb,want", [
    (16, 30, True),      # the sharded decode at config 2: 7,072 bytes
    (64, 30, True),
    (565, 30, True),     # 232,162 bytes: the widest over the chars that fits
    (566, 30, False),    # 232,572 bytes
    (640, 30, False),    # 262,912 bytes: N 19,840 candidates
    (1024, 1, True),
    (1025, 1, False),    # more stays than a block's threads
])
def test_merge_route(Ks, nb, want):
    assert beam_cuda.merge_fits(Ks, nb) is want
    if want:
        assert beam_cuda.merge_smem_bytes(Ks, nb) <= SMEM and Ks <= beam_cuda.MAX_BEAM


def test_route_agrees_with_the_bytes_at_every_beam():
    """Over the chars the shared form ends at Ks 565: the last beam whose
    working set fits a block."""
    fit = [Ks for Ks in range(1, 1100) if beam_cuda.merge_fits(Ks, 30)]
    assert fit == list(range(1, fit[-1] + 1))
    assert fit[-1] == 565
    assert beam_cuda.merge_smem_bytes(fit[-1], 30) <= SMEM < beam_cuda.merge_smem_bytes(
        fit[-1] + 1, 30)


def test_cpu_tensors_take_the_plain_merge_at_any_beam():
    """On CPU tensors ``merge_topk`` is the plain merge at any beam, with no
    launch; no shape that fits the kernel's int32 indices is refused."""
    B, Ks, nb = 2, 640, 30
    g = torch.Generator().manual_seed(0)
    stay = {k: torch.randn(B, Ks, generator=g) for k in ("pb", "pnb", "lm")}
    stay.update({k: torch.randint(-2 ** 31, 2 ** 31 - 1, (B, Ks), generator=g,
                                  dtype=torch.int32) for k in ("hash",)})
    stay.update({k: torch.arange(Ks, dtype=torch.int32).expand(B, Ks).contiguous()
                 for k in ("last", "parent", "ctx", "append")})
    ext = {k: torch.randn(B, Ks, nb, generator=g) for k in ("pnb", "lm")}
    ext.update({k: torch.randint(0, 30, (B, Ks, nb), generator=g, dtype=torch.int32)
                for k in ("hash", "parent", "append", "ctx", "last")})
    build.reset_launches()
    score, fields = beam_cuda.merge_topk(stay, ext, Ks)
    assert score.shape == (B, Ks) and fields["parent"].shape == (B, Ks)
    assert not any(build.LAUNCHES.values())
