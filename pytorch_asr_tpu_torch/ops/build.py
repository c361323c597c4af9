"""Builds the port's CUDA sources and holds the kernels' launch counts.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, on first use, and loaded with
``ctypes``.  Libraries go to ``pytorch_asr_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source and flags, so
an edited source is rebuilt and never mixed up with an old build.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (a CPU tensor takes the plain version and is not counted).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"stft_log_mel": 0, "lstm_seq": 0, "lstm_seq_train_fwd": 0,
                            "lstm_seq_bwd": 0, "ctc_alpha": 0, "ctc_beta": 0,
                            "prefix_beam": 0, "prefix_beam_topa": 0, "prefix_beam_rnn": 0,
                            "prefix_beam_rnn_topa": 0, "merge_topk": 0, "tcn_block": 0,
                            "tcn_block_train_fwd": 0, "tcn_block_bwd": 0, "bilstm_seq": 0,
                            "bilstm_seq_train_fwd": 0, "bilstm_seq_bwd": 0,
                            "bilstm_seq_per_utterance": 0,
                            "ctc_alpha_paired": 0, "prefix_beam_fused": 0,
                            "prefix_beam_stepwise": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, all at once.

    Returns each new build's compiler output (``-Xptxas -v`` register and
    shared-memory report); raises with that output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    procs = {}
    for name in todo:
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The built library ``name`` with ``argtypes`` set for each C function;
    every function returns a ``cudaError_t`` as an int."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
