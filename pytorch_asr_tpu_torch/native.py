"""ctypes binding of the port's host audio decoders (``csrc/host/audio_decode.cc``).

The port's counterpart of ``pytorch_asr_tpu.native``'s WAV and FLAC readers,
with the same names: ``read_wav``, ``read_wav_batch``, ``read_flac``,
``read_flac_batch`` and ``available``.  The C++ source is built at first use
with the host compiler (``$CXX``, else ``g++``, else ``c++``) into
``_build/`` under a name hashed from the source and the flags, through a
temporary file and ``os.replace``, so concurrent processes never load a
half-written library.  Where no compiler works, ``available()`` is False and
the readers fall back to the numpy decoders (``data/librispeech.py::read_wav``,
``data/flac.py::read_flac``); ``data/librispeech.py::load_audio`` counts
every decode by route in ``DECODES`` so a fallback is never silent.

The C calls release the GIL (ctypes), so a thread pool decodes a batch's
files in parallel; the ``*_batch`` readers decode on C++ threads instead.
Both routes give the same float32 samples, bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "audio_decode.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
MAX_SECONDS = 60.0       # first buffer; a longer file is read again at its length

# Decodes by route, counted by ``data/librispeech.py::load_audio``.
DECODES: dict[str, int] = {"audio_decode_native": 0, "audio_decode_python": 0}
_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_lib = None
_build_error: str | None = None


def count_decode(route: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        DECODES[route] += n


def reset_decodes() -> None:
    with _COUNT_LOCK:
        for k in DECODES:
            DECODES[k] = 0


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libaudio_decode-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoders if this source has no library yet; raises with
    the compiler's output when it fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (set CXX, or install g++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The decoder library, built on the first call; None where it cannot be
    built (``build_error()`` says why)."""
    global _lib, _build_error
    with _LOAD_LOCK:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        c = ctypes
        f32p, i64p, i32p = c.POINTER(c.c_float), c.POINTER(c.c_int64), c.POINTER(c.c_int32)
        for name in ("audio_read_wav", "audio_read_flac"):
            fn = getattr(lib, name)
            fn.restype = c.c_int
            fn.argtypes = [c.c_char_p, f32p, c.c_int64, i64p, i32p]
        for name in ("audio_read_wav_batch", "audio_read_flac_batch"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [c.POINTER(c.c_char_p), c.c_int32, f32p, c.c_int64, i64p, i32p,
                           i32p, c.c_int32]
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def build_error() -> str | None:
    return _build_error


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _read_one(entry: str, path: str, max_seconds: float):
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native audio decoder is unavailable: {_build_error}")
    fn = getattr(lib, entry)
    cap = int(max_seconds * 48000)
    while True:
        out = np.empty(max(cap, 1), np.float32)
        n, rate = ctypes.c_int64(), ctypes.c_int32()
        rc = fn(path.encode(), _ptr(out, ctypes.c_float), cap, ctypes.byref(n),
                ctypes.byref(rate))
        if rc != 0:
            raise IOError(f"{entry}({path!r}) failed with code {rc}")
        if n.value <= cap:
            return out[: n.value].copy(), int(rate.value)
        cap = int(n.value)


def _read_batch(entry: str, paths: list[str], max_seconds: float, n_threads: int):
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native audio decoder is unavailable: {_build_error}")
    n = len(paths)
    cap = int(max_seconds * 48000)
    audio = np.zeros((n, cap), np.float32)
    lens = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    rcs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    getattr(lib, entry)(arr, n, _ptr(audio, ctypes.c_float), cap, _ptr(lens, ctypes.c_int64),
                        _ptr(rates, ctypes.c_int32), _ptr(rcs, ctypes.c_int32),
                        n_threads or os.cpu_count() or 2)
    bad = np.nonzero(rcs)[0]
    if len(bad):
        raise IOError(f"{entry} failed for {[paths[i] for i in bad]}")
    return audio, np.minimum(lens, cap), rates


def read_wav(path: str, max_seconds: float = MAX_SECONDS):
    """(float32 mono waveform in [-1, 1], sample_rate)."""
    return _read_one("audio_read_wav", path, max_seconds)


def read_flac(path: str, max_seconds: float = MAX_SECONDS):
    """(float32 mono waveform in [-1, 1], sample_rate)."""
    return _read_one("audio_read_flac", path, max_seconds)


def read_wav_batch(paths: list[str], max_seconds: float = MAX_SECONDS, n_threads: int = 0):
    """Decode on ``n_threads`` C++ threads (0: one a core) -> (audio (N,
    max_seconds * 48000) zero-padded, lengths, rates); a file past the
    buffer is cut to it."""
    return _read_batch("audio_read_wav_batch", paths, max_seconds, n_threads)


def read_flac_batch(paths: list[str], max_seconds: float = MAX_SECONDS, n_threads: int = 0):
    """As ``read_wav_batch``, for FLAC files."""
    return _read_batch("audio_read_flac_batch", paths, max_seconds, n_threads)
