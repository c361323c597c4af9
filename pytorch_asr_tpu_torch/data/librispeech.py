"""LibriSpeech corpus reader: the port's copy of ``pytorch_asr_tpu.data.librispeech``.

Audio decodes on the host: the threaded C++ WAV and FLAC decoders of
``native.py`` (``csrc/host/audio_decode.cc``), or, where no host compiler
built them, the numpy decoders here and in ``data/flac.py``, which give the
same float32 samples.  ``load_audio`` counts each decode by route in
``native.DECODES``.  Everything after the raw waveform runs on the device.
Directory layout expected:

    root/<split>/<speaker>/<chapter>/<speaker>-<chapter>-<utt>.flac
    root/<split>/<speaker>/<chapter>/<speaker>-<chapter>.trans.txt

Manifests, pseudo-splits, duration subsets and the lazy corpus are the JAX
package's, entry for entry, for the same tree and seed.
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Utterance:
    utt_id: str
    audio_path: str
    transcript: str


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Pure-stdlib WAV reader -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """(float32 mono waveform, sample_rate) of a .wav or .flac file: the
    native decoder when it builds, else numpy; counted by route in
    ``native.DECODES``."""
    from pytorch_asr_tpu_torch import native

    if not path.endswith((".wav", ".flac")):
        raise RuntimeError(f"cannot decode {path!r}: unsupported audio format")
    wav = path.endswith(".wav")
    if native.available():
        out = native.read_wav(path) if wav else native.read_flac(path)
        native.count_decode("audio_decode_native")
        return out
    from pytorch_asr_tpu_torch.data.flac import read_flac

    out = read_wav(path) if wav else read_flac(path)
    native.count_decode("audio_decode_python")
    return out


def audio_info(path: str) -> tuple[int, int]:
    """Header-only (num_samples, sample_rate) — never decodes the frames.

    Cost is one open + a few KB of reads per file, so it is usable over the
    full 960 h manifest at startup (bucket optimization, SortaGrad ordering,
    duration-capped pseudo-splits)."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            return w.getnframes(), w.getframerate()
    if path.endswith(".flac"):
        from pytorch_asr_tpu_torch.data.flac import flac_info

        info = flac_info(path)
        if info["total"]:
            return info["total"], info["sr"]
        # STREAMINFO total-samples 0 means "unknown" — decode as a last resort.
        audio, sr = load_audio(path)
        return len(audio), sr
    raise RuntimeError(f"cannot probe {path!r}: unsupported audio format")


# Pseudo-splits of the canonical LibriSpeech layout.  Real LibriSpeech has no
# train-960 directory: the 960 h training set is the union of the three train
# splits, and the 1 h dev subset is a deterministic selection from dev-clean.
UNION_SPLITS: dict[str, tuple[str, ...]] = {
    "train-960": ("train-clean-100", "train-clean-360", "train-other-500"),
    "train-460": ("train-clean-100", "train-clean-360"),
}
DURATION_SPLITS: dict[str, tuple[str, float]] = {
    # name -> (base split, duration cap in seconds)
    "dev-clean-1h": ("dev-clean", 3600.0),
}


def resolve_split(split: str) -> tuple[tuple[str, ...], float | None]:
    """Pseudo-split name -> (member split dirs, duration cap in seconds).

    ``a+b`` unions arbitrary real splits; unknown names resolve to themselves
    (a literal directory)."""
    if split in UNION_SPLITS:
        return UNION_SPLITS[split], None
    if split in DURATION_SPLITS:
        base, cap = DURATION_SPLITS[split]
        return (base,), cap
    if "+" in split:
        return tuple(s for s in split.split("+") if s), None
    return (split,), None


def _scan_split_dir(split_dir: str) -> list[Utterance]:
    utts: list[Utterance] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(split_dir)):
        trans = [f for f in filenames if f.endswith(".trans.txt")]
        if not trans:
            continue
        transcripts: dict[str, str] = {}
        for tf in trans:
            with open(os.path.join(dirpath, tf)) as fh:
                for line in fh:
                    utt_id, _, text = line.strip().partition(" ")
                    transcripts[utt_id] = text
        for f in sorted(filenames):
            stem, ext = os.path.splitext(f)
            if ext in (".flac", ".wav") and stem in transcripts:
                utts.append(Utterance(stem, os.path.join(dirpath, f), transcripts[stem]))
    return utts


def _duration_subset(utts: list[Utterance], cap_sec: float,
                     seed: int) -> list[Utterance]:
    """Deterministic duration-capped subset: seeded shuffle of utt ids, take
    until the cumulative header duration reaches the cap, restore scan order.
    A pure function of (corpus contents, seed) — the seed lives in
    DataConfig.subset_seed, which is recorded with the experiment config, so
    a resumed run selects the identical subset."""
    order = np.random.default_rng(seed).permutation(len(utts))
    total = 0.0
    chosen: list[int] = []
    for i in order:
        n, sr = audio_info(utts[int(i)].audio_path)
        if sr <= 0:
            continue
        chosen.append(int(i))
        total += n / sr
        if total >= cap_sec:
            break
    return [utts[i] for i in sorted(chosen)]


def scan_manifest(root: str, split: str, subset_seed: int = 1) -> list[Utterance]:
    """Manifest for a split (real, ``+``-union, or pseudo: train-960,
    train-460, dev-clean-1h).  Audio is NOT read; duration-capped pseudo-
    splits probe headers only."""
    members, cap = resolve_split(split)
    utts: list[Utterance] = []
    missing: list[str] = []
    for m in members:
        d = os.path.join(root, m)
        if not os.path.isdir(d):
            missing.append(m)
            continue
        utts.extend(_scan_split_dir(d))
    if missing and not utts:
        raise FileNotFoundError(
            f"split {split!r}: no member directory of {members} exists "
            f"under {root!r}")
    if missing:
        raise FileNotFoundError(
            f"split {split!r}: member dirs missing under {root!r}: {missing}")
    if cap is not None:
        utts = _duration_subset(utts, cap, subset_seed)
    return utts


class LazyCorpus:
    """Sequence[(audio, transcript)] over a manifest; decodes ONE file per
    access.  Startup touches only transcript files (and, on demand, audio
    headers), so RAM stays bounded at any corpus size.
    """

    def __init__(self, utts: list[Utterance]) -> None:
        self.utts = utts
        self._lengths: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.utts)

    def __getitem__(self, idx) -> tuple[np.ndarray, str]:
        u = self.utts[int(idx)]
        audio, _sr = load_audio(u.audio_path)
        return audio, u.transcript

    def transcript(self, idx: int) -> str:
        return self.utts[int(idx)].transcript

    def audio_lengths(self) -> np.ndarray:
        """Per-utterance sample counts from headers only (cached)."""
        if self._lengths is None:
            self._lengths = np.asarray(
                [audio_info(u.audio_path)[0] for u in self.utts], np.int64)
        return self._lengths


def load_corpus(root: str, split: str, max_utts: int | None = None,
                subset_seed: int = 1) -> LazyCorpus:
    """Lazy file-backed corpus: manifest-only startup, per-item decode."""
    utts = scan_manifest(root, split, subset_seed=subset_seed)
    if max_utts is not None:
        utts = utts[:max_utts]
    return LazyCorpus(utts)
