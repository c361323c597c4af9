"""The port's FLAC codec and host decoders against the JAX package's.

For every case of the JAX package's FLAC round trips: the port's encoder
writes JAX's bytes, the port's decoder gives JAX's samples bit for bit, and
the port's native decoder (``csrc/host/audio_decode.cc``, built here with the
host compiler) gives the float32 waveform of JAX's numpy ``read_flac``, one
file at a time and in its batch form.  A corrupt stream raises ``FlacError``,
a ``ValueError``.  The WAV reader is held the same way.
"""

from __future__ import annotations

import wave

import numpy as np
import pytest

from pytorch_asr_tpu.data import flac as jax_flac
from pytorch_asr_tpu.data import librispeech as jax_ls
from pytorch_asr_tpu_torch import native
from pytorch_asr_tpu_torch.data import flac
from pytorch_asr_tpu_torch.data import librispeech as ls


def _pcm(n: int, bps: int, seed: int = 0, channels: int = 1) -> np.ndarray:
    """JAX's test signal: a sine plus noise, clipped to the bit depth."""
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    t = np.arange(n)
    base = (0.5 * lim * np.sin(t / 50.0)).astype(np.int64)
    noise = rng.integers(-lim // 64, lim // 64, size=(n, channels))
    x = np.clip(base[:, None] + noise, -lim, lim - 1)
    return x.astype(np.int64) if channels > 1 else x[:, 0].astype(np.int64)


# (case id, pcm, sample rate, write_flac keywords): tests/test_flac.py's cases.
CASES = [
    *[(f"{sub}{order}", lambda order=order: _pcm(5000, 16, seed=order), 16000,
       dict(subframe=sub, order=max(order, 1) if sub == "lpc" else order, blocksize=1024))
      for sub, order in [("verbatim", 0), ("fixed", 0), ("fixed", 1), ("fixed", 2),
                         ("fixed", 3), ("fixed", 4), ("lpc", 1), ("lpc", 4), ("lpc", 8)]],
    ("constant", lambda: np.full(1000, -1234, dtype=np.int64), 16000,
     dict(subframe="constant", blocksize=256)),
    *[(f"bps{bps}", lambda bps=bps: _pcm(3000, bps), 16000,
       dict(bps=bps, subframe="fixed", order=2)) for bps in (8, 12, 16, 20, 24)],
    *[(f"stereo_{mode}", lambda: _pcm(4000, 16, seed=7, channels=2), 16000,
       dict(stereo_mode=mode, subframe="fixed", order=2, blocksize=512))
      for mode in ("independent", "left_side", "right_side", "mid_side")],
    ("rice_partitions", lambda: _pcm(4096, 16, seed=3), 16000,
     dict(subframe="fixed", order=2, partition_order=3, blocksize=2048)),
    ("rice_escape", lambda: _pcm(4096, 16, seed=3), 16000,
     dict(subframe="fixed", order=2, escape=True, blocksize=2048)),
    ("wasted_bits", lambda: _pcm(2000, 12, seed=5) << 4, 16000,
     dict(bps=16, subframe="fixed", order=1, wasted=4)),
    ("lpc_custom", lambda: _pcm(3000, 16, seed=9), 16000,
     dict(subframe="lpc", order=3, lpc_coefs=[45, -23, 10], lpc_shift=5, blocksize=1000)),
    ("partial_last_frame", lambda: _pcm(1000, 16, seed=11), 16000,
     dict(subframe="fixed", order=2, blocksize=256)),
    ("odd_blocksize_and_rate", lambda: _pcm(777, 16, seed=13), 12345,
     dict(subframe="fixed", order=1, blocksize=250)),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """{case id: (pcm, sample rate, port's file, JAX's file)}."""
    d = tmp_path_factory.mktemp("flac")
    out = {}
    for name, make, sr, kw in CASES:
        pcm = make()
        ours, ref = str(d / f"{name}.port.flac"), str(d / f"{name}.jax.flac")
        flac.write_flac(ours, pcm, sr, **kw)
        jax_flac.write_flac(ref, pcm, sr, **kw)
        out[name] = (pcm, sr, ours, ref)
    return out


@pytest.mark.parametrize("name", IDS)
def test_encoder_writes_jax_bytes_and_decoder_gives_jax_samples(encoded, name):
    pcm, sr, ours, ref = encoded[name]
    with open(ours, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    got, got_sr = flac.decode_flac_bytes(data)
    want, want_sr = jax_flac.decode_flac_bytes(data)
    assert got_sr == want_sr == sr
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pcm if pcm.ndim == 2 else pcm[:, None])
    assert flac.flac_info(ours) == jax_flac.flac_info(ref)
    x, x_sr = flac.read_flac(ours)
    y, y_sr = jax_flac.read_flac(ref)
    assert x.dtype == y.dtype == np.float32 and x_sr == y_sr
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", IDS)
def test_native_decoder_equals_jax_read_flac(encoded, name):
    _pcm_, sr, ours, ref = encoded[name]
    got, got_sr = native.read_flac(ours)
    want, want_sr = jax_flac.read_flac(ref)
    assert got_sr == want_sr == sr
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_batch_decode_equals_jax_read_flac(encoded):
    paths = [encoded[n][2] for n in IDS]
    audio, lens, rates = native.read_flac_batch(paths, max_seconds=1.0, n_threads=3)
    for i, name in enumerate(IDS):
        want, want_sr = jax_flac.read_flac(encoded[name][3])
        assert int(rates[i]) == want_sr and int(lens[i]) == len(want)
        np.testing.assert_array_equal(audio[i, : lens[i]], want)
        assert not audio[i, lens[i]:].any()


def test_native_reads_past_its_first_buffer(encoded):
    _pcm_, _sr, ours, ref = encoded["fixed2"]
    got, _ = native.read_flac(ours, max_seconds=100 / 48000)
    np.testing.assert_array_equal(got, jax_flac.read_flac(ref)[0])


def test_corrupt_stream_raises(tmp_path):
    path = str(tmp_path / "t.flac")
    flac.write_flac(path, _pcm(1000, 16), 16000, subframe="fixed", order=2)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    assert issubclass(flac.FlacError, ValueError)
    with pytest.raises(flac.FlacError):
        flac.decode_flac_bytes(bytes(data))
    with pytest.raises(flac.FlacError, match="fLaC"):
        flac.decode_flac_bytes(b"RIFF" + bytes(data[4:]))
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(IOError):
        native.read_flac(bad)
    with pytest.raises(IOError):
        native.read_flac_batch([path, bad])


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (2, 3)])
def test_wav_readers_equal_jax(tmp_path, width, channels):
    rng = np.random.default_rng(10 * width + channels)
    dt = {1: np.uint8, 2: np.dtype("<i2"), 4: np.dtype("<i4")}[width]
    info = np.iinfo(dt)
    data = rng.integers(info.min, info.max, size=(1500, channels), endpoint=True).astype(dt)
    path = str(tmp_path / "t.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(8000)
        w.writeframes(data.tobytes())
    want, want_sr = jax_ls.read_wav(path)
    for got, got_sr in (ls.read_wav(path), native.read_wav(path)):
        assert got_sr == want_sr == 8000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    audio, lens, _ = native.read_wav_batch([path, path], max_seconds=1.0)
    np.testing.assert_array_equal(audio[1, : lens[1]], want)


def test_load_audio_counts_its_route(encoded, monkeypatch):
    _pcm_, _sr, ours, ref = encoded["fixed2"]
    native.reset_decodes()
    got, _ = ls.load_audio(ours)
    assert native.DECODES == {"audio_decode_native": 1, "audio_decode_python": 0}
    monkeypatch.setattr(native, "available", lambda: False)
    again, _ = ls.load_audio(ours)
    assert native.DECODES == {"audio_decode_native": 1, "audio_decode_python": 1}
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(got, jax_ls.load_audio(ref)[0])
    with pytest.raises(RuntimeError, match="unsupported"):
        ls.load_audio(ours + ".mp3")
