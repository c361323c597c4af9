"""The port's prefetching training stream (``data/stream.py``).

Over a LibriSpeech-layout FLAC tree (files decoded on the stream's pool) and
the synthetic corpus: the prefetching stream yields the batches of
``prefetch=0`` and of the JAX package's ``BucketedDataset.repeat_batches``,
bit for bit, across epochs and under SortaGrad; a resume from a position
taken while batches are in flight continues exactly; an error in the
producer reaches ``next()``; ``close()`` leaves no thread of the stream.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import pytest

from pytorch_asr_tpu import configs as jax_configs
from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
from pytorch_asr_tpu_torch import configs, native
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.data.stream import BatchStream, decode_pool_width
from pytorch_asr_tpu_torch.training.trainer import Trainer
from tests.test_torch_librispeech import SR, make_split


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("librispeech"))
    make_split(root, "train-clean-100", [19, 26], seed=11)
    make_split(root, "train-clean-360", [33], seed=12)
    make_split(root, "train-other-500", [41], seed=13)
    make_split(root, "dev-clean", [84], seed=14, sec_hi=1.0)
    return root


def _overrides(root: str | None) -> dict:
    kw = {"data.batch_size": "3", "data.bucket_audio_lens": "12000,24000",
          "data.bucket_label_lens": "40,60"}
    if root:
        kw.update({"data.librispeech_root": root, "data.split": "train-960"})
    else:
        kw.update({"data.synthetic_num_utts": "10", "data.synthetic_max_sec": "1.2",
                   "data.auto_buckets": "2"})
    return kw


def _datasets(root: str | None):
    kw = _overrides(root)
    cfg = get_config("ctc_bilstm_dev1h", **kw).data
    jcfg = jax_configs.get_config("ctc_bilstm_dev1h", **kw).data
    return build_dataset(cfg, SR), jax_build_dataset(jcfg, SR)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _take(it, n: int) -> list:
    return [next(it) for _ in range(n)]


def _stream_threads(stream: BatchStream) -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith(stream.name)]


@pytest.mark.parametrize("source", ["tree", "synthetic"])
@pytest.mark.parametrize("sortagrad", [False, True])
def test_stream_equals_unprefetched_and_jax_repeat_batches(tree, source, sortagrad):
    ds, jds = _datasets(tree if source == "tree" else None)
    n = 2 * len(ds.epoch_plan(0)) + 2            # into the third epoch
    want = _take(jds.repeat_batches(seed=5, sortagrad=sortagrad), n)
    for prefetch, workers in ((0, 0), (3, 0), (1, 2)):
        stream = BatchStream(ds, 5, sortagrad, prefetch=prefetch, decode_workers=workers)
        try:
            got = _take(stream, n)
        finally:
            stream.close()
        assert all(_equal(a, b) for a, b in zip(got, want)), (prefetch, workers)


def test_resume_with_batches_in_flight_is_exact(tree):
    ds, _ = _datasets(tree)
    per_epoch = len(ds.epoch_plan(0))
    fresh = BatchStream(ds, 2, True, prefetch=0)
    want = _take(fresh, 3 * per_epoch)
    for cut in (1, per_epoch - 1, per_epoch, per_epoch + 2):
        first = BatchStream(ds, 2, True, prefetch=4)
        try:
            got = _take(first, cut)
            # let the producer fill its queue, so batches are in flight
            while len(first._queue) < 4 and first._error is None:
                with first._cond:
                    first._cond.wait(0.05)
            state = first.get_state()
        finally:
            first.close()
        assert all(_equal(a, b) for a, b in zip(got, want[:cut]))
        resumed = BatchStream(ds, 2, True, state=state, prefetch=2)
        try:
            rest = _take(resumed, per_epoch + 1)
        finally:
            resumed.close()
        assert all(_equal(a, b) for a, b in zip(rest, want[cut:cut + per_epoch + 1])), cut


def test_lazy_stream_decodes_on_its_pool(tree):
    ds, _ = _datasets(tree)
    stream = BatchStream(ds, 0, False, prefetch=2, decode_workers=3)
    names = set()
    real = ds._corpus.__class__.__getitem__

    class Recording(ds._corpus.__class__):
        def __getitem__(self, idx):
            names.add(threading.current_thread().name)
            return real(self, idx)

    ds._corpus.__class__ = Recording
    native.reset_decodes()
    try:
        batch = next(stream)
    finally:
        stream.close()
        ds._corpus.__class__ = Recording.__mro__[1]
    assert names and all(n.startswith(f"{stream.name}-decode") for n in names)
    assert native.DECODES["audio_decode_native"] >= int((batch["audio_len"] > 0).sum())
    assert decode_pool_width(0) == min(8, max(2, (os.cpu_count() or 2) - 1))
    assert decode_pool_width(5) == 5


def test_producer_error_reaches_next(tree, tmp_path):
    root = str(tmp_path / "broken")
    shutil.copytree(os.path.join(tree, "dev-clean"), os.path.join(root, "dev-clean"))
    kw = {"data.librispeech_root": root, "data.split": "dev-clean", "data.batch_size": "2",
          "data.bucket_audio_lens": "24000", "data.bucket_label_lens": "60"}
    ds = build_dataset(get_config("ctc_bilstm_dev1h", **kw).data, SR)
    plan = ds.epoch_plan(0)
    bad = ds._corpus.utts[plan[2][1][0][0]].audio_path
    with open(bad, "r+b") as fh:                 # break the first frame's sync
        fh.seek(-64, os.SEEK_END)
        fh.write(b"\xff" * 64)
    stream = BatchStream(ds, 0, False, prefetch=3)
    try:
        got = _take(stream, 2)
        with pytest.raises(IOError, match=os.path.basename(bad)):
            next(stream)
        with pytest.raises(IOError):
            next(stream)
    finally:
        stream.close()
    assert len(got) == 2 and not _stream_threads(stream)


def test_close_stops_every_thread_and_is_idempotent(tree):
    ds, _ = _datasets(tree)
    stream = BatchStream(ds, 0, False, prefetch=3, decode_workers=2)
    next(stream)
    assert _stream_threads(stream)
    stream.close()
    stream.close()
    assert not _stream_threads(stream)
    with pytest.raises(RuntimeError, match="closed"):
        while True:                                  # what was made, then closed
            next(stream)


TINY = {"model.encoder.hidden_dim": "8", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "2,2", "model.compute_dtype": "float32",
        "data.eval_split": "dev-clean", "train.log_every": "1"}


def test_trainer_resumes_its_stream_from_the_checkpoint(tree, tmp_path):
    """Two steps, a checkpoint (batches in flight), a new trainer: its next
    batch is the third of an uninterrupted stream; ``close`` stops it all."""
    kw = {**_overrides(tree), **TINY, "train.checkpoint_dir": str(tmp_path / "ck")}
    cfg = configs.get_config("ctc_bilstm_dev1h", **kw)
    with Trainer(cfg, device="cpu") as trainer:
        trainer.train(2)
        assert trainer.eval_dataset is not trainer.dataset
        stream = trainer.stream
    assert not _stream_threads(stream)
    want = _take(BatchStream(trainer.dataset, cfg.data.shuffle_seed, cfg.data.sortagrad), 3)
    with Trainer(cfg, device="cpu") as again:
        assert again.state.step == 2
        assert _equal(next(again.stream), want[2])
