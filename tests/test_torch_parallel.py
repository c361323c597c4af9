"""The port's runs over ranks on the CPU: ``parallel/{distributed,mesh,launch}.py``
and what reads them, in gloo ranks started by ``launch.spawn``.

One process: the topology, the count-sum, the mesh's placement and row
blocks.  Two ranks (one job): the count-sum and the model group's gather,
the BiLSTM's direction split (bit-equal to the whole encoder, float32 and
bf16, its outputs and its gradients), greedy eval over two data ranks (each
utterance counted once), and
``decode.main ... decode.shard_beams=true mesh.model_axis=2``, whose WER and
hypotheses equal the one-rank decode, as the JAX package's
``tests/test_prefix_beam_sharded.py`` holds its own driver.  The ranks run
this module's ``_rank_job``; the module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch import decode
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import MeshConfig
from pytorch_asr_tpu_torch.evaluate import build_model
from pytorch_asr_tpu_torch.parallel import distributed, launch
from pytorch_asr_tpu_torch.parallel import mesh as pmesh

TINY = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
        "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
        "frontend.specaugment": "false", "data.batch_size": "4",
        "data.synthetic_num_utts": "8", "data.synthetic_max_sec": "2.0",
        "data.auto_buckets": "1", "decode.auto_buckets": "1", "decode.beam_size": "4",
        "decode.max_decode_len": "24"}
GREEDY = ["ctc_bilstm_dev1h", *(f"{k}={v}" for k, v in TINY.items()), "device=cpu",
          "max_batches=2"]
BEAM = ["ctc_bilstm_beam_lm", *(f"{k}={v}" for k, v in TINY.items()), "device=cpu",
        "max_batches=2"]
DTYPES = ("float32", "bfloat16")


def _model_inputs(dtype: str):
    cfg = get_config("ctc_bilstm_dev1h", **{**TINY, "model.compute_dtype": dtype})
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.standard_normal((4, 8000)).astype(np.float32) * 0.1)
    return cfg, audio, torch.tensor([8000, 6000, 4100, 0])


def _rank_job(dump: str, ckpt: str) -> dict:
    """One rank of two: the collectives, the split encoder, and the decode
    CLI over data ranks (greedy) and over model ranks (sharded beams), with
    seeded weights (``ckpt`` holds no checkpoint)."""
    topo = distributed.initialize("cpu")
    rank = topo["rank"]
    out = {"topology": topo,
           "counts": distributed.sum_across_processes([rank + 1, 10 * rank]),
           "seconds": distributed.sum_across_processes([0.25 * (rank + 1)])}
    mesh = pmesh.make_mesh(MeshConfig(model_axis=2))
    out["place"] = (mesh.data_index, mesh.model_index)
    out["gathered"] = {}
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        got = pmesh.model_all_gather(torch.full((2, 3), rank + 1.5).to(dt), 1, mesh)
        out["gathered"][str(dt)] = (str(got.dtype), got.float().numpy())
    out["split"], out["split_grads"] = {}, {}
    for dtype in DTYPES:
        cfg, audio, lens = _model_inputs(dtype)
        model = build_model(cfg, "cpu")
        with torch.inference_mode(), pmesh.use_mesh(mesh):
            out["split"][dtype] = {k: v.float().numpy() for k, v in model(audio, lens).items()}
        with pmesh.use_mesh(mesh):
            out["split_grads"][dtype] = _grads(model, audio, lens)
    ckpt_arg = f"train.checkpoint_dir={ckpt}"
    out["greedy"] = decode.main(GREEDY + [ckpt_arg])
    out["beam"] = decode.main(BEAM + [ckpt_arg, "decode.shard_beams=true", "mesh.model_axis=2",
                                      f"dump_path={dump}"])
    return out


def _grads(model, audio, lens) -> dict:
    """The gradients of a fixed weighting of the CTC logits: every parameter
    that received one, and the audio's."""
    audio = audio.clone().requires_grad_(True)
    logits = model(audio, lens)["ctc_logits"].float()
    weight = torch.linspace(-1.0, 1.0, logits.numel()).reshape(logits.shape)
    (logits * weight).sum().backward()
    out = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    out["audio"] = audio.grad.numpy()
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return f"train.checkpoint_dir={tmp_path_factory.mktemp('no_checkpoint')}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, ckpt):
    dump = str(tmp_path_factory.mktemp("sharded") / "d")
    return launch.spawn(_rank_job, 2, dump, ckpt.split("=", 1)[1], timeout=180.0), dump


def test_one_process_has_no_group():
    assert distributed.initialize("cpu") == {"rank": 0, "world_size": 1, "local_rank": 0,
                                             "dist_backend": None}
    assert distributed.is_primary() and distributed.data_shard() == (1, 0)
    counts = distributed.sum_across_processes([3, 4])
    assert counts.dtype == np.int64 and counts.tolist() == [3, 4]
    assert distributed.sum_across_processes([0.5]).dtype == np.float64
    mesh = pmesh.make_mesh(MeshConfig())
    assert mesh.shape == {"data": 1, "model": 1} and mesh.counts_rows
    x = torch.arange(6)
    assert pmesh.model_all_gather(x, 0, mesh) is x


@pytest.mark.parametrize("world,cfg,batch,want", [
    (8, MeshConfig(model_axis=2), None, (4, 2, [(r // 2, r % 2) for r in range(8)])),
    (8, MeshConfig(model_axis=2), 2, (2, 2, [(0, 0), (0, 1), (1, 0), (1, 1)] + [(None,) * 2] * 4)),
    (3, MeshConfig(data_axis=2), None, (2, 1, [(0, 0), (1, 0), (None, None)]))])
def test_make_mesh_places_rank_r_at_r_div_model(monkeypatch, world, cfg, batch, want):
    """(data, model) and each rank's place, as JAX's reshape(data, model)
    places devices: the data axis capped at gcd with the batch size; ranks
    past data x model hold no rows."""
    data, model, places = want
    for rank in range(world):
        monkeypatch.setattr(pmesh, "topology", lambda r=rank: {"rank": r, "world_size": world})
        mesh = pmesh.make_mesh(cfg, batch_size=batch)
        assert (mesh.data, mesh.model) == (data, model)
        assert (mesh.data_index, mesh.model_index) == places[rank]
        assert mesh.has_rows == (places[rank][0] is not None)


@pytest.mark.parametrize("cfg", [MeshConfig(model_axis=3), MeshConfig(data_axis=3, model_axis=2)])
def test_make_mesh_rejects_what_the_world_cannot_hold(monkeypatch, cfg):
    monkeypatch.setattr(pmesh, "topology", lambda: {"rank": 0, "world_size": 4})
    with pytest.raises(ValueError):
        pmesh.make_mesh(cfg)


def test_shard_batch_global_gives_data_index_d_its_block():
    batch = {"audio": np.arange(8).reshape(4, 2), "audio_len": np.arange(4)}
    rows = pmesh.shard_batch_global(pmesh.Mesh(2, 2, 1, 0), batch)
    assert rows["audio_len"].tolist() == [2, 3] and rows["audio"].shape == (2, 2)
    assert pmesh.shard_batch_global(pmesh.Mesh(2, 1, None, None), batch)["audio"].shape == (0, 2)
    with pytest.raises(ValueError, match="divisible"):
        pmesh.shard_batch_global(pmesh.Mesh(3, 1, 0, 0), batch)


def test_count_sum_and_gather_over_two_ranks(two_ranks):
    runs, _ = two_ranks
    for rank, out in enumerate(runs):
        assert out["topology"] == {"rank": rank, "world_size": 2, "local_rank": rank,
                                   "dist_backend": "gloo"}
        assert out["counts"].dtype == np.int64 and out["counts"].tolist() == [3, 10]
        assert out["seconds"].tolist() == [0.75]
        assert out["place"] == (0, rank)
        for name, (got_dtype, got) in out["gathered"].items():
            dt = getattr(torch, name.split(".")[1])
            want = torch.cat([torch.full((2, 3), 1.5).to(dt), torch.full((2, 3), 2.5).to(dt)], 1)
            assert got_dtype == name and np.array_equal(got, want.float().numpy()), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_direction_split_is_bit_equal(two_ranks, dtype):
    """Model rank 0 runs each layer's forward direction, rank 1 the reverse;
    both ranks' outputs equal the whole encoder's bit for bit."""
    runs, _ = two_ranks
    cfg, audio, lens = _model_inputs(dtype)
    with torch.inference_mode():
        want = build_model(cfg, "cpu")(audio, lens)
    for out in runs:
        for k, v in want.items():
            assert np.array_equal(out["split"][dtype][k], v.float().numpy()), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_direction_split_gradients_equal_the_whole_encoders(two_ranks, dtype):
    """Under autograd each model rank's own direction gets the whole
    encoder's gradients bit for bit, the other direction none; the conv
    front end, the head and the audio (dx summed over the two ranks) get
    the whole encoder's on both ranks."""
    runs, _ = two_ranks
    cfg, audio, lens = _model_inputs(dtype)
    want = _grads(build_model(cfg, "cpu"), audio, lens)
    for rank, out in enumerate(runs):
        got = out["split_grads"][dtype]
        other = ".bwd." if rank == 0 else ".fwd."
        assert set(got) == {k for k in want if other not in k}, rank
        for k, v in got.items():
            assert np.array_equal(v, want[k]), (rank, k)


def test_greedy_eval_over_data_ranks_counts_each_utterance_once(two_ranks, ckpt):
    runs, _ = two_ranks
    want = decode.main(GREEDY + [ckpt])
    for out in runs:
        got = out["greedy"]
        assert got["world_size"] == 2 and got["dist_backend"] == "gloo"
        for key in ("wer", "cer", "num_utts"):
            assert got[key] == want[key], key


def test_sharded_beam_decode_matches_one_rank(two_ranks, ckpt, tmp_path):
    """``decode.shard_beams=true mesh.model_axis=2`` over two ranks: the same
    WER, CER and hypotheses as the one-rank decode; model rank 0 writes the
    dump (``.p0``), rank 1 none."""
    runs, dump = two_ranks
    want = decode.main(BEAM + [ckpt, f"dump_path={tmp_path / 'one'}"])
    for out in runs:
        got = out["beam"]
        assert got["method"] == "prefix_beam" and got["world_size"] == 2
        for key in ("wer", "cer", "num_utts", "padding_efficiency_decode"):
            assert got[key] == want[key], key
    for suffix in (".ref.tsv", ".hyp.tsv"):
        with open(f"{dump}.p0{suffix}") as fh:
            assert fh.read() == (tmp_path / f"one{suffix}").read_text()
    with pytest.raises(FileNotFoundError):
        open(f"{dump}.p1.hyp.tsv")
