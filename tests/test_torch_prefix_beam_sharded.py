"""The port's beam-sharded prefix search against the JAX package's, on the CPU:
``decoding/prefix_beam_sharded.py`` in gloo ranks (2 and 4 processes) at
model axis 2 and 4 and at data 2 x model 2, with no LM, a dense table and a
tiny RNN LM, against JAX's ``prefix_beam_search_sharded`` on the virtual CPU
mesh; the plain merge (``_merge_topk``, K10's plain version) against JAX's
``merge_topk_fused`` in interpret mode; the model axis of 1, the beam that
does not divide; and the repairs that came with the slice: ``lm_top_k``
with a dense table or the RNN LM, and ``decode.shard_beams`` on one rank.

The ranks run this module's ``_search_rank``, so the module imports JAX only
inside the functions the test process runs: a spawned rank imports no JAX.
Tokens and lengths must be equal; scores within SCORE_RTOL (1e-5 with the RNN
LM, whose steps run over B * K/P rows, summed in other orders).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import MeshConfig
from pytorch_asr_tpu_torch.decoding import driver
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding.prefix_beam_sharded import prefix_beam_search_sharded
from pytorch_asr_tpu_torch.evaluate import build_model
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.parallel import distributed, launch
from pytorch_asr_tpu_torch.parallel import mesh as pmesh

B, T, V, K = 4, 12, 6, 8
LENS = (T, T - 3, 0, 5)
LM_CFG = dict(embed_dim=4, hidden_dim=8, num_layers=1)
SOS = V - 1
SCORE_RTOL = {"none": 1e-6, "table": 1e-6, "rnn": 1e-5}
# (data, model) of each mesh, and the world that holds it.
MESHES = {"model2": ((1, 2), 2), "model4": ((1, 4), 4), "data2_model2": ((2, 2), 4)}
RANK_TIMEOUT = 120.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    """Planted-path logits, ragged lengths with an empty row, a dense table
    and JAX's init of the tiny LM (numpy)."""
    import jax
    import jax.numpy as jnp

    from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
    from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    path = rng.integers(0, V, size=(B, T))
    for b in range(B):
        logits[b, np.arange(T), path[b]] += 3.0
    table = rng.standard_normal((V * V, V)).astype(np.float32)
    table -= np.log(np.exp(table).sum(1, keepdims=True))
    jlm = JaxCharRNNLM(JaxRNNLMConfig(**LM_CFG), V)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    return logits, np.array(LENS, np.int32), table, jlm, params


def _sources(table, lm):
    return {"none": {}, "table": {"lm_table": table, "lm_alpha": 0.4, "lm_beta": 0.8},
            "rnn": {"rnn_lm": lm, "lm_alpha": 0.3, "lm_beta": 0.5, "sos_id": SOS}}


def _search_rank(meshes: dict, logits, lens, table, lm_state: dict) -> dict:
    """One rank: every mesh of this world, every fusion source; returns
    {(mesh, source): (data index, model index, tokens, lengths, scores)}."""
    distributed.initialize("cpu")
    lm = CharRNNLM(RNNLMConfig(**LM_CFG), V)
    lm.load_state_dict({k: torch.from_numpy(v) for k, v in lm_state.items()})
    out = {}
    for name, (data, model) in meshes.items():
        mesh = pmesh.make_mesh(MeshConfig(data_axis=data, model_axis=model), batch_size=B)
        rows = pmesh.shard_batch_global(mesh, {"logits": logits, "lens": lens})
        for src, kw in _sources(torch.from_numpy(table), lm.eval()).items():
            got = prefix_beam_search_sharded(torch.from_numpy(rows["logits"]),
                                             torch.from_numpy(rows["lens"]), mesh,
                                             beam_size=K, max_len=T + 1, **kw)
            out[(name, src)] = (mesh.data_index, mesh.model_index, *(g.numpy() for g in got))
    return out


@pytest.fixture(scope="module")
def runs():
    """The port's ranks (one job of 2 and one of 4) and JAX's sharded search
    on each mesh and source."""
    import jax
    import jax.numpy as jnp

    from pytorch_asr_tpu.configs.base import MeshConfig as JaxMeshConfig
    from pytorch_asr_tpu.decoding.prefix_beam_sharded import (
        prefix_beam_search_sharded as jax_sharded)
    from pytorch_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from pytorch_asr_tpu_torch import weights

    logits, lens, table, jlm, params = _inputs()
    lm_state = {k: v.numpy() for k, v in
                weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)).items()}
    ours = {}
    for world in (2, 4):
        meshes = {n: dm for n, (dm, w) in MESHES.items() if w == world}
        for rank_out in launch.spawn(_search_rank, world, meshes, logits, lens, table, lm_state,
                                     timeout=RANK_TIMEOUT):
            for key, (d, m, *res) in rank_out.items():
                ours.setdefault(key, {}).setdefault(d, {})[m] = res
    ref = {}
    jsrc = {"none": {}, "table": {"lm_table": jnp.asarray(table), "lm_alpha": 0.4,
                                  "lm_beta": 0.8},
            "rnn": {"rnn_lm": jlm, "rnn_lm_params": params, "lm_alpha": 0.3, "lm_beta": 0.5,
                    "sos_id": SOS}}
    for name, ((data, model), _) in MESHES.items():
        jmesh = jax_make_mesh(JaxMeshConfig(data_axis=data, model_axis=model),
                              devices=jax.devices()[:data * model])
        for src, kw in jsrc.items():
            got = jax_sharded(jnp.asarray(logits), jnp.asarray(lens), jmesh, beam_size=K,
                              max_len=T + 1, **kw)
            ref[(name, src)] = [np.asarray(g) for g in got]
    return ours, ref


@pytest.mark.parametrize("source", ["none", "table", "rnn"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_search_matches_jax(runs, mesh_name, source):
    """Every model rank of a data row returns the same rows; the rows of the
    data rows, in order, are JAX's."""
    ours, ref = runs
    by_row = ours[(mesh_name, source)]
    (data, model), _ = MESHES[mesh_name]
    assert sorted(by_row) == list(range(data))
    rows = []
    for d in range(data):
        assert sorted(by_row[d]) == list(range(model))
        first = by_row[d][0]
        for m in range(1, model):
            assert all(np.array_equal(a, b) for a, b in zip(first, by_row[d][m]))
        rows.append(first)
    toks, lens, scores = (np.concatenate(parts) for parts in zip(*rows))
    np.testing.assert_array_equal(lens, ref[(mesh_name, source)][1])
    np.testing.assert_array_equal(toks, ref[(mesh_name, source)][0])
    np.testing.assert_allclose(scores, ref[(mesh_name, source)][2], rtol=SCORE_RTOL[source],
                               atol=0)
    assert lens[2] == 0 and scores[2] == 0


def _state_at(logits, t_frames: int, table):
    """The port's plain BeamState after ``t_frames`` frames (with the table)."""
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    state = pb._init_state(B, K, T + 1, logp.device)
    kw = dict(blank=0, vocab=V, lm_table=table, lm_alpha=0.4, lm_beta=0.8, K=K, L=T + 1)
    for t in range(t_frames):
        state, _ = pb._step(state, logp[:, t], t < torch.tensor(LENS), **kw)
    return state, logp


@pytest.mark.parametrize("frame", [1, 7])
def test_plain_merge_matches_jax_fused_merge(frame):
    """One frame's candidates from JAX's ``_build_candidates`` (an early frame,
    where most beams are dead, and a later one): the plain merge and JAX's
    K10 in interpret mode pick the same live candidates, every field.  JAX's
    kernel may fill dead picks with other candidates (it re-scans work
    arrays set to NEG_INF), so the dead ones are compared by score only."""
    import jax.numpy as jnp

    from pytorch_asr_tpu.decoding.prefix_beam import BeamState as JaxBeamState
    from pytorch_asr_tpu.decoding.prefix_beam import _build_candidates as jax_build
    from pytorch_asr_tpu.ops import runtime as jax_runtime
    from pytorch_asr_tpu.ops.beam_pallas import merge_topk_fused

    logits, _, table, _, _ = _inputs()
    state, logp = _state_at(logits, frame, torch.from_numpy(table))
    jstate = JaxBeamState(*(jnp.asarray(x.numpy()) for x in state))
    stay, ext = jax_build(jstate, jnp.asarray(logp[:, frame].numpy()), blank=0, vocab=V,
                          lm_table=jnp.asarray(table), lm_alpha=0.4, lm_beta=0.8, K=K, L=T + 1)
    ours = pb._merge_topk({k: torch.from_numpy(np.array(v)) for k, v in stay.items()},
                          {**{k: torch.from_numpy(np.array(v)) for k, v in ext.items()},
                           "chars": torch.from_numpy(np.array(ext["append"]))}, K)
    jax_runtime.force_interpret(True)
    try:
        ref = merge_topk_fused(stay, ext, K)
    finally:
        jax_runtime.force_interpret(None)
    score, ref_score = ours[0].numpy(), np.asarray(ref[0])
    live = score > pb.NEG_INF / 2
    assert live.any() and not live.all()            # row 2 has no frames: 6 live
    np.testing.assert_array_equal(score[live], ref_score[live])
    assert (ref_score[~live] <= pb.NEG_INF / 2).all()
    for name in ("pb", "pnb", "lm", "hash", "ctx", "last", "parent", "append"):
        np.testing.assert_array_equal(ours[1][name].numpy()[live], np.asarray(ref[1][name])[live],
                                      err_msg=name)


def test_model_axis_1_delegates():
    logits, lens, table, _, _ = _inputs()
    args = (torch.from_numpy(logits), torch.from_numpy(lens))
    one = pmesh.Mesh(data=1, model=1, data_index=0, model_index=0)
    kw = dict(beam_size=K, max_len=T + 1, lm_table=torch.from_numpy(table), lm_alpha=0.4,
              lm_beta=0.8)
    got = prefix_beam_search_sharded(*args, one, **kw)
    want = pb.prefix_beam_search(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("model,kwargs,err", [
    (3, {}, ValueError), (2, {"hash_lm": object()}, TypeError)])
def test_what_the_sharded_search_does_not_take_raises(model, kwargs, err):
    """A beam that the model axis does not divide (8 over 3), and a hashed
    LM that is not a ``HashedNgramLM``, raise before any collective."""
    logits, lens, _, _, _ = _inputs()
    mesh = pmesh.Mesh(data=1, model=model, data_index=0, model_index=0)
    with pytest.raises(err):
        prefix_beam_search_sharded(torch.from_numpy(logits), torch.from_numpy(lens), mesh,
                                   beam_size=K, **kwargs)


@pytest.mark.parametrize("source", ["table", "rnn"])
def test_lm_top_k_changes_nothing_without_a_hashed_lm(source):
    """``lm_top_k`` prunes only a hashed LM's lookups: with a dense table or
    the RNN LM the port's tokens are those without it, and JAX's with it."""
    import jax
    import jax.numpy as jnp

    from pytorch_asr_tpu.decoding.prefix_beam import prefix_beam_search as jax_search
    from pytorch_asr_tpu_torch import weights

    logits, lens, table, jlm, params = _inputs()
    if source == "table":
        ours_kw = {"lm_table": torch.from_numpy(table), "lm_alpha": 0.4, "lm_beta": 0.8}
        jax_kw = {"lm_table": jnp.asarray(table), "lm_alpha": 0.4, "lm_beta": 0.8}
    else:
        lm = CharRNNLM(RNNLMConfig(**LM_CFG), V)
        lm.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
        ours_kw = {"rnn_lm": lm.eval(), "lm_alpha": 0.3, "lm_beta": 0.5, "sos_id": SOS}
        jax_kw = {"rnn_lm": jlm, "rnn_lm_params": params, "lm_alpha": 0.3, "lm_beta": 0.5,
                  "sos_id": SOS}
    args = (torch.from_numpy(logits), torch.from_numpy(lens))
    got = pb.prefix_beam_search(*args, beam_size=K, max_len=T + 1, lm_top_k=4, **ours_kw)
    plain = pb.prefix_beam_search(*args, beam_size=K, max_len=T + 1, **ours_kw)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    ref = jax_search(jnp.asarray(logits), jnp.asarray(lens), beam_size=K, max_len=T + 1,
                     lm_top_k=4, **jax_kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=SCORE_RTOL["rnn"])


TINY = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "4,4", "model.compute_dtype": "float32",
        "data.batch_size": "4", "data.synthetic_num_utts": "6",
        "data.synthetic_max_sec": "2.0", "decode.auto_buckets": "1"}


@pytest.mark.parametrize("key,value", [("decode.shard_beams", "true"),
                                       ("decode.lm_top_k", "4")])
def test_one_rank_decode_is_unchanged_by(key, value):
    """``decode.shard_beams`` with one rank (model axis 1) takes the normal
    search, as the JAX driver does; ``lm_top_k`` without a hashed LM changes
    nothing.  Both decode exactly as without them."""
    cfg = get_config("ctc_bilstm_beam_lm", **TINY)
    model = build_model(cfg, "cpu")
    want = driver.decode_dataset(cfg, model, max_batches=1)
    got = driver.decode_dataset(get_config("ctc_bilstm_beam_lm", **TINY, **{key: value}),
                                model, max_batches=1)
    assert {k: v for k, v in got.items() if k != "decode_rtf"} == \
        {k: v for k, v in want.items() if k != "decode_rtf"}
