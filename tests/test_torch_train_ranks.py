"""Training across ranks on the CPU: gloo ranks started by ``launch.spawn``
(one job of 2 ranks and one of 4) against the JAX package's one-device train
step on the whole global batch, its Pallas kernels in interpret mode (as
``tests/test_tp_directions.py`` runs them).

Arms, each two steps from the same parameters, float32, dropout 0,
SpecAugment off, SGD (whose moves are linear in the gradients, so the
parameters after two steps compare as tightly as the gradients do):
config 1 over 2 data ranks; config 1 split by directions over 2 model
ranks; config 3 split by blocks over 2 and 4 model ranks; configs 1 and 3
over data 2 x model 2.  The global batch has a pad row in the second data
rank's half only and unequal token counts, so a rank that divided by its
own rows or labels would fail.  Then, with dropout and SpecAugment on, every
rank's parameters bit-equal after the steps; ``train.main`` across 2 ranks,
resumed to more steps (each data rank's stream position restored); the
refusals; the data shards; the mesh record's shardings against JAX's; the
per-chip throughput.  The ranks run this module's functions, which import
no JAX.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch import train, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import MeshConfig
from pytorch_asr_tpu_torch.data import build_dataset, load_corpus_for
from pytorch_asr_tpu_torch.parallel import distributed, launch, sharding
from pytorch_asr_tpu_torch.parallel import mesh as pmesh
from pytorch_asr_tpu_torch.training import state as port_state
from pytorch_asr_tpu_torch.training.metrics import Throughput
from pytorch_asr_tpu_torch.training.trainer import Trainer

CPU = torch.device("cpu")
TINY1 = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
         "model.encoder.conv_channels": "4,4"}
TINY3 = {"model.encoder.channels": "16", "model.encoder.num_blocks": "2",
         "model.encoder.dilation_cycle": "1,2"}
COMMON = {"model.compute_dtype": "float32", "frontend.specaugment": "false",
          "model.encoder.dropout": "0.0", "data.batch_size": "8",
          "data.synthetic_num_utts": "16", "data.synthetic_max_sec": "2.0",
          "data.auto_buckets": "1", "train.optim.optimizer": "sgd",
          "train.optim.peak_lr": "1e-3", "train.optim.warmup_steps": "1"}
CONFIGS = {"bilstm": ("ctc_bilstm_dev1h", TINY1), "tcn": ("tcn_ctc_devclean", TINY3)}
# (config, data axis, model axis) of each arm and the world it runs in.
ARMS = {2: {"data2": ("bilstm", 2, 1), "directions": ("bilstm", 1, 2),
            "tcn_model2": ("tcn", 1, 2)},
        4: {"tcn_model4": ("tcn", 1, 4), "data2_directions": ("bilstm", 2, 2),
            "data2_tcn_model2": ("tcn", 2, 2)}}
STEPS = 2
# float32 on both sides: the frontends, convolutions, recursions and the
# gradient sums over rows (split over ranks here) add in other orders.
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
# A parameter's move over two SGD steps, relative to its largest move:
# against JAX, and against the port's one-rank step on the global batch (the
# same kernels' plain versions; only the sums over rows and ranks differ, a
# few float32 units of the parameters themselves).
# The conv front end's gradients reach it through both LSTM directions' bf16
# residuals, which JAX's kernel and the port's round at other points
# (``chip_smoke.py``'s STEP_CONV_GRAD_TOL holds them to 5e-3 likewise).
MOVE_TOL = 1e-3
FRONT_MOVE_TOL = 5e-3
ONE_RANK_MOVE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(kind: str, data: int = 1, model: int = 1, **extra):
    name, tiny = CONFIGS[kind]
    return get_config(name, **{**COMMON, **tiny, "mesh.data_axis": str(data),
                               "mesh.model_axis": str(model), **extra})


def _global_batches(kind: str) -> list[dict]:
    """Two global batches of 8: the second data rank's half (rows 4-7) of
    each holds a pad row; the token counts differ row to row."""
    cfg = _cfg(kind)
    out = []
    for seed in range(STEPS):
        b = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=seed))
        b["audio_len"][6] = b["token_len"][6] = 0
        b["audio"][6] = 0.0
        b["tokens"][6] = 0
        out.append(b)
    return out


def _run_arm(kind: str, data: int, model: int, state: dict, batches: list[dict],
             **extra) -> dict:
    """This rank's two steps of one arm: its rows of each global batch."""
    cfg = _cfg(kind, data, model, **extra)
    mesh = pmesh.make_mesh(cfg.mesh, batch_size=cfg.data.batch_size)
    m = port_state.build_model(cfg, CPU)
    if state is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    st = port_state.init_train_state(cfg, m, mesh)
    recs = []
    for b in batches:
        rows = pmesh.shard_batch_global(mesh, b)
        with pmesh.use_mesh(mesh):
            aux = port_state.train_step(cfg, st, port_state.batch_to_device(rows, CPU))
        recs.append({k: float(aux[k]) for k in ("loss", "ctc_loss", "grad_norm")})
    return {"records": recs, "params": {k: v.numpy().copy() for k, v in m.state_dict().items()},
            "place": (mesh.data_index, mesh.model_index), "split": sorted(st.split)}


def _rank_job(world: int, states: dict, batches: dict, ckpt: str) -> dict:
    distributed.initialize("cpu")
    out = {f"parity_{arm}": _run_arm(kind, d, mdl, states[kind], batches[kind])
           for arm, (kind, d, mdl) in ARMS[world].items()}
    if world != 2:
        return out
    # Dropout and SpecAugment on: the ranks' parameters stay bit-equal.
    noisy = {"model.encoder.dropout": "0.2", "frontend.specaugment": "true"}
    for arm, (kind, d, mdl) in ARMS[2].items():
        out[f"noisy_{arm}"] = _run_arm(kind, d, mdl, None, batches[kind], **noisy)
    try:
        Trainer(_cfg("bilstm", 1, 2, **{"model.encoder.bidirectional": "false"}),
                enable_checkpoints=False, device="cpu")
        out["gate_dims"] = None
    except NotImplementedError as e:
        out["gate_dims"] = str(e)
    # 17 utterances: shard 0 holds 9 (3 batches an epoch), shard 1 holds 8 (2).
    argv = ["ctc_bilstm_dev1h", "device=cpu", "train.eval_every=2", "train.log_every=1",
            "mesh.data_axis=2",
            *(f"{k}={v}" for k, v in {**COMMON, **TINY1, **noisy,
                                      "data.synthetic_num_utts": "17"}.items())]
    resumed = [f"train.checkpoint_dir={ckpt}/resumed", f"metrics_path={ckpt}/resumed/m.jsonl"]
    out["main"] = train.main(argv + resumed + ["steps=3"])
    out["resumed"] = train.main(argv + resumed + ["steps=5"])
    out["straight"] = train.main(argv + ["steps=5", f"train.checkpoint_dir={ckpt}/straight"])
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's initial parameters (as the port's state_dict) and
    its two steps on the whole global batches, in interpret mode."""
    import jax
    import jax.numpy as jnp

    from pytorch_asr_tpu.configs import get_config as jax_get_config
    from pytorch_asr_tpu.ops import runtime
    from pytorch_asr_tpu.training import state as jax_state

    out = {}
    for kind, (name, tiny) in CONFIGS.items():
        jcfg = jax_get_config(name, **{**COMMON, **tiny})
        batches = _global_batches(kind)
        jmodel = jax_state.build_model(jcfg)
        # The parameters do not depend on the kernels' route: a jitted XLA
        # init is one compile, not an interpret-mode forward op by op.
        jst = jax.jit(functools.partial(jax_state.init_train_state, jcfg, jmodel))(batches[0])
        init = weights.load_jax_params(jax.tree.map(np.asarray, jst.params))
        runtime.force_interpret(True)
        try:
            step = jax.jit(jax_state.make_train_step(jcfg, jmodel))
            recs = []
            for b in batches:
                jst, aux = step(jst, {k: jnp.asarray(v) for k, v in b.items()})
                recs.append({k: float(aux[k]) for k in ("loss", "ctc_loss", "grad_norm")})
        finally:
            runtime.force_interpret(None)
        out[kind] = {"init": init, "batches": batches, "records": recs,
                     "params": weights.load_jax_params(jax.tree.map(np.asarray, jst.params))}
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def ranks(jax_ref, ckpt):
    states = {k: {n: t.numpy() for n, t in v["init"].items()} for k, v in jax_ref.items()}
    batches = {k: v["batches"] for k, v in jax_ref.items()}
    return {world: launch.spawn(_rank_job, world, world, states, batches, str(ckpt),
                                timeout=300.0)
            for world in (2, 4)}


def _arms():
    return [(world, arm) for world, arms in ARMS.items() for arm in arms]


@pytest.fixture(scope="module")
def one_rank(jax_ref):
    """The port's own two steps on the whole global batches, in this process."""
    return {kind: _run_arm(kind, 1, 1, {k: t.numpy() for k, t in ref["init"].items()},
                           ref["batches"])
            for kind, ref in jax_ref.items()}


def _close_moves(got: dict, want: dict, init: dict, tol: float, front_tol: float, what: str):
    """Each parameter's move within ``tol`` of the largest wanted move, plus
    two float32 units of the parameter (a move is a difference of two
    rounded parameters)."""
    for name, w in want.items():
        moved, want_moved = got[name] - init[name], w - init[name]
        scale = max(float(np.abs(want_moved).max()), 1e-12)
        t = front_tol if name.startswith("encoder.conv.") else tol
        bound = t * scale + 2 * np.spacing(np.abs(w))
        bad = np.abs(moved - want_moved) > bound
        assert not bad.any(), (f"{what} {name}: {int(bad.sum())} of {bad.size} moves off, "
                               f"worst {float(np.abs(moved - want_moved).max())} against "
                               f"{t} x {scale}")


@pytest.mark.parametrize("world,arm", _arms())
def test_ranks_match_jax_on_the_global_batch(ranks, jax_ref, one_rank, world, arm):
    """Every rank's logged loss and grad_norm are JAX's on the global batch,
    and its parameters after two steps are JAX's, and the port's one-rank
    run's closer still."""
    kind = ARMS[world][arm][0]
    ref = jax_ref[kind]
    init = {k: t.numpy() for k, t in ref["init"].items()}
    for rank, out in enumerate(ranks[world]):
        got = out[f"parity_{arm}"]
        for rec, want in zip(got["records"], ref["records"]):
            np.testing.assert_allclose(rec["loss"], want["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(rec["ctc_loss"], want["ctc_loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(rec["grad_norm"], want["grad_norm"], rtol=GRAD_NORM_RTOL)
        _close_moves(got["params"], {k: t.numpy() for k, t in ref["params"].items()}, init,
                     MOVE_TOL, FRONT_MOVE_TOL, f"rank {rank} against JAX:")
        _close_moves(got["params"], one_rank[kind]["params"], init, ONE_RANK_MOVE_TOL,
                     ONE_RANK_MOVE_TOL, f"rank {rank} against one rank:")


@pytest.mark.parametrize("phase", ["parity", "noisy"])
def test_every_rank_holds_the_same_parameters(ranks, phase):
    """After every multi-rank run each rank's parameters are bit-equal to
    rank 0's (with dropout and SpecAugment on in the noisy runs)."""
    for world, runs in ranks.items():
        for arm in ARMS[world]:
            key = f"{phase}_{arm}"
            if key not in runs[0]:
                continue
            first = runs[0][key]["params"]
            for rank, out in enumerate(runs[1:], 1):
                for name, v in out[key]["params"].items():
                    assert np.array_equal(v, first[name]), (world, arm, rank, name)


def test_ranks_sit_on_the_mesh_and_split_their_mode(ranks):
    for world, runs in ranks.items():
        for arm, (kind, data, model) in ARMS[world].items():
            for rank, out in enumerate(runs):
                got = out[f"parity_{arm}"]
                assert got["place"] == (rank // model, rank % model)
                split = got["split"]
                if model == 1:
                    assert split == []
                elif kind == "bilstm":
                    assert split and all(".layers." in n for n in split)
                else:
                    assert split and all(".blocks." in n for n in split)


def test_noisy_runs_differ_from_the_quiet_ones(ranks):
    """The masks were drawn: dropout and SpecAugment moved the parameters
    elsewhere than the quiet run."""
    for arm in ARMS[2]:
        quiet, noisy = ranks[2][0][f"parity_{arm}"], ranks[2][0][f"noisy_{arm}"]
        assert quiet["records"][0]["loss"] != noisy["records"][0]["loss"], arm


def test_gate_dims_raises_naming_roadmap(ranks):
    for out in ranks[2]:
        assert out["gate_dims"] is not None and "ROADMAP" in out["gate_dims"]


def test_train_main_across_ranks_resumes_each_position(ranks, ckpt):
    """``train.main`` over 2 data ranks, dropout and SpecAugment on: 3 steps,
    then a resume to 5, ends where 5 straight steps end, bit for bit (each
    data rank's stream position and generator restored); the iterator file
    holds both ranks' positions, which differ (shards of 9 and 8
    utterances); rank 0 alone logs, the mesh record first."""
    for key, steps in (("main", 3), ("resumed", 5), ("straight", 5)):
        runs = [out[key]["train"] for out in ranks[2]]
        assert [r["step"] for r in runs] == [steps, steps]
        assert runs[0]["loss"] == runs[1]["loss"], key
    assert ranks[2][0]["resumed"]["train"]["loss"] == ranks[2][0]["straight"]["train"]["loss"]
    assert ranks[2][0]["main"]["eval"]["num_utts"] == 17
    positions = [json.loads((ckpt / run / "iterator_5.json").read_text())
                 for run in ("resumed", "straight")]
    assert positions[0] == positions[1]
    assert positions[0]["data_axis"] == 2
    assert positions[0]["positions"][0] != positions[0]["positions"][1]
    records = [json.loads(line) for line in (ckpt / "resumed" / "m.jsonl").read_text().splitlines()]
    assert records[0]["event"] == "mesh"
    assert records[0]["layout"] == {"data": 2, "model": 1} and records[0]["sharded_params"] == []
    assert [r["step"] for r in records if r["event"] == "train"] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("kind", ["bilstm", "tcn"])
def test_describe_shardings_equals_jax(kind, model_axis):
    """The port's ``describe_shardings`` over its parameters names what JAX's
    names over its tree, for ``RULES`` and ``DIRECTION_TP_RULES``."""
    import jax

    from pytorch_asr_tpu.configs import get_config as jax_get_config
    from pytorch_asr_tpu.parallel import sharding as jax_sharding
    from pytorch_asr_tpu.parallel.mesh import make_mesh
    from pytorch_asr_tpu.training import state as jax_state

    name, tiny = CONFIGS[kind]
    jcfg = jax_get_config(name, **{**COMMON, **tiny})
    batch = _global_batches(kind)[0]
    jparams = jax.jit(functools.partial(jax_state.init_train_state, jcfg,
                                        jax_state.build_model(jcfg)))(batch).params
    model = port_state.build_model(_cfg(kind), CPU)
    jmesh = make_mesh(MeshConfig(model_axis=model_axis))
    mesh = pmesh.Mesh(1, model_axis, 0, 0)
    for rules in (None, jax_sharding.DIRECTION_TP_RULES):
        want = jax_sharding.describe_shardings(jparams, jmesh, rules)
        port_rules = None if rules is None else sharding.DIRECTION_TP_RULES
        got = sharding.describe_shardings(model.named_parameters(), mesh, port_rules)
        assert got == {k: tuple(v) for k, v in want.items()}
        assert got or rules is not None     # RULES shard something of either model


def test_data_shards_cover_the_corpus_once():
    """Shard d of D holds records [d::D], as grain's ``ds[d::D]``: the shards'
    union is the corpus, each record once; each batches data.batch_size / D
    on the whole corpus's buckets."""
    cfg = _cfg("bilstm", **{"data.synthetic_num_utts": "11"})
    corpus = load_corpus_for(cfg.data, cfg.frontend.sample_rate)
    whole = build_dataset(cfg.data, cfg.frontend.sample_rate)
    for D in (2, 4):
        seen = []
        for d in range(D):
            ds = build_dataset(cfg.data, cfg.frontend.sample_rate, num_shards=D, shard_index=d)
            assert ds.batch_size == 8 // D and ds.buckets == whole.buckets
            assert list(ds._corpus.indices) == list(range(d, len(corpus), D))
            for bi, chunk in ds.epoch_plan(seed=0):
                seen += [ds._corpus.indices[i] for i, _, _ in chunk]
        assert sorted(seen) == list(range(len(corpus)))
    with pytest.raises(ValueError):
        build_dataset(cfg.data, cfg.frontend.sample_rate, num_shards=3, shard_index=0)


def test_tp_mode_picks_jax_modes_and_refuses_gate_dims():
    assert sharding.tp_mode(_cfg("bilstm"), pmesh.Mesh(2, 1, 0, 0)) is None
    assert sharding.tp_mode(_cfg("bilstm"), pmesh.Mesh(1, 2, 0, 0)) == "directions"
    assert sharding.tp_mode(_cfg("tcn"), pmesh.Mesh(1, 4, 0, 0)) == "tcn_pallas"
    for cfg, m in ((_cfg("bilstm"), 4), (_cfg("tcn"), 3),
                   (_cfg("bilstm", **{"model.encoder.bidirectional": "false"}), 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sharding.tp_mode(cfg, pmesh.Mesh(1, m, 0, 0))


def test_throughput_divides_by_data_times_model():
    tp = Throughput(num_chips=4, total=lambda a: 2 * a)
    tp.update(10.0)
    one = Throughput()
    one.update(10.0)
    v, w = tp.value(), one.value()
    assert v["audio_seconds_per_sec_per_chip"] < w["audio_seconds_per_sec_per_chip"] / 1.9
    tp._t0 = one._t0 = 0.0
    ratio = (tp.value()["audio_seconds_per_sec_per_chip"]
             / one.value()["audio_seconds_per_sec_per_chip"])
    np.testing.assert_allclose(ratio, 2 / 4, rtol=1e-6)
