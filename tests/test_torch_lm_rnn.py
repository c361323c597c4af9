"""The port's char RNN LM, its trainer, its ``.npz`` file and the ``train_lm``
CLI against the JAX package's, on the CPU at small widths (E 8-16, H 16-32,
1 and 2 layers): the same batches for a seed, the same forward and step
log-probs from the same parameters, the same train step (loss, then the
parameters after the clip and adam), and ``.npz`` files that load both ways.
"""

from __future__ import annotations

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
from pytorch_asr_tpu.models.lm_rnn import LMState as JaxLMState
from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig
from pytorch_asr_tpu.models.lm_rnn import lm_step_logp as jax_lm_step_logp
from pytorch_asr_tpu.training import lm as jax_lm
from pytorch_asr_tpu_torch import train_lm, weights
from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, LMState, RNNLMConfig, lm_step_logp
from pytorch_asr_tpu_torch.training import lm as port_lm

TOK = CharTokenizer()
V = TOK.vocab_size
# The toy corpus of tests/test_rnn_lm.py.
TEXTS = ["the cat sat on the mat", "the dog ate the bone",
         "a cat and a dog", "the cat and the dog sat"] * 4
# float32 on both sides; XLA's and torch's CPU products sum in other orders.
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(nl: int, E: int = 8, H: int = 16, seed: int = 0):
    """(port model, JAX module, JAX params) holding the same weights, drawn by
    the JAX package's init."""
    jmodel = JaxCharRNNLM(JaxRNNLMConfig(embed_dim=E, hidden_dim=H, num_layers=nl), V)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    model = CharRNNLM(RNNLMConfig(embed_dim=E, hidden_dim=H, num_layers=nl), V)
    model.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
    return model, jmodel, params


def _ids(seed: int, B: int = 3, U: int = 9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(B, U)).astype(np.int32)
    ids[:, 0] = TOK.sos_id
    return ids


def test_lm_batches_match_jax():
    ours = port_lm.lm_batches(TEXTS + [" ", "it's"], 5, 12, seed=3)
    ref = jax_lm.lm_batches(TEXTS + [" ", "it's"], 5, 12, seed=3)
    for _ in range(4):
        for a, b in zip(next(ours), next(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nl", [1, 2])
def test_forward_and_step_logp_match_jax(nl):
    model, jmodel, params = _pair(nl, E=12, H=24, seed=nl)
    ids = _ids(nl)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    rng = np.random.default_rng(nl)
    h = rng.standard_normal((nl, 3, 24)).astype(np.float32) * 0.5
    c = rng.standard_normal((nl, 3, 24)).astype(np.float32)
    y = ids[:, 4]
    with torch.no_grad():
        logp, st = lm_step_logp(model, torch.from_numpy(y),
                                LMState(torch.from_numpy(h), torch.from_numpy(c)))
    jlogp, jst = jax_lm_step_logp(jmodel, params, jnp.asarray(y),
                                  JaxLMState(jnp.asarray(h), jnp.asarray(c)))
    for a, b in ((logp, jlogp), (st.h, jst.h), (st.c, jst.c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("nl", [1, 2])
def test_train_step_matches_jax(nl):
    """One step from the same parameters and batch: the loss, then the
    parameters after the global-norm clip and adam (lr 1e-3, float32)."""
    model, jmodel, params = _pair(nl, E=8, H=16, seed=4)
    batch = next(jax_lm.lm_batches(TEXTS, 6, 32, seed=1))
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    step = jax_lm.make_lm_train_step(jmodel, tx)
    new_params, _, jloss = step(params, tx.init(params), *map(jnp.asarray, batch))

    loss = port_lm.train_step(model, port_lm.lm_optimizer(model, 1e-3), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = {k: np.asarray(v) for k, v in new_params.items()}
    assert got.keys() == want.keys()
    for k in want:
        # adam's first update is lr * g / (|g| + eps): ulp-level gradient
        # differences move a coordinate by at most a few 1e-8 here.
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert max(np.abs(got[k] - np.asarray(params[k])).max() for k in want) > 5e-4


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    _, jmodel, params = _pair(2, E=8, H=16, seed=5)
    path = str(tmp_path / "jax_lm.npz")
    jax_lm.save_rnn_lm(path, jmodel.cfg, params)
    model = port_lm.load_rnn_lm(path)
    assert model.cfg == RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=2)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(params[k]))
    ids = _ids(5)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": params}, ids)),
                               rtol=0, atol=ATOL)


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    model = CharRNNLM(RNNLMConfig(embed_dim=16, hidden_dim=32, num_layers=1), V, seed=7)
    path = str(tmp_path / "port_lm.npz")
    port_lm.save_rnn_lm(path, model)
    jmodel, params = jax_lm.load_rnn_lm(path)
    assert jmodel.cfg == JaxRNNLMConfig(embed_dim=16, hidden_dim=32, num_layers=1)
    state = model.state_dict()
    assert set(params) == set(state)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(v), state[k].numpy())


def test_init_follows_the_jax_tree():
    """Same names, shapes and initializer families as JAX's init."""
    model, _, params = _pair(2, E=8, H=16)
    fresh = CharRNNLM(RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=2), V, seed=1)
    state = fresh.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    wh = state["lstm1_wh"]
    torch.testing.assert_close(wh @ wh.T, torch.eye(16), rtol=0, atol=1e-5)
    assert not state["lstm0_b"].any() and not state["b_out"].any()
    assert 0.01 < float(state["embed"].std()) < 0.03
    assert float(state["lstm0_wx"].abs().max()) <= (6 / (8 + 64)) ** 0.5


def test_load_jax_rnn_lm_rejects_other_trees():
    with pytest.raises(KeyError, match="ctc_head"):
        weights.load_jax_rnn_lm({"embed": np.zeros((V, 4)), "ctc_head": {"bias": np.zeros(3)}})


def test_train_rnn_lm_learns_the_toy_corpus():
    model, nll = port_lm.train_rnn_lm(
        TEXTS, RNNLMConfig(embed_dim=16, hidden_dim=32, num_layers=1), steps=150,
        batch_size=8, max_len=32, lr=3e-3, seed=0)
    # uniform over 31 chars is log(31) ~ 3.43; the toy corpus is predictable
    assert nll < 1.5, nll


def test_train_lm_cli_writes_a_jax_readable_lm(tmp_path, capsys):
    out = tmp_path / "lm.npz"
    record = train_lm.main([str(out), "device=cpu", "steps=4", "embed_dim=8", "hidden_dim=16",
                            "num_layers=1", "batch_size=4", "max_len=24", "log_every=2",
                            "synthetic_num_utts=16"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["event"] for x in lines] == ["lm_train", "lm_train", "lm_saved"]
    assert lines[-1] == record and set(record) == {"event", "path", "steps", "num_texts",
                                                  "nll", "ppl"}
    assert record["steps"] == 4 and record["num_texts"] == 16
    assert np.isfinite(record["nll"])
    jmodel, _ = jax_lm.load_rnn_lm(str(out))
    assert jmodel.cfg.hidden_dim == 16 and jmodel.cfg.num_layers == 1


def test_train_lm_cli_exits_on_unknown_keys_before_training(tmp_path):
    out = tmp_path / "lm.npz"
    with pytest.raises(SystemExit, match="hiden_dim"):
        train_lm.main([str(out), "device=cpu", "hiden_dim=16"])
    assert not out.exists()
