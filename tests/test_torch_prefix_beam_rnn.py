"""The port's RNN-LM shallow fusion against the JAX package's, on the CPU at
small sizes: the plain search (``decoding/prefix_beam.py`` with ``rnn_lm``)
against JAX's ``lax.scan`` (``prefix_beam_search(use_fused=False)``) and its
K9 kernel ``prefix_beam_fused_lanes_topa_rnn`` in interpret mode, over all
chars and over each frame's top-A, with 1 and 2 LM layers and an empty row;
and config 2's decode with an ``.npz`` LM against JAX's ``decode_eval``.

Tokens and lengths must be equal, scores within SCORE_RTOL.  On the CPU the
port takes its plain search; the card's K9 is held to the same plain search
in ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import difflib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
from pytorch_asr_tpu.decoding.prefix_beam import prefix_beam_search as jax_search
from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig
from pytorch_asr_tpu.ops import runtime as jax_runtime
from pytorch_asr_tpu.ops.beam_pallas import prefix_beam_fused_lanes_topa_rnn
from pytorch_asr_tpu.training.state import eval_params as jax_eval_params
from pytorch_asr_tpu.training.trainer import Trainer as JaxTrainer
from pytorch_asr_tpu_torch import decode, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.decoding import driver
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.evaluate import build_model
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, build
from pytorch_asr_tpu_torch.training import lm as port_lm

# float32 on both sides: XLA's and torch's LM products, exp and log round
# apart (a few ulp a frame), and the JAX restricted scan adds the fusion
# term as (lm_s + alpha row) + beta where the port adds lm_s + (alpha row + beta).
SCORE_RTOL = SCORE_ATOL = 1e-5
B, T, V, K, L = 2, 14, 31, 8, 20
SOS = 29
ALPHA, BETA = 0.4, 0.7
TINY = {"model.encoder.hidden_dim": "32", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
        "model.compute_dtype": "float32", "frontend.specaugment": "false",
        "data.batch_size": "4", "data.synthetic_num_utts": "8",
        "data.synthetic_max_sec": "2.5", "decode.auto_buckets": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lm(nl: int, seed: int = 0):
    """(port model, JAX module, JAX params) with the same weights (JAX's init)."""
    jmodel = JaxCharRNNLM(JaxRNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=nl), V)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    model = CharRNNLM(RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=nl), V)
    model.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
    return model, jmodel, params


def _logits(seed: int, lens=(T, 0)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, V)).astype(np.float32) * 2,
            np.array(lens, np.int32))


def _port(logits, lens, model, A=0, **kw):
    out = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                beam_size=kw.pop("K", K), max_len=L, ext_top_a=A,
                                rnn_lm=model, sos_id=SOS, lm_alpha=ALPHA, lm_beta=BETA, **kw)
    return [o.numpy() for o in out]


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours[1], np.asarray(ref[1]))
    for b in range(ours[0].shape[0]):
        n = int(ours[1][b])
        np.testing.assert_array_equal(ours[0][b, :n], np.asarray(ref[0])[b, :n])
    np.testing.assert_allclose(ours[2], np.asarray(ref[2]), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("A", [0, 8])
@pytest.mark.parametrize("nl", [1, 2])
def test_plain_matches_jax_scan(nl, A):
    model, jmodel, params = _lm(nl, nl)
    logits, lens = _logits(nl)
    ref = jax_search(jnp.asarray(logits), jnp.asarray(lens), beam_size=K, max_len=L,
                     ext_top_a=A, rnn_lm=jmodel, rnn_lm_params=params, lm_alpha=ALPHA,
                     lm_beta=BETA, sos_id=SOS, use_fused=False)
    ours = _port(logits, lens, model, A)
    _assert_same(ours, ref)
    assert ours[1][0] > 0 and ours[1][1] == 0 and ours[2][1] == 0.0


def test_plain_matches_jax_scan_with_nine_layers():
    """An LM of 9 layers (E 8, H 16) over 20 frames, past the 8 layers K9's
    kernel once held: the port's plain search, what the card's K9 is held
    to, against JAX's scan."""
    model, jmodel, params = _lm(9, 9)
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((B, 20, V)).astype(np.float32) * 2
    lens = np.array([20, 11], np.int32)
    ref = jax_search(jnp.asarray(logits), jnp.asarray(lens), beam_size=K, max_len=L,
                     rnn_lm=jmodel, rnn_lm_params=params, lm_alpha=ALPHA, lm_beta=BETA,
                     sos_id=SOS, use_fused=False)
    ours = _port(logits, lens, model)
    _assert_same(ours, ref)
    assert ours[1][0] > 0 and ours[1][1] > 0


@pytest.fixture
def interpret():
    jax_runtime.force_interpret(True)
    yield
    jax_runtime.force_interpret(None)


# The interpreter runs the kernel op by op in Python, unrolled over beams
# and layers: two cases at K 4 over one 8-frame chunk, the top-A search with
# 2 layers and the search over all chars (top_a = V) with 1 layer.
@pytest.mark.parametrize("A,nl", [(8, 2), (V, 1)])
def test_plain_matches_jax_kernel(interpret, A, nl):
    model, jmodel, params = _lm(nl, 3)
    logits, lens = _logits(3, (8, 5))
    logits = logits[:, :8]
    ref = prefix_beam_fused_lanes_topa_rnn(
        jnp.asarray(logits), jnp.asarray(lens), jmodel, params, beam_size=4, max_len=L,
        top_a=A, lm_alpha=ALPHA, lm_beta=BETA, sos_id=SOS)
    _assert_same(_port(logits, lens, model, A if A < V else 0, K=4), ref)


@pytest.mark.parametrize("A", [V, V + 5])
def test_ext_top_a_at_least_vocab_is_the_unrestricted_search(A):
    model, _, _ = _lm(1, 4)
    logits, lens = _logits(4)
    ref = _port(logits, lens, model)
    for a, b in zip(_port(logits, lens, model, A), ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def toy_lm():
    """The port's LM trained on the toy corpus of tests/test_rnn_lm.py."""
    texts = ["the cat sat on the mat", "the dog ate the bone", "a cat and a dog",
             "the cat and the dog sat"] * 4
    model, _ = port_lm.train_rnn_lm(texts, RNNLMConfig(embed_dim=16, hidden_dim=32,
                                                       num_layers=1),
                                    steps=150, batch_size=8, max_len=32, lr=3e-3, seed=0)
    return model


def test_fusion_pulls_a_near_tie_toward_the_lm_likely_string(toy_lm):
    """Weak acoustic evidence for "the cat": the fused search lands at least
    as close to it as the search without the LM (tests/test_rnn_lm.py)."""
    from pytorch_asr_tpu_torch.data.tokenizer import CharTokenizer

    tok = CharTokenizer()
    ids = [int(i) for i in tok.encode("the cat")]
    rng = np.random.default_rng(42)
    logits = rng.standard_normal((1, len(ids), V)).astype(np.float32)
    logits[0, np.arange(len(ids)), ids] += 3.0
    lens = torch.tensor([len(ids)], dtype=torch.int32)
    args = (torch.from_numpy(logits), lens)
    fused = pb.prefix_beam_search(*args, beam_size=8, max_len=16, rnn_lm=toy_lm,
                                  sos_id=tok.sos_id, lm_alpha=0.5, lm_beta=0.0)
    plain = pb.prefix_beam_search(*args, beam_size=8, max_len=16)

    def dist(out):
        text = tok.decode(out[0][0, : int(out[1][0])].tolist())
        return 1.0 - difflib.SequenceMatcher(None, text, "the cat").ratio()

    assert dist(fused) <= dist(plain)
    assert fused[2][0] != plain[2][0]


def test_cpu_tensors_take_the_plain_search_without_launches():
    model, _, _ = _lm(2, 5)
    logits, lens = _logits(5)
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    h0, c0, lmp0 = pb.primed_lm_state(model, SOS)
    assert h0.shape == c0.shape == (2, 16) and lmp0.shape == (V,)
    build.reset_launches()
    got = beam_cuda.prefix_beam_rnn(logp, torch.from_numpy(lens), K, L, model, h0, c0, lmp0,
                                    ALPHA, BETA)
    want = pb.beam_scan_plain(logp, torch.from_numpy(lens), K, L, None, ALPHA, BETA,
                              rnn_lm=model, lm_state=(h0, c0, lmp0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(build.LAUNCHES.values())


def test_carry_init_primes_every_beam_with_sos():
    model, jmodel, params = _lm(2, 6)
    from pytorch_asr_tpu.decoding.prefix_beam import rnn_lm_carry_init as jax_carry_init

    ours = pb.rnn_lm_carry_init(model, 2, 3, SOS)
    ref = jax_carry_init(jmodel, params, 2, 3, V, SOS)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kwargs,err", [
    ({"lm_top_k": 4, "hash_lm": object()}, ValueError),
    ({"hash_lm": object()}, ValueError),
    ({"lm_table": torch.zeros(V, V)}, ValueError)])
def test_what_the_rnn_lm_does_not_combine_with_raises(kwargs, err):
    model, _, _ = _lm(1)
    logits, lens = _logits(0)
    with pytest.raises(err):
        _port(logits, lens, model, **kwargs)


@pytest.fixture(scope="module")
def lm_npz(tmp_path_factory):
    """A 1-layer LM (JAX's init) written by the port's save."""
    path = tmp_path_factory.mktemp("rnnlm") / "lm.npz"
    model, _, _ = _lm(1, 8)
    port_lm.save_rnn_lm(str(path), model)
    return str(path)


def test_decode_cli_matches_jax_decode_eval(lm_npz, tmp_path):
    """Config 2 at tiny widths with the same weights and the same ``.npz``
    LM: the port's ``decode.main`` on the CPU and JAX's ``decode_eval``
    write the same hypotheses on the same 1-bucket decode ladder."""
    overrides = {**TINY, "decode.lm_path": lm_npz}
    jcfg = jax_get_config("ctc_bilstm_beam_lm", **overrides)
    trainer = JaxTrainer(jcfg, dataset=jax_build_dataset(jcfg.data, jcfg.frontend.sample_rate),
                         enable_checkpoints=False)
    ref = trainer.decode_eval(dump_path=str(tmp_path / "jax"))
    params = tmp_path / "params.npz"
    np.savez(params, **weights.flatten(jax.tree.map(np.asarray, jax_eval_params(trainer.state))))
    argv = ["ctc_bilstm_beam_lm", *(f"{k}={v}" for k, v in overrides.items()), "device=cpu",
            f"params={params}", f"dump_path={tmp_path / 'port'}"]
    got = decode.main(argv)
    for key in ("method", "wer", "cer", "num_utts", "padding_efficiency_decode"):
        assert got[key] == ref[key], key
    for suffix in (".ref.tsv", ".hyp.tsv"):
        assert (tmp_path / f"port{suffix}").read_text() == \
            (tmp_path / f"jax{suffix}").read_text()
    assert got["num_utts"] == 8


def test_load_lm_returns_the_rnn_lm_on_the_device(lm_npz):
    cfg = get_config("ctc_bilstm_beam_lm", **{**TINY, "decode.lm_path": lm_npz})
    lm = driver.load_lm(cfg, torch.device("cpu"))
    assert isinstance(lm, CharRNNLM) and not lm.training
    assert lm.cfg == RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=1)
    result = driver.decode_dataset(cfg, build_model(cfg, "cpu"), max_batches=1)
    assert result["method"] == "prefix_beam" and result["num_utts"] >= 1
    # lm_top_k prunes only a hashed LM's lookups: with the RNN LM it changes
    # nothing, as in the JAX package.
    pruned = get_config("ctc_bilstm_beam_lm", **{**TINY, "decode.lm_path": lm_npz,
                                                 "decode.lm_top_k": "4"})
    got = driver.decode_dataset(pruned, build_model(pruned, "cpu"), max_batches=1)
    assert {k: v for k, v in got.items() if k != "decode_rtf"} == \
        {k: v for k, v in result.items() if k != "decode_rtf"}
