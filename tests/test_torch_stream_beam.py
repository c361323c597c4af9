"""Streaming beam mode on the CPU: the port's carried prefix beam search
(``decoding/prefix_beam.py``: ``prefix_beam_init``, ``prefix_beam_continue``,
``beam_best``) and ``StreamingRecognizer(mode="beam")`` against the port's
own offline search and against the JAX package.

At JAX's test sizes (``tests/test_streaming.py``): B 2, beam 4, max_len 48
and 6 (where beams fill), V 12; the streaming model's conv (8, 8) and
unidirectional LSTM H 32 x 2 in float32, its params loaded into the port
through ``weights.load_jax_params``; a char RNN LM of E 8, H 16 (JAX's init,
loaded through ``weights.load_jax_rnn_lm``) and a dense order-3 table of
JAX's ``train_char_ngram``.  On the CPU the search's wrappers take the plain
carried search; the card's carried kernels are held to it and to their own
offline forms in ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.configs.base import BiLSTMEncoderConfig as JaxEncoderConfig
from pytorch_asr_tpu.configs.base import DataConfig as JaxDataConfig
from pytorch_asr_tpu.configs.base import DecodeConfig as JaxDecodeConfig
from pytorch_asr_tpu.configs.base import ExperimentConfig as JaxExperimentConfig
from pytorch_asr_tpu.configs.base import FrontendConfig as JaxFrontendConfig
from pytorch_asr_tpu.configs.base import ModelConfig as JaxModelConfig
from pytorch_asr_tpu.data.tokenizer import CharTokenizer
from pytorch_asr_tpu.decoding import prefix_beam as jax_pb
from pytorch_asr_tpu.decoding import streaming as jax_streaming
from pytorch_asr_tpu.decoding.lm import tensorize, train_char_ngram
from pytorch_asr_tpu.models.asr_model import ASRModel as JaxASRModel
from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig
from pytorch_asr_tpu_torch import weights
from pytorch_asr_tpu_torch.configs.base import (
    BiLSTMEncoderConfig,
    DataConfig,
    DecodeConfig,
    ExperimentConfig,
    FrontendConfig,
    ModelConfig,
)
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding.streaming import StreamingRecognizer, init_stream_state
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig

VOCAB, K = 12, 4
B, T = 3, 24
SOS = VOCAB - 1
ALPHA, BETA = 0.4, 0.2
TOP_A = 5
# tests/test_torch_prefix_beam.py's and test_torch_prefix_beam_rnn.py's:
# float32 on both sides, XLA's and torch's log-sum-exp, LM products and
# log-softmax round apart by a few ulps a frame; and JAX's restricted scan
# adds the fusion term as (lm_s + alpha row) + beta where the port adds
# lm_s + (alpha row + beta).
SCORE_RTOL = SCORE_ATOL = 1e-5
ENC = dict(conv_channels=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), hidden_dim=32,
           num_layers=2, dropout=0.0, use_pallas=False, bidirectional=False, causal_conv=True)
# Chunk splits of the T frames: single frames, uneven cuts, and cuts in
# which a row (lengths 24, 17, 5) freezes mid-chunk or has no valid frame.
SPLITS = {"frames": (1,) * T, "uneven": (3, 8, 13), "freeze": (7, 7, 10), "one": (T,)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    """(port RNN LM, JAX module, JAX params, dense table (n_ctx, VOCAB))."""
    jmodel = JaxCharRNNLM(JaxRNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=1), VOCAB)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    model = CharRNNLM(RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=1), VOCAB)
    model.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
    tok = CharTokenizer()
    lm = train_char_ngram(["the cat sat on the mat", "a dog and a cat"], order=3, tokenizer=tok)
    table = np.ascontiguousarray(tensorize(lm, tok)[:, :VOCAB])
    return model.eval(), jmodel, params, table


def _logp(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, VOCAB)).astype(np.float32) * 2)
    return torch.log_softmax(x, dim=-1), torch.tensor([T, 17, 5], dtype=torch.int32)


def _source(lms, source: str) -> dict:
    rnn, _, _, table = lms
    if source == "none":
        return {}
    kw = dict(lm_alpha=ALPHA, lm_beta=BETA)
    if source == "dense":
        return {**kw, "lm_table": torch.from_numpy(table)}
    return {**kw, "rnn_lm": rnn}


def _chunks(logp, lens, cuts):
    t0 = 0
    for n in cuts:
        yield logp[:, t0:t0 + n], torch.clamp(lens - t0, 0, n).to(torch.int32)
        t0 += n


@pytest.mark.parametrize("L", [48, 6])
@pytest.mark.parametrize("A", [0, TOP_A])
@pytest.mark.parametrize("source", ["none", "dense", "rnn"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_plain_carried_search_over_chunks_equals_offline(lms, split, source, A, L):
    """Chunks of the carried search give the offline search's state on
    every beam, bit for bit: each BeamState and LMCarry field, dead beams
    included; and ``beam_best`` gives the offline ``beam_scan_plain``'s best."""
    logp, lens = _logp()
    kw = dict(_source(lms, source), ext_top_a=A)
    carry = pb.rnn_lm_carry_init(lms[0], B, K, SOS) if source == "rnn" else None
    state = pb.prefix_beam_init(B, K, L)
    want, want_carry = pb.prefix_beam_continue(state, logp, lens, lm_carry=carry, **kw)
    for part, n_valid in _chunks(logp, lens, SPLITS[split]):
        state, carry = pb.prefix_beam_continue(state, part, n_valid, lm_carry=carry, **kw)
    for name, got, ref in zip(pb.BeamState._fields, state, want):
        assert torch.equal(got, ref), name
    if source == "rnn":
        for name, got, ref in zip(pb.LMCarry._fields, carry, want_carry):
            assert torch.equal(got, ref), name
    top = pb.top_a(logp, A) if A else (None, None)
    primed = pb.primed_lm_state(lms[0], SOS) if source == "rnn" else None
    offline = pb.beam_scan_plain(logp, lens, K, L, kw.get("lm_table"), kw.get("lm_alpha", 0.0),
                                 kw.get("lm_beta", 0.0), *top, rnn_lm=kw.get("rnn_lm"),
                                 lm_state=primed)
    assert all(torch.equal(a, b) for a, b in zip(pb.beam_best(state), offline))
    # Rows 1 and 2 stop before the end; row 2's five frames fill no beam.
    assert int(state.length.max()) > 0


def _jax_chunks(lms, source: str, A: int, L: int, cuts):
    """JAX's prefix_beam_continue over the chunks: each chunk's (state, carry)."""
    logp, lens = _logp()
    _, jmodel, params, table = lms
    kw = dict(lm_alpha=ALPHA, lm_beta=BETA) if source != "none" else {}
    carry = None
    if source == "dense":
        kw["lm_table"] = jnp.asarray(table)
    elif source == "rnn":
        kw.update(rnn_lm=jmodel, rnn_lm_params=params)
        carry = jax_pb.rnn_lm_carry_init(jmodel, params, B, K, VOCAB, SOS)
    step = jax.jit(lambda st, lp, nv, c: jax_pb.prefix_beam_continue(
        st, lp, nv, lm_carry=c, ext_top_a=A, **kw))
    state, out = jax_pb.prefix_beam_init(B, K, L), []
    for part, n_valid in _chunks(logp, lens, cuts):
        state, carry = step(state, jnp.asarray(part.numpy()), jnp.asarray(n_valid.numpy()),
                            carry)
        out.append((state, carry))
    return out


@pytest.mark.parametrize("A", [0, TOP_A])
@pytest.mark.parametrize("source", ["none", "dense", "rnn"])
def test_plain_carried_search_matches_jax_prefix_beam_continue(lms, source, A):
    """After every chunk (three of 8 frames; rows of 24, 17 and 5 frames,
    L 6 so that beams fill): tokens below each beam's length, lengths,
    hashes, contexts and last chars equal JAX's; pb, pnb, lm_s and the LM
    carry within SCORE_RTOL."""
    L, cuts = 6, (8, 8, 8)
    logp, lens = _logp()
    kw = dict(_source(lms, source), ext_top_a=A)
    carry = pb.rnn_lm_carry_init(lms[0], B, K, SOS) if source == "rnn" else None
    state = pb.prefix_beam_init(B, K, L)
    for (part, n_valid), (jstate, jcarry) in zip(_chunks(logp, lens, cuts),
                                                   _jax_chunks(lms, source, A, L, cuts)):
        state, carry = pb.prefix_beam_continue(state, part, n_valid, lm_carry=carry, **kw)
        for name in ("length", "hash", "ctx", "last"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        below = np.arange(L)[None, None, :] < state.length.numpy()[..., None]
        np.testing.assert_array_equal(np.where(below, state.tokens.numpy(), 0),
                                      np.where(below, np.asarray(jstate.tokens), 0))
        for name in ("pb", "pnb", "lm_s"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=SCORE_RTOL,
                                       atol=SCORE_ATOL, err_msg=name)
        if source == "rnn":
            for name, got, ref in zip(pb.LMCarry._fields, carry, jcarry):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCORE_RTOL,
                                           atol=SCORE_ATOL, err_msg=name)
    assert int(state.length.max()) == L


def _cfgs():
    """(JAX config, port config): JAX's streaming test model, decoded by a
    prefix beam of 4 up to 48 tokens."""
    dec = dict(method="prefix_beam", beam_size=K, max_decode_len=48)
    jax_cfg = JaxExperimentConfig(
        name="streaming_test", frontend=JaxFrontendConfig(normalize=False, specaugment=False),
        data=JaxDataConfig(), decode=JaxDecodeConfig(**dec),
        model=JaxModelConfig(encoder=JaxEncoderConfig(**ENC), ctc_weight=1.0,
                             compute_dtype="float32"))
    cfg = ExperimentConfig(
        name="streaming_test", frontend=FrontendConfig(normalize=False, specaugment=False),
        data=DataConfig(), decode=DecodeConfig(**dec),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(**ENC), ctc_weight=1.0,
                          compute_dtype="float32"))
    return jax_cfg, cfg


@pytest.fixture(scope="module")
def models():
    """(JAX config, params, port config, port model, audio): JAX's beam-mode
    LM-fusion case (model key 3; 2 streams of 2 s of noise, numpy seed 7)."""
    jax_cfg, cfg = _cfgs()
    jmodel = JaxASRModel(jax_cfg.frontend, jax_cfg.model, vocab_size=VOCAB)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16000), jnp.float32),
                                  jnp.array([16000]))["params"]
    model = ASRModel(cfg.frontend, cfg.model, VOCAB)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, params)))
    audio = (np.random.default_rng(7).standard_normal((2, 2 * 16000)) * 0.3).astype(np.float32)
    return jax_cfg, params, cfg, model.eval(), audio


def _emitted(rec, audio: np.ndarray, chunk: int) -> list:
    """Every accept's output, then finish's."""
    out = [rec.accept(audio[:, off:off + chunk]) for off in range(0, audio.shape[1], chunk)]
    return out + [rec.finish()]


@pytest.mark.parametrize("source,chunk", [("dense", 3200), ("dense", 9600), ("rnn", 3200),
                                          ("rnn", 9600), ("none", 3200)])
def test_streaming_beam_recognizer_matches_jax(lms, models, source, chunk):
    """Every block's emitted best prefix and ``finish``'s equal JAX's
    StreamingRecognizer(mode="beam") with the same fusion source, or none;
    and the final prefixes equal the port's offline search over the whole
    utterance's logits."""
    jax_cfg, params, cfg, model, audio = models
    _, jlm, jparams, table = lms
    lm = _source(lms, source)
    jkw = {"none": {}, "dense": dict(lm_table=jnp.asarray(table)),
           "rnn": dict(rnn_lm=jlm, rnn_lm_params=jparams, sos_id=SOS)}[source]
    jkw.update({k: v for k, v in lm.items() if k in ("lm_alpha", "lm_beta")})
    got = _emitted(StreamingRecognizer(model, cfg, 2, mode="beam", sos_id=jkw.get("sos_id"),
                                       **lm), audio, chunk)
    want = _emitted(jax_streaming.StreamingRecognizer(params, jax_cfg, 2, mode="beam", **jkw),
                    audio, chunk)
    assert got == want
    final = got[-1]
    assert any(final), "degenerate test: nothing decoded"
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.full((2,), audio.shape[1]))
    toks, n, _ = pb.prefix_beam_search_plain(out["ctc_logits"], out["enc_len"], beam_size=K,
                                             max_len=48, sos_id=SOS, **lm)
    assert final == [toks[b, :n[b]].tolist() for b in range(2)]


def test_streaming_beam_state_reset_and_finish(models):
    """Beam mode's state: the initial beams on the model's device, ``finish``
    repeating the final prefix, and ``reset`` starting over."""
    _, _, cfg, model, audio = models
    state = init_stream_state(cfg, 2, beam=True)
    assert tuple(state.beam.tokens.shape) == (2, K, 48) and state.lm_carry is None
    assert state.beam.pb[:, 0].tolist() == [0.0, 0.0] and state.beam.hash[0].tolist() == [
        -1, -2, -3, -4]
    rec = StreamingRecognizer(model, cfg, 2, mode="beam")
    first = _emitted(rec, audio, 4000)
    assert rec.finish() == first[-1]
    with pytest.raises(RuntimeError, match="finished"):
        rec.accept(audio[:, :100])
    rec.reset()
    assert rec._best == [[], []] and rec.state.beam.length.sum() == 0
    assert _emitted(rec, audio, 4000) == first


def test_streaming_beam_refusals(lms, models):
    _, _, cfg, model, _ = models
    table = torch.from_numpy(lms[3])
    with pytest.raises(ValueError, match="mode"):
        StreamingRecognizer(model, cfg, 1, mode="joint")
    with pytest.raises(ValueError, match="beam"):
        StreamingRecognizer(model, cfg, 1, lm_table=table)
    with pytest.raises(ValueError, match="beam"):
        StreamingRecognizer(model, cfg, 1, rnn_lm=lms[0], sos_id=SOS)
    with pytest.raises(ValueError, match="sos_id"):
        StreamingRecognizer(model, cfg, 1, mode="beam", rnn_lm=lms[0])
    with pytest.raises(TypeError, match="HashedNgramLM"):
        StreamingRecognizer(model, cfg, 1, mode="beam", hash_lm=object())
    with pytest.raises(ValueError, match="one fusion source"):
        pb.prefix_beam_continue(pb.prefix_beam_init(1, K, 8), torch.zeros(1, 2, VOCAB),
                                torch.tensor([2]), lm_table=table, rnn_lm=lms[0],
                                lm_carry=pb.rnn_lm_carry_init(lms[0], 1, K, SOS))
    with pytest.raises(ValueError, match="lm_carry"):
        pb.prefix_beam_continue(pb.prefix_beam_init(1, K, 8), torch.zeros(1, 2, VOCAB),
                                torch.tensor([2]), rnn_lm=lms[0])
    bad = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, normalize=True))
    with pytest.raises(ValueError, match="normalize"):
        StreamingRecognizer(model, bad, 1, mode="beam")


def test_carry_table_order_matches_the_c_struct():
    """``ops/beam_cuda.py::carry_table`` lays the state's pointers out in
    BeamState's and LMCarry's order, before and after; the C struct the C
    entries copy them into and pass to the kernels by value
    (``csrc/prefix_beam.cu::BeamCarry``) must name the same fields in that
    order."""
    import re

    from pytorch_asr_tpu_torch.ops import beam_cuda, build

    text = (build.CSRC / "prefix_beam.cu").read_text()
    body = re.search(r"struct BeamCarry \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\*\s*(\w+)", body)
    c_names = {"tokens": "tokens", "len": "length", "pb": "pb", "pnb": "pnb", "lms": "lm_s",
               "hsh": "hash", "ctx": "ctx", "last": "last", "h": "h", "c": "c", "lmp": "logp"}
    state, lm = list(pb.BeamState._fields), list(pb.LMCarry._fields)
    want = state + [f + "_o" for f in state] + lm + [f + "_o" for f in lm]
    got = [c_names[n[:-2]] + "_o" if n.endswith("_o") else c_names[n] for n in names]
    assert got == want and len(got) == beam_cuda.CARRY_POINTERS


def test_ptxas_report_matches_a_kernel_that_gained_a_carry_flag():
    """``scripts/ptxas_report.py`` matches a kernel that gained a trailing
    template flag of false, and a parameter whose type that flag chooses,
    to the kernel before it; the flag's true form is new."""
    from pytorch_asr_tpu_torch.scripts import ptxas_report

    a = {"void k<true>(S, long long*)": "Used 64 registers"}
    b = {"void k<true, false>(S, std::conditional<false, (anonymous namespace)::BeamCarry, "
         "long long*>::type)": "Used 64 registers",
         "void k<true, true>(S, std::conditional<true, (anonymous namespace)::BeamCarry, "
         "long long*>::type)": "Used 64 registers"}
    out = ptxas_report.compare(a, b)
    assert out["matched"] == 1 and not out["differs"] and not out["gone"]
    assert out["new"] == [next(n for n in b if "<true, true>" in n)]
    # A second flag, whose parameter type is another conditional: the
    # earlier flag's conditional stays as the old name has it.
    cond = "std::conditional<false, (anonymous namespace)::BeamCarry, long long*>::type"
    a = {f"void k<true, false>(S, (anonymous namespace)::RnnLm, {cond})": "Used 64 registers"}
    b = {f"void k<true, false, false>(S, std::conditional<false, (anonymous namespace)::HashLm, "
         f"(anonymous namespace)::RnnLm>::type, {cond})": "Used 63 registers"}
    out = ptxas_report.compare(a, b)
    assert out["matched"] == 1 and not out["gone"] and not out["new"]
    assert list(out["differs"].values()) == [{"a": "Used 64 registers", "b": "Used 63 registers"}]


def test_bench_streaming_script_runs_on_the_cpu():
    """The ported script's three arms at a block size, on the CPU (every
    kernel's plain version: no launch counted)."""
    from pytorch_asr_tpu_torch.scripts import bench_streaming

    out = bench_streaming.main(["device=cpu", "B=1", "blocks=16", "chunks=6"])
    assert set(out["arms"]) == {"greedy_16", "beam_16", "beam_rnnlm_16"}
    assert all(a["p50_ms"] > 0 and a["rtf"] > 0 and a["launches"] == {}
               for a in out["arms"].values())
    with pytest.raises(ValueError, match="unknown keys"):
        bench_streaming.main(["device=cpu", "run_device=1"])
