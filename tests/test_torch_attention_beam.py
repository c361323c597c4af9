"""The port's attention and joint CTC/attention beam searches and CTC prefix
scorer against the JAX package on the CPU, at the tiny widths of
``tests/test_attention_beam.py`` (encoder H 24 x 1, decoder E 12 / H 24 / A
16, location 5 x 4), float32, the same weights loaded through
``weights.load_jax_params``.

Tokens and lengths are exact and scores within ``SCORE_RTOL``.  Each search
test first asserts that the best beam of every row leads the runner-up by
more than ``MARGIN`` on its inputs, so that a numerical drift shows as a
margin failure rather than a silent flip.  Then the JAX package's own
invariants (beam 1 is stepwise greedy, early exit does not depend on
``max_len``) and the decode CLI on both methods.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.configs.base import BiLSTMEncoderConfig as JaxEncoderConfig
from pytorch_asr_tpu.configs.base import FrontendConfig as JaxFrontendConfig
from pytorch_asr_tpu.configs.base import LASDecoderConfig as JaxDecoderConfig
from pytorch_asr_tpu.configs.base import ModelConfig as JaxModelConfig
from pytorch_asr_tpu.decoding import ctc_prefix_scorer as jax_cps
from pytorch_asr_tpu.decoding.attention_beam import attention_beam_search as jax_search
from pytorch_asr_tpu.models.asr_model import ASRModel as JaxASRModel
from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig
from pytorch_asr_tpu.ops.ce import make_decoder_io as jax_make_decoder_io
from pytorch_asr_tpu_torch import decode, train, weights
from pytorch_asr_tpu_torch.configs import base
from pytorch_asr_tpu_torch.data import get_tokenizer
from pytorch_asr_tpu_torch.decoding import attention_beam
from pytorch_asr_tpu_torch.decoding import ctc_prefix_scorer as cps
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.las_decoder import DecoderState
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig

TOK = get_tokenizer("char")
V = TOK.vocab_size
SOS, EOS = TOK.sos_id, TOK.eos_id
ENC = dict(conv_channels=(8,), hidden_dim=24, num_layers=1, dropout=0.0)
DEC = dict(embed_dim=12, hidden_dim=24, attention_dim=16, location_kernel=5, location_filters=4)
# float32 on both sides; the encoders' FFTs and products and the scorer's
# cumsum sum in other orders (a few ulps of the scores, which are sums of
# tens of log-probs).
SCORE_RTOL = 1e-5
SCORER_TOL = 1e-5
# The best final score (a per-char mean of log-probs) must lead the
# runner-up by this much on every row: 10x the scores' tolerance.
MARGIN = 1e-4
SHARPEN = 8.0
BEAM, MAX_LEN = 4, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed: int):
    """(JAX module, JAX params, port model, audio, audio_len), the weights
    from JAX's init; the second row is shorter than the first."""
    cfg = JaxModelConfig(encoder=JaxEncoderConfig(**ENC), decoder=JaxDecoderConfig(**DEC),
                         ctc_weight=0.3, compute_dtype="float32")
    jmodel = JaxASRModel(JaxFrontendConfig(use_pallas=False), cfg, V)
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
    audio_len = np.array([8000, 6000], np.int32)
    dec_in, _, dec_len = jax_make_decoder_io(jnp.asarray([[1, 2], [3, 4]], jnp.int32),
                                             jnp.asarray([2, 2]), SOS, EOS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(audio),
                                  jnp.asarray(audio_len), targets=dec_in,
                                  target_len=dec_len)["params"]
    # Sharper output rows than the initialiser's make the searches decisive.
    params["las"]["w_out"] = params["las"]["w_out"] * SHARPEN
    pcfg = base.ModelConfig(encoder=base.BiLSTMEncoderConfig(**ENC),
                            decoder=base.LASDecoderConfig(**DEC), ctc_weight=0.3,
                            compute_dtype="float32")
    model = ASRModel(base.FrontendConfig(), pcfg, V)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, params)))
    return jmodel, params, model.eval(), audio, audio_len


@pytest.fixture(scope="module")
def pair():
    """The shared model and both encoders' outputs on its batch."""
    jmodel, params, model, audio, audio_len = _model(0)
    jout = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(audio), jnp.asarray(audio_len))
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.from_numpy(audio_len))
    return jmodel, params, model, jout, out


def _lm_table(seed: int) -> np.ndarray:
    """A random trigram table: (V^2, V) rows of log-probs."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((V * V, V)).astype(np.float32) * 2
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))


def _rnn_lm(seed: int):
    jlm = JaxCharRNNLM(JaxRNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=1), V)
    params = jlm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    lm = CharRNNLM(RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=1), V)
    lm.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
    return jlm, params, lm.eval()


def _run_both(pair, enc_len=None, **kw):
    """The JAX search and the port's (its best beams and all final scores)
    on the pair's encoder outputs; ``kw`` in the port's spelling."""
    jmodel, params, model, jout, out = pair
    jlen = jout["enc_len"] if enc_len is None else jnp.asarray(enc_len)
    plen = out["enc_len"] if enc_len is None else torch.as_tensor(enc_len)
    jkw = dict(kw)
    if kw.get("ctc_weight"):
        jkw["ctc_logits"], kw["ctc_logits"] = jout["ctc_logits"], out["ctc_logits"]
    if "lm_table" in kw:
        jkw["lm_table"], kw["lm_table"] = jnp.asarray(kw["lm_table"]), torch.from_numpy(
            kw["lm_table"])
    if "rnn_lm" in kw:
        jlm, jlm_params, lm = kw["rnn_lm"]
        jkw.update(rnn_lm=jlm, rnn_lm_params=jlm_params)
        kw["rnn_lm"] = lm
    jt, jl, js = jax_search(jmodel, params, jout["enc"], jlen, SOS, EOS, beam_size=BEAM,
                            max_len=MAX_LEN, **jkw)
    with torch.no_grad():
        beams = attention_beam.final_beams(model, out["enc"], plen, SOS, EOS, beam_size=BEAM,
                                           max_len=MAX_LEN, **kw)
        t, l, s = attention_beam.attention_beam_search(model, out["enc"], plen, SOS, EOS,
                                                       beam_size=BEAM, max_len=MAX_LEN, **kw)
    return (np.asarray(jt), np.asarray(jl), np.asarray(js)), (t.numpy(), l.numpy(), s.numpy()), \
        beams[2].numpy()


def _check(ref, got, final, decisive=slice(None)):
    top2 = np.sort(final[decisive], axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    assert (margin > MARGIN).all(), f"near-tie inputs: best-vs-second margins {margin}"
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=SCORE_RTOL)
    assert np.isfinite(got[2]).all()


@pytest.mark.parametrize("case", ["attention", "joint", "dense_lm", "rnn_lm", "coverage",
                                  "joint_rnn_lm_coverage"])
def test_search_matches_jax(pair, case):
    kw = {"attention": {}, "joint": dict(ctc_weight=0.3),
          "dense_lm": dict(lm_table=_lm_table(1), lm_alpha=0.5),
          "rnn_lm": dict(rnn_lm=_rnn_lm(2), lm_alpha=0.5),
          "coverage": dict(coverage_beta=0.5, coverage_tau=0.05),
          "joint_rnn_lm_coverage": dict(ctc_weight=0.3, rnn_lm=_rnn_lm(3), lm_alpha=0.3,
                                        coverage_beta=0.2, coverage_tau=0.05)}[case]
    _check(*_run_both(pair, **kw))


def test_joint_search_with_an_empty_row(pair):
    """A row of enc_len 0: uniform attention over T in the decoder, and a
    scorer whose frames are all masked; its scores stay finite and match.
    Its candidates all carry 0.3 x the sentinel, which absorbs the decoder's
    log-probs, so they tie and the tie order alone picks its beams: the
    margin is asserted on the other row only."""
    _, _, _, jout, _ = pair
    enc_len = np.array([int(jout["enc_len"][0]), 0], np.int32)
    ref, got, final = _run_both(pair, enc_len=enc_len, ctc_weight=0.3)
    _check(ref, got, final, decisive=slice(0, 1))


def test_beam1_equals_stepwise_greedy(pair):
    """Beam 1 at length norm 0 is the greedy decode, step by step through
    ``decoder_step`` (blank and sos masked)."""
    _, _, model, _, out = pair
    with torch.no_grad():
        toks, lens, _ = attention_beam.attention_beam_search(
            model, out["enc"], out["enc_len"], SOS, EOS, beam_size=1, max_len=12,
            length_norm=0.0)
        enc_projed, mask, state = model.decoder_begin(out["enc"], out["enc_len"])
        y = torch.full((2,), SOS)
        done = torch.zeros(2, dtype=torch.bool)
        greedy = [[], []]
        for _ in range(12):
            logits, state = model.decoder_step(out["enc"], enc_projed, mask, y, state)
            lp = torch.log_softmax(logits, -1)
            lp[:, 0] = lp[:, SOS] = -1e30
            nxt = lp.argmax(-1)
            for b in range(2):
                if not done[b]:
                    done[b] = bool(nxt[b] == EOS)
                    if not done[b]:
                        greedy[b].append(int(nxt[b]))
            y = torch.where(done, EOS, nxt)
            if done.all():
                break
    for b in range(2):
        assert toks[b, : lens[b]].tolist() == greedy[b]


class _EosAfterK:
    """A fake decoder that prefers char 2 for ``k`` steps and eos after
    (its step count rides in c[0, :, 0]); counts its steps."""

    def __init__(self, k: int, vocab: int = 8, eos: int = 3):
        self.k, self.vocab, self.eos, self.steps = k, vocab, eos, 0

    def decoder_begin(self, enc, enc_len):
        BK, T, D = enc.shape
        state = DecoderState(h=torch.zeros(1, BK, 4), c=torch.zeros(1, BK, 4),
                             att=torch.zeros(BK, T), ctx=torch.zeros(BK, D))
        return enc, torch.arange(T)[None, :] < enc_len[:, None], state

    def decoder_step(self, enc, enc_projed, enc_mask, y, state):
        self.steps += 1
        count = state.c[0, :, 0]
        want = torch.where(count >= self.k, self.eos, 2)
        logits = torch.nn.functional.one_hot(want, self.vocab).float() * 50.0
        c = state.c.clone()
        c[0, :, 0] += 1
        att = torch.nn.functional.one_hot(torch.clamp(count.long(), max=state.att.shape[1] - 1),
                                          state.att.shape[1]).float()
        return logits, state._replace(c=c, att=att)


def test_early_exit_does_not_depend_on_max_len():
    """Every beam ends within a few steps of the k + 1 a hypothesis needs;
    16x the ``max_len`` changes nothing, and the loop stops as early."""
    enc, enc_len = torch.ones(2, 12, 6), torch.tensor([12, 9])
    kw = dict(sos_id=1, eos_id=3, beam_size=4, length_norm=1.0, coverage_beta=1e-3,
              coverage_tau=0.5)
    short, long_ = _EosAfterK(3), _EosAfterK(3)
    t1, l1, s1 = attention_beam.attention_beam_search(short, enc, enc_len, max_len=8, **kw)
    t2, l2, s2 = attention_beam.attention_beam_search(long_, enc, enc_len, max_len=128, **kw)
    assert l1.tolist() == l2.tolist() == [3, 3]
    assert torch.equal(t1, t2[:, :8]) and not t2[:, 8:].any()
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)
    assert short.steps == long_.steps < 8


# ------------------------------------------------------------------ CTC scorer

def _brute(logp: np.ndarray, seq, exact: bool) -> float:
    """log P(collapse(path) starts with / equals seq) by enumerating paths."""
    T, Vs = logp.shape
    p = np.exp(logp.astype(np.float64))
    total = 0.0
    for path in itertools.product(range(Vs), repeat=T):
        col, prev = [], -1
        for c in path:
            if c != prev and c != 0:
                col.append(c)
            prev = c
        if (tuple(col) == tuple(seq)) if exact else (tuple(col[: len(seq)]) == tuple(seq)):
            total += np.prod([p[t, c] for t, c in enumerate(path)])
    return float(np.log(total))


@pytest.mark.parametrize("seed", [0, 1])
def test_scorer_matches_jax_and_brute_force(seed):
    """psi of one and two chars and the eos slot against path enumeration
    (T 5, blank, chars 1 and 2, eos 3), and every output against JAX's."""
    rng = np.random.default_rng(seed)
    T, Vs, eos, K = 5, 4, 3, 2
    logits = rng.standard_normal((1, T, Vs)).astype(np.float32)
    logits[:, :, eos] = -15.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    lens = np.array([T], np.int32)
    tlogp, tlens = torch.from_numpy(logp), torch.from_numpy(lens)
    state = cps.init_state(tlogp, tlens, K)
    jstate = jax_cps.init_state(jnp.asarray(logp), jnp.asarray(lens), K)
    last = np.full((1, K), -1, np.int32)
    delta, rn, rb = cps.score_extensions(state, tlogp, tlens, torch.from_numpy(last), eos)
    jdelta, jrn, jrb = jax_cps.score_extensions(jstate, jnp.asarray(logp), jnp.asarray(lens),
                                                jnp.asarray(last), eos)
    for got, ref in ((delta, jdelta), (rn, jrn), (rb, jrb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCORER_TOL, atol=SCORER_TOL)
    for c in (1, 2):
        np.testing.assert_allclose(float(delta[0, 0, c]), _brute(logp[0], (c,), False),
                                   rtol=1e-4, atol=1e-5)
    chosen = np.array([[1, 1]], np.int32)
    state1 = cps.select_extension(rn, rb, state, delta, torch.tensor([[0, 1]]),
                                  torch.from_numpy(chosen), torch.ones((1, K), dtype=torch.bool))
    jstate1 = jax_cps.select_extension(jrn, jrb, jstate, jdelta, jnp.asarray(chosen))
    for got, ref in zip(state1, jstate1):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCORER_TOL, atol=SCORER_TOL)
    delta1, _, _ = cps.score_extensions(state1, tlogp, tlens, torch.from_numpy(chosen), eos)
    for c in (1, 2):
        want = _brute(logp[0], (1, c), False) - _brute(logp[0], (1,), False)
        np.testing.assert_allclose(float(delta1[0, 0, c]), want, rtol=1e-4, atol=1e-4)
    want_eos = _brute(logp[0], (1,), True) - _brute(logp[0], (1,), False)
    np.testing.assert_allclose(float(delta1[0, 0, eos]), want_eos, rtol=1e-4, atol=1e-4)
    assert float(delta1[0, 0, 0]) == np.float32(cps.NEG_INF)


def _by_parent(x, parent: np.ndarray, axis: int) -> np.ndarray:
    """x reordered along its beam axis ``axis`` (the one after B) by parent (B, K)."""
    idx = np.expand_dims(parent, tuple(range(axis - 1)))
    return np.take_along_axis(np.asarray(x), idx.reshape(idx.shape + (1,) * (x.ndim - axis - 1)),
                              axis=axis)


def test_scorer_ragged_and_empty_rows_match_jax():
    """Rows of 9, 4 and 0 frames over a 9-frame buffer: every beam extends
    the empty prefix by its own char, then the beams are reordered and only
    some extend (one by its parent's last char), as JAX's search does around
    ``select_extension``; each state and the scores after it against JAX's,
    and finite."""
    rng = np.random.default_rng(4)
    B, T, K = 3, 9, 3
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((B, T, V)).astype(np.float32) * 2), -1))
    lens = np.array([9, 4, 0], np.int32)
    tlogp, tlens, jlogp, jlens = (torch.from_numpy(logp), torch.from_numpy(lens),
                                  jnp.asarray(logp), jnp.asarray(lens))
    state, jstate = cps.init_state(tlogp, tlens, K), jax_cps.init_state(jlogp, jlens, K)
    first = np.array([[1, 5, 7], [2, 3, 4], [3, 6, 8]], np.int32)
    d0, rn0, rb0 = cps.score_extensions(state, tlogp, tlens, torch.full((B, K), -1), EOS)
    jd0, jrn0, jrb0 = jax_cps.score_extensions(jstate, jlogp, jlens, jnp.full((B, K), -1), EOS)
    state = cps.select_extension(rn0, rb0, state, d0, torch.arange(K).expand(B, K),
                                 torch.from_numpy(first), torch.ones((B, K), dtype=torch.bool))
    jstate = jax_cps.select_extension(jrn0, jrb0, jstate, jd0, jnp.asarray(first))
    parent = np.array([[2, 0, 1], [1, 2, 0], [0, 2, 1]])
    emit = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]], bool)
    chosen = np.array([[7, 9, 4], [2, 3, 5], [1, 8, 6]], np.int32)    # (0, 0) repeats 7
    d1, rn1, rb1 = cps.score_extensions(state, tlogp, tlens, torch.from_numpy(first), EOS)
    jd1, jrn1, jrb1 = jax_cps.score_extensions(jstate, jlogp, jlens, jnp.asarray(first), EOS)
    state = cps.select_extension(rn1, rb1, state, d1, torch.from_numpy(parent),
                                 torch.from_numpy(chosen), torch.from_numpy(emit))
    jkept = jax_cps.CTCScorerState(*(_by_parent(x, parent, 1) for x in jstate))
    jsel = jax_cps.select_extension(_by_parent(jrn1, parent, 2), _by_parent(jrb1, parent, 2),
                                    jkept, _by_parent(jd1, parent, 1), jnp.asarray(chosen))
    jstate = jax_cps.CTCScorerState(*(
        np.where(emit.reshape(emit.shape + (1,) * (k.ndim - 2)), np.asarray(s), k)
        for s, k in zip(jsel, jkept)))
    last = np.where(emit, chosen, _by_parent(first, parent, 1))
    got = (*state, *cps.score_extensions(state, tlogp, tlens, torch.from_numpy(last), EOS))
    ref = (*jstate, *jax_cps.score_extensions(jstate, jlogp, jlens, jnp.asarray(last), EOS))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=SCORER_TOL, atol=SCORER_TOL)


# ------------------------------------------------------------------------ CLI

@pytest.mark.parametrize("config,method", [("las_attention", "attention_beam"),
                                           ("joint_ctc_attention_960h", "joint_beam")])
def test_decode_cli_on_the_cpu(config, method, tmp_path, capsys):
    argv = [config, "device=cpu", "model.encoder.hidden_dim=16", "model.encoder.num_layers=1",
            "model.encoder.conv_channels=4,4", "model.decoder.embed_dim=8",
            "model.decoder.hidden_dim=16", "model.decoder.attention_dim=8",
            "model.decoder.location_kernel=5", "model.decoder.location_filters=2",
            "model.compute_dtype=float32", "data.synthetic_num_utts=4", "data.batch_size=2",
            "data.synthetic_max_sec=2.0", "decode.beam_size=3", "decode.max_decode_len=6",
            "decode.auto_buckets=1", "max_batches=1", f"dump_path={tmp_path / 'd'}",
            f"train.checkpoint_dir={tmp_path / 'none'}"]
    result = decode.main(argv)
    assert str(result) in capsys.readouterr().out
    assert result["method"] == method and result["num_utts"] == 2
    assert np.isfinite(result["wer"]) and result["decode_rtf"] > 0
    assert (tmp_path / "d.hyp.tsv").read_text().count("\n") == 2


@pytest.mark.parametrize("cli", [decode, train])
@pytest.mark.parametrize("config", ["las_attention", "joint_ctc_attention_960h"])
def test_entry_points_refuse_a_missing_card(cli, config, monkeypatch):
    """Without ``device=cpu`` both CLIs ask for CUDA and raise where there is
    none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main([config, "max_batches=1"] if cli is decode else [config, "steps=1"])
