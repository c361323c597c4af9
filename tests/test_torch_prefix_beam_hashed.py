"""Hashed n-gram fusion in the port's searches on the CPU, against the JAX
package: the plain prefix search over all pieces, over each frame's top A
(``ext_top_a``) and with ``lm_top_k``, against JAX's ``lax.scan``; the
port's host oracle (``decoding/prefix_beam_ref.py``, with ``BackoffLM`` and
``HostRNNLM``); the beam-sharded search (2 gloo ranks, K10's plain merge
with the windows); chunks of the carried search and the beam recognizer
against the offline search and JAX; the attention and joint searches with
``hash_lm``; and ``decode.main`` with ``data.vocab=bpe:`` and
``decode.lm_backend=auto`` (which picks the hashed tables) against JAX's
``decode_eval``.

The LM is the KN 4-gram over the pieces of the synthetic BPE vocab (V 135),
as config 2's BPE path builds it.  The logits plant real piece sequences, so
the searches meet the LM's higher orders and no near-tie decides.  Tokens
and lengths are exact, scores within SCORE_RTOL (the plain searches sum in
the same order: most are bit-equal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.decoding import lm as jax_lm
from pytorch_asr_tpu.decoding import lm_hashed as jh
from pytorch_asr_tpu.decoding import prefix_beam as jax_pb
from pytorch_asr_tpu.decoding.prefix_beam_ref import prefix_beam_search_ref as jax_ref
from pytorch_asr_tpu_torch import decode, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import MeshConfig
from pytorch_asr_tpu_torch.data import bpe
from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
from pytorch_asr_tpu_torch.decoding import driver, lm
from pytorch_asr_tpu_torch.decoding import lm_hashed as ph
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding.prefix_beam_ref import prefix_beam_search_ref
from pytorch_asr_tpu_torch.decoding.prefix_beam_sharded import prefix_beam_search_sharded
from pytorch_asr_tpu_torch.decoding.streaming import StreamingRecognizer
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, HostRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.parallel import distributed, launch
from pytorch_asr_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_attention_beam import pair  # noqa: F401  (fixture)
from tests.test_torch_attention_beam import BEAM, EOS, MAX_LEN, SOS, _check
from tests.test_torch_stream_beam import _emitted, models  # noqa: F401  (fixture)

TEXTS = synthetic_texts(512)
SCORE_RTOL = 1e-5
B, T, K, L = 3, 40, 6, 24
LENS = (T, 31, 0)
ALPHA, BETA = 0.8, 1.0
TOP = 16
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


def _piece_lm():
    tok = bpe.train_bpe(TEXTS, 256)
    return tok, lm.train_char_ngram_kn(TEXTS, 4, tokenizer=tok)


@pytest.fixture(scope="module")
def piece():
    """(tokenizer, BackoffLM, port's HashedNgramLM, JAX's)."""
    tok, m = _piece_lm()
    jm = jax_lm.BackoffLM(m.order, m.logprobs, m.backoffs)
    return tok, m, ph.build_hashed_lm(m, tok.vocab_size), jh.build_hashed_lm(jm, tok.vocab_size)


def _planted(tok, seed: int = 0, B: int = B, T: int = T) -> np.ndarray:
    """(B, T, V) logits: normal noise with row b's transcript planted a
    piece every other frame (+6), blanks between (+4)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, tok.vocab_size)).astype(np.float32)
    for b in range(B):
        ids = tok.encode(TEXTS[3 * b + seed] + " " + TEXTS[3 * b + seed + 1])
        for t in range(T):
            if t % 2 == 0 and t // 2 < len(ids):
                logits[b, t, ids[t // 2]] += 6.0
            else:
                logits[b, t, 0] += 4.0
    return logits


def _same(got, want, rtol=SCORE_RTOL):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=rtol, atol=0)


@pytest.mark.parametrize("kw", [{}, {"ext_top_a": TOP}, {"lm_top_k": TOP},
                                {"lm_top_k": TOP, "ext_top_a": TOP}],
                         ids=["all", "ext_top_a", "lm_top_k", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_matches_jax_scan(piece, kw, seed):
    """The port's search (its plain search on CPU tensors) and
    ``prefix_beam_search_plain`` against JAX's scan with the same tables;
    with both options ``ext_top_a`` wins, as in JAX."""
    tok, _, ours, ref = piece
    logits, lens = _planted(tok, seed), np.array(LENS, np.int32)
    args = dict(beam_size=K, max_len=L, lm_alpha=ALPHA, lm_beta=BETA, **kw)
    want = jax_pb.prefix_beam_search(jnp.asarray(logits), jnp.asarray(lens), hash_lm=ref,
                                     use_fused=False, **args)
    got = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens), hash_lm=ours,
                                **args)
    _same(got, want)
    _same(pb.prefix_beam_search_plain(torch.from_numpy(logits), torch.from_numpy(lens),
                                      hash_lm=ours, **args), got, rtol=0)
    assert (np.asarray(got[1])[:2] > 4).all() and int(got[1][2]) == 0


def test_lm_top_k_rows_are_exact_on_the_top_set_only(piece):
    """With ``lm_top_k`` the frame's top chars get the exact rows, which
    differ from the all-miss rows where a higher order hits (so the check
    can tell them apart), and every other char gets the all-miss row."""
    tok, _, ours, _ = piece
    ids = tok.encode(TEXTS[0])
    ctx = torch.tensor([[ids[:3].tolist(), [0, ids[0], ids[1]]]], dtype=torch.int32)
    exact_t = torch.tensor([[ids[3], ids[2], 5, 0, 7]], dtype=torch.int32)
    rows = pb.hashed_rows(ours, ctx, exact_t)
    full = ph.hashed_lm_logp_rows(ours, ctx)
    miss = ph.hashed_lm_allmiss_rows(ours, ctx)
    top = exact_t[0].long()
    assert torch.equal(rows[..., top], full[..., top])
    rest = torch.ones(tok.vocab_size, dtype=torch.bool)
    rest[top] = False
    assert torch.equal(rows[..., rest], miss[..., rest])
    assert not torch.equal(full[..., top], miss[..., top])


def test_host_oracle_agrees_with_the_search_and_jax_oracle(piece):
    """The port's oracle (float64 prefixes as tuples, ``BackoffLM.score``)
    gives the search's tokens with the hashed tables, and the JAX oracle's."""
    tok, m, ours, _ = piece
    logits, lens = _planted(tok, 2), np.array(LENS, np.int32)
    toks, n, _ = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                       beam_size=K, max_len=L, hash_lm=ours, lm_alpha=ALPHA,
                                       lm_beta=BETA)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    for b in range(B):
        got = prefix_beam_search_ref(logp[b], int(lens[b]), K, lm=m, lm_alpha=ALPHA,
                                     lm_beta=BETA)
        assert got == jax_ref(logp[b], int(lens[b]), K, lm=m, lm_alpha=ALPHA, lm_beta=BETA)
        assert got == toks[b, :n[b]].tolist()


def test_host_oracle_without_lm_agrees_with_the_search_and_jax_oracle(piece):
    """With no LM the port's oracle gives the JAX oracle's tokens and the
    plain search's."""
    tok = piece[0]
    logits, lens = _planted(tok, 5), np.array(LENS, np.int32)
    toks, n, _ = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                       beam_size=K, max_len=L)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    for b in range(B):
        got = prefix_beam_search_ref(logp[b], int(lens[b]), K, lm=None)
        assert got == jax_ref(logp[b], int(lens[b]), K, lm=None)
        assert got == toks[b, :n[b]].tolist()
    assert all(int(x) > 4 for x in n[:2]) and int(n[2]) == 0


def test_host_rnn_lm_matches_jax_and_drives_the_oracle():
    """``HostRNNLM`` scores a prefix as JAX's does (weights loaded from
    JAX's init), and the oracle with it gives the RNN-fused search's
    tokens."""
    from pytorch_asr_tpu.models.lm_rnn import CharRNNLM as JaxCharRNNLM
    from pytorch_asr_tpu.models.lm_rnn import HostRNNLM as JaxHostRNNLM
    from pytorch_asr_tpu.models.lm_rnn import RNNLMConfig as JaxRNNLMConfig

    V, sos = 7, 6
    jlm = JaxCharRNNLM(JaxRNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=2), V)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    model = CharRNNLM(RNNLMConfig(embed_dim=8, hidden_dim=16, num_layers=2), V)
    model.load_state_dict(weights.load_jax_rnn_lm(jax.tree.map(np.asarray, params)))
    host, jhost = HostRNNLM(model.eval(), sos), JaxHostRNNLM(jlm, params, sos)
    for prefix in ((), (1,), (1, 2, 3), (5, 5, 4, 1, 2)):
        for c in range(V):
            assert host.score(prefix, c) == pytest.approx(jhost.score(prefix, c), abs=1e-5)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 10, V)).astype(np.float32) * 3
    lens = np.array([10, 7], np.int32)
    toks, n, _ = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                       beam_size=4, max_len=11, rnn_lm=model, sos_id=sos,
                                       lm_alpha=0.5, lm_beta=0.3)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    for b in range(2):
        assert prefix_beam_search_ref(logp[b], int(lens[b]), 4, lm=host, lm_alpha=0.5,
                                      lm_beta=0.3) == toks[b, :n[b]].tolist()


def _sharded_rank(logits, lens, hash_lm) -> tuple:
    """One rank of a (data 1, model 2) mesh: its model index and rows."""
    distributed.initialize("cpu")
    mesh = pmesh.make_mesh(MeshConfig(data_axis=1, model_axis=2), batch_size=B)
    got = prefix_beam_search_sharded(torch.from_numpy(logits), torch.from_numpy(lens), mesh,
                                     beam_size=K, max_len=L, hash_lm=hash_lm, lm_alpha=ALPHA,
                                     lm_beta=BETA)
    return mesh.model_index, tuple(g.numpy() for g in got)


def test_sharded_search_with_windows_matches_jax(piece):
    """Two gloo ranks, each scoring its own beams' windows: both return the
    unsharded search's rows bit for bit, and JAX's sharded search's."""
    from pytorch_asr_tpu.configs.base import MeshConfig as JaxMeshConfig
    from pytorch_asr_tpu.decoding.prefix_beam_sharded import (
        prefix_beam_search_sharded as jax_sharded)
    from pytorch_asr_tpu.parallel.mesh import make_mesh as jax_make_mesh

    tok, _, ours, ref = piece
    logits, lens = _planted(tok, 1), np.array(LENS, np.int32)
    outs = dict(launch.spawn(_sharded_rank, 2, logits, lens, ours, timeout=RANK_TIMEOUT))
    want = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens), beam_size=K,
                                 max_len=L, hash_lm=ours, lm_alpha=ALPHA, lm_beta=BETA)
    for m in (0, 1):
        _same(outs[m], want, rtol=0)
    jmesh = jax_make_mesh(JaxMeshConfig(data_axis=1, model_axis=2), devices=jax.devices()[:2])
    jwant = jax_sharded(jnp.asarray(logits), jnp.asarray(lens), jmesh, beam_size=K, max_len=L,
                        hash_lm=ref, lm_alpha=ALPHA, lm_beta=BETA)
    _same(outs[0], jwant)


def test_merge_carries_the_window_columns(piece):
    """The merge picks each winner's window: a stay keeps its parent's, an
    extension its parent's shifted by its char (CPU: the plain merge, K10's
    plain version)."""
    tok, _, ours, _ = piece
    logp = torch.log_softmax(torch.from_numpy(_planted(tok, 0)), -1)
    state = pb._init_state(B, K, L, "cpu", 3)
    for t in range(9):
        rows = pb.hashed_rows(ours, state.ctx)
        stay, ext = pb._build_candidates(state, logp[:, t], blank=0, vocab=tok.vocab_size,
                                         lm_table=None, lm_rows=rows, lm_alpha=ALPHA,
                                         lm_beta=BETA, K=K, L=L)
        _, f = pb._merge_topk(stay, ext, K)
        parent = f["parent"].long()
        base = torch.gather(state.ctx, 1, parent[..., None].expand(B, K, 3))
        rolled = ph.roll_context_window(base, f["append"].clamp(min=0))
        want = torch.where((f["append"] >= 0)[..., None], rolled, base)
        assert torch.equal(f["ctx"], want) and f["ctx"].shape == (B, K, 3)
        state = pb._finish_step(state, f, t < torch.tensor(LENS), L)
    assert (state.ctx[0] != 0).any()


@pytest.mark.parametrize("kw", [{}, {"ext_top_a": TOP}, {"lm_top_k": TOP}],
                         ids=["all", "ext_top_a", "lm_top_k"])
def test_chunked_carried_search_equals_offline_and_jax(piece, kw):
    """``prefix_beam_continue`` over uneven chunks from windows of width 3
    gives the offline search's state bit for bit, and JAX's
    ``prefix_beam_continue``'s tokens and windows."""
    tok, _, ours, ref = piece
    logits, lens = _planted(tok, 0), torch.tensor(LENS, dtype=torch.int32)
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = dict(lm_alpha=ALPHA, lm_beta=BETA, **kw)
    state = pb.prefix_beam_init(B, K, L, ctx_width=3)
    jstate = jax_pb.prefix_beam_init(B, K, L, ctx_width=3)
    t0 = 0
    for n in (7, 1, 13, 19):
        blk = logp[:, t0:t0 + n]
        nv = torch.clamp(lens - t0, 0, n).to(torch.int32)
        state = pb.prefix_beam_continue(state, blk, nv, hash_lm=ours, **args)[0]
        jstate = jax_pb.prefix_beam_continue(jstate, jnp.asarray(blk.numpy()),
                                             jnp.asarray(nv.numpy()), hash_lm=ref, **args)[0]
        t0 += n
    whole = pb.beam_best(state)
    _same(whole, pb.prefix_beam_search(torch.from_numpy(logits), lens, beam_size=K, max_len=L,
                                       hash_lm=ours, **args), rtol=0)
    _same(whole, jax_pb.beam_best(jstate))
    live = (pb._lse(state.pb, state.pnb) > pb.NEG_INF / 2).numpy()
    np.testing.assert_array_equal(state.ctx.numpy()[live], np.asarray(jstate.ctx)[live])
    with pytest.raises(ValueError, match="windows"):
        pb.prefix_beam_continue(pb.prefix_beam_init(B, K, L), logp[:, :2], lens, hash_lm=ours)


@pytest.mark.parametrize("chunk", [3200, 9600])
def test_streaming_beam_recognizer_with_hashed_lm_matches_jax(models, chunk):  # noqa: F811
    """JAX's streaming test model in beam mode with a hashed char 3-gram:
    every block's best prefix equals JAX's recognizer's, and the final one
    the port's offline search over the utterance's logits."""
    from pytorch_asr_tpu.decoding import streaming as jax_streaming
    from tests.test_torch_stream_beam import K as SK
    from tests.test_torch_stream_beam import VOCAB

    jax_cfg, params, cfg, model, audio = models
    m = lm.train_char_ngram_kn(TEXTS[:200], 3)
    ours = ph.build_hashed_lm(m, VOCAB)
    ref = jh.build_hashed_lm(jax_lm.BackoffLM(m.order, m.logprobs, m.backoffs), VOCAB)
    got = _emitted(StreamingRecognizer(model, cfg, 2, mode="beam", hash_lm=ours, lm_alpha=0.4,
                                       lm_beta=0.2), audio, chunk)
    want = _emitted(jax_streaming.StreamingRecognizer(params, jax_cfg, 2, mode="beam",
                                                      hash_lm=ref, lm_alpha=0.4, lm_beta=0.2),
                    audio, chunk)
    assert got == want and any(got[-1])
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.full((2,), audio.shape[1]))
    toks, n, _ = pb.prefix_beam_search_plain(out["ctc_logits"], out["enc_len"], beam_size=SK,
                                             max_len=48, hash_lm=ours, lm_alpha=0.4, lm_beta=0.2)
    assert got[-1] == [toks[b, :n[b]].tolist() for b in range(2)]


@pytest.mark.parametrize("case", ["attention", "joint"])
def test_attention_searches_with_hashed_lm_match_jax(pair, case):  # noqa: F811
    """The attention and joint searches with a hashed char 4-gram (eos
    trained in): JAX's tokens, lengths and scores."""
    from pytorch_asr_tpu.decoding.attention_beam import attention_beam_search as jax_search
    from pytorch_asr_tpu_torch.decoding import attention_beam

    jmodel, params, model, jout, out = pair
    m = lm.train_char_ngram_kn(TEXTS[:200], 4, include_eos=True)
    ours = ph.build_hashed_lm(m, 31)
    ref = jh.build_hashed_lm(jax_lm.BackoffLM(m.order, m.logprobs, m.backoffs), 31)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, lm_alpha=0.5)
    jkw, pkw = dict(kw), dict(kw)
    if case == "joint":
        jkw.update(ctc_logits=jout["ctc_logits"], ctc_weight=0.3)
        pkw.update(ctc_logits=out["ctc_logits"], ctc_weight=0.3)
    jt, jl, js = jax_search(jmodel, params, jout["enc"], jout["enc_len"], SOS, EOS, hash_lm=ref,
                            **jkw)
    with torch.no_grad():
        beams = attention_beam.final_beams(model, out["enc"], out["enc_len"], SOS, EOS,
                                           hash_lm=ours, **pkw)
        t, n, s = attention_beam.attention_beam_search(model, out["enc"], out["enc_len"], SOS,
                                                       EOS, hash_lm=ours, **pkw)
    _check((np.asarray(jt), np.asarray(jl), np.asarray(js)), (t.numpy(), n.numpy(), s.numpy()),
           beams[2].numpy())
    plain = attention_beam.attention_beam_search(model, out["enc"], out["enc_len"], SOS, EOS,
                                                 **pkw)
    assert not all(torch.equal(a, b) for a, b in zip(plain, (t, n, s)))


TINY = {"model.encoder.hidden_dim": "32", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
        "model.compute_dtype": "float32", "frontend.specaugment": "false",
        "data.batch_size": "4", "data.synthetic_num_utts": "8",
        "data.synthetic_max_sec": "2.5", "decode.auto_buckets": "2", "decode.beam_size": "4",
        "decode.max_decode_len": "32"}


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """The synthetic BPE vocab (the port's ``train_bpe``) and the piece
    4-gram's ARPA file (``write_arpa`` over the pieces)."""
    from pytorch_asr_tpu_torch import train_bpe

    root = tmp_path_factory.mktemp("bpe")
    vocab = root / "vocab.json"
    train_bpe.main([str(vocab)])
    tok = bpe.BPETokenizer.load(str(vocab))
    arpa = root / "piece4.arpa"
    lm.write_arpa(lm.train_char_ngram_kn(TEXTS, 4, tokenizer=tok), str(arpa), tok)
    return str(vocab), str(arpa)


def test_load_lm_picks_the_hashed_tables_past_the_dense_budget(bpe_files):
    vocab, arpa = bpe_files
    over = {"data.vocab": f"bpe:{vocab}", "decode.lm_path": arpa}
    auto = driver.load_lm(get_config("ctc_bilstm_beam_lm", **over), "cpu")
    assert isinstance(auto, ph.HashedNgramLM) and auto.order == 4 and auto.vocab_size == 135
    hashed = driver.load_lm(get_config("ctc_bilstm_beam_lm", **over,
                                       **{"decode.lm_backend": "hashed"}), "cpu")
    assert all(torch.equal(a.data.view(torch.int32), b.data.view(torch.int32))
               for a, b in zip(auto.probs, hashed.probs))
    char = driver.load_lm(get_config("ctc_bilstm_beam_lm", **{
        "decode.lm_path": arpa, "decode.lm_backend": "hashed"}), "cpu")
    assert isinstance(char, ph.HashedNgramLM) and char.vocab_size == 31


def test_decode_cli_with_bpe_and_the_hashed_lm_matches_jax(bpe_files, tmp_path):
    """``decode.main`` at tiny widths with ``data.vocab=bpe:`` and
    ``lm_backend=auto`` (the hashed tables at V 135) gives JAX's
    ``decode_eval`` hypotheses on the same params."""
    from pytorch_asr_tpu.configs import get_config as jax_get_config
    from pytorch_asr_tpu.data import build_dataset as jax_build_dataset
    from pytorch_asr_tpu.training.state import eval_params as jax_eval_params
    from pytorch_asr_tpu.training.trainer import Trainer as JaxTrainer

    vocab, arpa = bpe_files
    over = {**TINY, "data.vocab": f"bpe:{vocab}", "decode.lm_path": arpa}
    jcfg = jax_get_config("ctc_bilstm_beam_lm", **over)
    trainer = JaxTrainer(jcfg, dataset=jax_build_dataset(jcfg.data, jcfg.frontend.sample_rate),
                         enable_checkpoints=False)
    ref = trainer.decode_eval(dump_path=str(tmp_path / "j"))
    params = weights.flatten(jax.tree.map(np.asarray, jax_eval_params(trainer.state)))
    np.savez(tmp_path / "params.npz", **params)
    argv = ["ctc_bilstm_beam_lm", *(f"{k}={v}" for k, v in over.items()), "device=cpu",
            f"params={tmp_path / 'params.npz'}", f"train.checkpoint_dir={tmp_path / 'n'}"]
    got = decode.main(argv + [f"dump_path={tmp_path / 'p'}"])
    assert got["method"] == "prefix_beam" and got["num_utts"] == ref["num_utts"] == 8
    assert got["wer"] == ref["wer"] and got["cer"] == ref["cer"]
    assert (tmp_path / "p.hyp.tsv").read_text() == (tmp_path / "j.hyp.tsv").read_text()
    assert (tmp_path / "p.ref.tsv").read_text() == (tmp_path / "j.ref.tsv").read_text()
    topa = decode.main(argv + ["decode.ext_top_a=8", "max_batches=1"])
    assert topa["method"] == "prefix_beam" and np.isfinite(topa["wer"])
