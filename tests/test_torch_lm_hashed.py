"""The port's hashed n-gram tables (``decoding/lm_hashed.py``) against the JAX
package's on the same LMs: the FNV-1a folds (past 2^31 too), the bucket
arrays bit for bit, and the rows (all candidates and subsets, the dense
bigram level on and off, the all-miss rows) exactly; the rows against
``BackoffLM.score`` to float32 rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.decoding import lm as jax_lm
from pytorch_asr_tpu.decoding import lm_hashed as jh
from pytorch_asr_tpu_torch.data.bpe import train_bpe
from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
from pytorch_asr_tpu_torch.decoding import lm
from pytorch_asr_tpu_torch.decoding import lm_hashed as ph

TEXTS = synthetic_texts(512)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.fixture(scope="module")
def lms():
    """{name: (port's HashedNgramLM, JAX's, BackoffLM, V)}: the piece 4-gram
    of the synthetic BPE vocab (V 135, dense bigram level) and a char 3-gram
    compiled without the dense level (budget 0)."""
    tok = train_bpe(TEXTS, 256)
    piece = lm.train_char_ngram_kn(TEXTS, 4, tokenizer=tok)
    char = lm.train_char_ngram_kn(TEXTS, 3)
    out = {}
    for name, m, V in (("piece4", piece, tok.vocab_size), ("char3", char, 31)):
        jm = jax_lm.BackoffLM(m.order, m.logprobs, m.backoffs)
        budget = ph._BI_DENSE_BUDGET
        if name == "char3":
            ph._BI_DENSE_BUDGET = jh._BI_DENSE_BUDGET = 0
        try:
            out[name] = (ph.build_hashed_lm(m, V), jh.build_hashed_lm(jm, V), m, V)
        finally:
            ph._BI_DENSE_BUDGET = jh._BI_DENSE_BUDGET = budget
    return out


def test_fold_matches_jax_past_2_31():
    """The 32-bit folds of hashes and ids on both sides of 2^31 (negative
    ids taken mod 2^32, as a uint32 cast takes them)."""
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    h[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    x = rng.integers(-2 ** 31, 2 ** 31, size=500).astype(np.int64)
    x[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    got = ph._fold(torch.from_numpy(h.astype(np.int64)), torch.from_numpy(h.astype(np.int64)),
                   torch.from_numpy(x))
    want = jh._fold(jnp.asarray(h.astype(np.uint32)), jnp.asarray(h.astype(np.uint32)),
                    jnp.asarray(x.astype(np.int32)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        assert a.min() >= 0 and a.max() < 2 ** 32
    assert int(got[0].max()) >= 2 ** 31


def test_hash_pair_matches_jax():
    rng = np.random.default_rng(1)
    for n in range(6):
        for _ in range(20):
            ids = tuple(int(i) for i in rng.integers(0, 5000, size=n))
            assert ph._hash_pair_np(ids) == jh._hash_pair_np(ids)


@pytest.mark.parametrize("name", ["piece4", "char3"])
def test_tables_are_bit_equal_to_jax(lms, name):
    ours, ref, _, V = lms[name]
    assert ours.order == ref.order and ours.vocab_size == ref.vocab_size == V
    np.testing.assert_array_equal(_bits(ours.uni), _bits(ref.uni))
    np.testing.assert_array_equal(_bits(ours.uni_backoff), _bits(ref.uni_backoff))
    assert len(ours.probs) == len(ref.probs) and len(ours.backoffs) == len(ref.backoffs)
    for a, b in zip(ours.probs + ours.backoffs, ref.probs + ref.backoffs):
        assert a.data.dtype == torch.float32 and a.data.shape[1] == 32
        np.testing.assert_array_equal(_bits(a.data), _bits(b.data))
    assert (ours.bi_dense is None) == (ref.bi_dense is None) == (name == "char3")
    if ours.bi_dense is not None:
        np.testing.assert_array_equal(_bits(ours.bi_dense), _bits(ref.bi_dense))


@pytest.mark.parametrize("n", [1, 2, 9, 100, 3000])
def test_build_table_matches_jax_at_every_load(n):
    """Random n-grams of n entries: the bucket count (load factor, and the
    growth where a bucket overflows its 8 ways) and every way equal JAX's."""
    rng = np.random.default_rng(n)
    grams = rng.integers(1, 300, size=(n, 3))
    entries = {tuple(int(i) for i in g): float(rng.standard_normal()) for g in grams}
    ours, ref = ph._build_table(entries), jh._build_table(entries)
    np.testing.assert_array_equal(_bits(ours.data), _bits(ref.data))
    assert ours.data.shape[0] >= 4 * len(entries) / ph.BUCKET


def _contexts(V: int, seed: int) -> np.ndarray:
    """(4, 6, 3) windows: random ids, with histories of 0, 1 and 2 ids
    (leading zeros) and real piece sequences."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, V, size=(4, 6, 3)).astype(np.int32)
    ctx[0, :, :] = 0
    ctx[1, :, :2] = 0
    ctx[2, :, :1] = 0
    return ctx


@pytest.mark.parametrize("name", ["piece4", "char3"])
def test_rows_match_jax_exactly(lms, name):
    """All candidates (through the dense bigram level where it exists), a
    candidate subset (hash rows at every level) and the all-miss rows."""
    ours, ref, _, V = lms[name]
    for seed in range(3):
        ctx = _contexts(V, seed)
        got = ph.hashed_lm_logp_rows(ours, torch.from_numpy(ctx))
        np.testing.assert_array_equal(_bits(got), _bits(jh.hashed_lm_logp_rows(ref,
                                                                              jnp.asarray(ctx))))
        cands = np.random.default_rng(seed).integers(0, V, size=(4, 6, 5)).astype(np.int32)
        got = ph.hashed_lm_logp_rows(ours, torch.from_numpy(ctx), torch.from_numpy(cands))
        want = jh.hashed_lm_logp_rows(ref, jnp.asarray(ctx), jnp.asarray(cands))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        got = ph.hashed_lm_allmiss_rows(ours, torch.from_numpy(ctx))
        np.testing.assert_array_equal(_bits(got), _bits(jh.hashed_lm_allmiss_rows(
            ref, jnp.asarray(ctx))))


def test_dense_bigram_level_gives_the_hash_rows(lms):
    """The all-candidates rows read the bigram level from ``bi_dense``; the
    subset path reads hash rows: the same values."""
    ours, _, _, V = lms["piece4"]
    ctx = torch.from_numpy(_contexts(V, 5))
    cands = torch.arange(V).expand(4, 6, V)
    np.testing.assert_array_equal(_bits(ph.hashed_lm_logp_rows(ours, ctx)),
                                  _bits(ph.hashed_lm_logp_rows(ours, ctx, cands)))


@pytest.mark.parametrize("name", ["piece4", "char3"])
def test_rows_match_backoff_score(lms, name):
    """Each row entry is ``BackoffLM.score`` of the window's history (its
    nonzero ids) to float32 rounding, and some windows hit every order."""
    ours, _, m, V = lms[name]
    tok_ctx = _contexts(V, 7)
    rows = ph.hashed_lm_logp_rows(ours, torch.from_numpy(tok_ctx)).numpy()
    worst = 0.0
    for b in range(4):
        for k in range(6):
            hist = tuple(int(i) for i in tok_ctx[b, k] if i != 0)
            want = np.array([m.score(hist, c) for c in range(V)])
            worst = max(worst, float(np.abs(rows[b, k] - want).max()))
    assert worst < 1e-5
    # a real history: the top order hits
    hist = [i for i in train_bpe(TEXTS, 256).encode(TEXTS[0])][:3] if name == "piece4" else \
        [int(i) for i in lm.CharTokenizer().encode(TEXTS[0][:2])]
    ctx = np.zeros((1, 1, ours.order - 1), np.int32)
    ctx[0, 0, -len(hist):] = hist[-(ours.order - 1):]
    row = ph.hashed_lm_logp_rows(ours, torch.from_numpy(ctx)).numpy()[0, 0]
    assert any(tuple(hist[-(ours.order - 1):]) + (c,) in m.logprobs for c in range(V))
    for c in range(V):
        assert row[c] == pytest.approx(m.score(tuple(hist), c), abs=1e-5)


def test_roll_context_window(lms):
    ctx = torch.tensor([[[0, 0, 5], [1, 2, 3]]], dtype=torch.int32)
    out = ph.roll_context_window(ctx, torch.tensor([[7, 9]]))
    assert out.tolist() == [[[0, 5, 7], [2, 3, 9]]] and out.dtype == torch.int32
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jh.roll_context_window(jnp.asarray(ctx.numpy()),
                                                        jnp.asarray([[7, 9]], jnp.int32))))


def test_kernel_table_is_made_once_for_each_lm(lms):
    """``beam_cuda.hash_table``: the arrays' addresses (probs, then
    backoffs), then their bucket masks, as int64; a second call for the same
    LM returns the same tensor, so a launch copies nothing."""
    from pytorch_asr_tpu_torch.ops import beam_cuda

    ours = lms["piece4"][0]
    tabs = [t.data for t in (*ours.probs, *ours.backoffs)]
    got = beam_cuda.hash_table(ours, torch.device("cpu"))
    assert got.dtype == torch.int64
    assert got.tolist() == [t.data_ptr() for t in tabs] + [t.shape[0] - 1 for t in tabs]
    assert beam_cuda.hash_table(ours, torch.device("cpu")) is got
    other = lms["char3"][0]
    assert beam_cuda.hash_table(other, torch.device("cpu")) is not got
