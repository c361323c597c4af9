"""The port's n-gram LM (``decoding/lm.py``) and ``train_ngram`` CLI against
the JAX package's on the same texts: estimators, ARPA text both ways, and
the dense tables the beam search fuses."""

from __future__ import annotations

import numpy as np
import pytest

from pytorch_asr_tpu import native
from pytorch_asr_tpu import train_ngram as jax_train_ngram
from pytorch_asr_tpu.data.synthetic import synthetic_texts as jax_synthetic_texts
from pytorch_asr_tpu.decoding import lm as jax_lm
from pytorch_asr_tpu_torch import train_ngram
from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
from pytorch_asr_tpu_torch.decoding import lm

# Both packages compute log-probabilities and backoffs in float64 with the
# same operations in the same order: equal to 1e-12 (bit-equal in practice).
LOGPROB_TOL = 1e-12
# ARPA stores log10 values with 6 decimals: a file read back differs from
# the trained model by up to 5e-7 * ln 10 in each stored value.
ARPA_TOL = 1.2e-6
# Tables are float32; the JAX package's C++ helper sums backoffs in its own
# order: one float32 step at |log p| ~ 20 is 1.9e-6, i.e. under 1e-6 relative.
TABLE_RTOL = 1e-6


@pytest.fixture(scope="module")
def texts():
    return synthetic_texts(256)


def _assert_lm_close(ours, ref, tol):
    assert ours.order == ref.order
    assert ours.logprobs.keys() == ref.logprobs.keys()
    assert ours.backoffs.keys() == ref.backoffs.keys()
    for name in ("logprobs", "backoffs"):
        a, b = getattr(ours, name), getattr(ref, name)
        np.testing.assert_allclose([a[k] for k in b], list(b.values()), rtol=0, atol=tol)


def test_synthetic_texts_match_jax():
    assert synthetic_texts(40, seed=3) == jax_synthetic_texts(40, seed=3)


@pytest.mark.parametrize("order", [2, 3, 4])
def test_kneser_ney_matches_jax(texts, order):
    _assert_lm_close(lm.train_char_ngram_kn(texts, order=order),
                     jax_lm.train_char_ngram_kn(texts, order=order), LOGPROB_TOL)


def test_add_k_and_perplexity_match_jax(texts):
    ours, ref = lm.train_char_ngram(texts, order=3), jax_lm.train_char_ngram(texts, order=3)
    _assert_lm_close(ours, ref, LOGPROB_TOL)
    held = synthetic_texts(20, seed=9)
    assert abs(lm.perplexity(ours, held) - jax_lm.perplexity(ref, held)) <= 1e-9


def test_arpa_is_the_same_text_and_reads_back_alike(texts, tmp_path):
    model = lm.train_char_ngram_kn(texts, order=4)
    lm.write_arpa(model, str(tmp_path / "ours.arpa"))
    jax_lm.write_arpa(jax_lm.train_char_ngram_kn(texts, order=4), str(tmp_path / "ref.arpa"))
    assert (tmp_path / "ours.arpa").read_text() == (tmp_path / "ref.arpa").read_text()
    ours = lm.read_arpa(str(tmp_path / "ref.arpa"))
    ref = jax_lm.read_arpa(str(tmp_path / "ours.arpa"))
    _assert_lm_close(ours, ref, 0.0)
    _assert_lm_close(ours, model, ARPA_TOL)


@pytest.mark.parametrize("order,n", [(4, None), (3, None), (4, 2), (2, 3), (1, 2)])
def test_tensorize_is_bit_equal_to_jax(texts, order, n):
    """The vectorised table against the JAX package's score-by-score loop,
    also where the table's order differs from the model's."""
    model = lm.train_char_ngram_kn(texts, order=order)
    ref = jax_lm.tensorize(jax_lm.train_char_ngram_kn(texts, order=order), order=n)
    got = lm.tensorize(model, order=n, rows_per_chunk=100)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_tensorize_drops_zero_digits_and_backs_off_like_score():
    """Context digits of 0 mean "no history" wherever they stand, and a
    missing n-gram backs off through each shorter context in turn."""
    model = lm.BackoffLM(3, {(1,): -1.0, (2,): -2.0, (3,): -3.0, (1, 2): -0.5,
                             (2, 1, 3): -0.25},
                         {(1,): -0.125, (2,): -0.375, (2, 1): -0.0625})
    V = 31
    table = lm.tensorize(model)
    assert table[2 * V + 0, 3] == np.float32(model.score((2,), 3))      # (2, 0): ctx (2,)
    assert table[0 * V + 2, 1] == np.float32(model.score((2,), 1))      # (0, 2): ctx (2,)
    assert table[2 * V + 1, 3] == np.float32(-0.25)                     # exact trigram
    assert table[2 * V + 1, 2] == np.float32(-0.5 + -0.0625)            # back off once
    assert table[2 * V + 1, 1] == np.float32(-1.0 + (-0.0625 + -0.125))  # twice
    assert table[1 * V + 1, 2] == np.float32(-0.5)        # no stored backoff counts 0
    assert table[0, 4] == np.float32(-20.0)               # unseen unigram, no history


def test_tensorize_matches_native_helper(texts, tmp_path):
    """The JAX package's C++ ARPA expander, where it is built, gives the same
    table on every char CTC can emit (ids 0-28); it maps <s> and </s> to no
    id, so their two columns take its -20 floor and are left out."""
    if not native.available():
        pytest.skip("the JAX package's native helper is not built here")
    path = str(tmp_path / "lm.arpa")
    lm.write_arpa(lm.train_char_ngram_kn(texts, order=4), path)
    ref, order = native.arpa_dense_table(path)
    got = lm.tensorize(lm.read_arpa(path))
    assert order == 4 and got.shape == ref.shape
    np.testing.assert_allclose(got[:, :29], ref[:, :29], rtol=TABLE_RTOL, atol=0)


def test_roll_context_matches_tensorize_rows():
    V = 31
    assert lm.roll_context(5 * V + 7, 9, V, 3) == 7 * V + 9
    assert lm.roll_context(0, 4, V, 3) == 4


def test_train_ngram_clis_read_each_others_files(tmp_path, capsys):
    text = tmp_path / "text.txt"
    text.write_text("\n".join(synthetic_texts(64, seed=2)) + "\n")
    held = tmp_path / "held.txt"
    held.write_text("the quick brown fox\n")
    ours, ref = tmp_path / "ours.arpa", tmp_path / "ref.arpa"
    train_ngram.main([str(ours), f"text={text}", "order=3", f"heldout={held}"])
    jax_train_ngram.main([str(ref), f"text={text}", "order=3", f"heldout={held}"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"wrote {ours}: order=3") and "perplexity" in out[1]
    assert out[1] == out[3]
    assert ours.read_text() == ref.read_text()
    np.testing.assert_array_equal(lm.tensorize(lm.read_arpa(str(ref))),
                                  jax_lm.tensorize(jax_lm.read_arpa(str(ours))))


def test_train_ngram_default_corpus(tmp_path, capsys):
    path = tmp_path / "syn.arpa"
    train_ngram.main([str(path), "num_synthetic=32", "order=2"])
    assert "sentences=32" in capsys.readouterr().out
    assert lm.read_arpa(str(path)).order == 2
