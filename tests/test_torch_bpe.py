"""The port's BPE vocabulary (``data/bpe.py``, ``train_bpe``, the ``bpe:``
tokenizer, ARPA files over pieces, the checkpoint's meta) against the JAX
package's on the same texts: pieces, merges and ids are equal, a vocab or an
ARPA file written by either package reads the same in the other."""

from __future__ import annotations

import json

import numpy as np
import pytest

from pytorch_asr_tpu.data import bpe as jax_bpe
from pytorch_asr_tpu.data.synthetic import synthetic_texts as jax_synthetic_texts
from pytorch_asr_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
from pytorch_asr_tpu.decoding import lm as jax_lm
from pytorch_asr_tpu.train_bpe import main as jax_train_bpe_main
from pytorch_asr_tpu_torch import train_bpe
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.data import bpe, get_tokenizer
from pytorch_asr_tpu_torch.data.synthetic import synthetic_texts
from pytorch_asr_tpu_torch.decoding import lm
from pytorch_asr_tpu_torch.training import checkpoint

TEXTS = synthetic_texts(512)
EXTRA = ["The quick brown fox, it's a TEST!", "zebra quartz jumps", "", "a"]


def test_synthetic_texts_match_jax():
    assert TEXTS == jax_synthetic_texts(512)


@pytest.mark.parametrize("merges", [0, 16, 77, 78, 256])
def test_train_bpe_matches_jax(merges):
    """Pieces, merges and the ids of every text (the corpus and texts with
    unseen words, punctuation and case) equal JAX's; the synthetic corpus
    stops at 78 merges (V 135)."""
    ours, ref = bpe.train_bpe(TEXTS, merges), jax_bpe.train_bpe(TEXTS, merges)
    assert ours.pieces == ref.pieces and ours.merges == ref.merges
    assert (ours.sos_id, ours.eos_id, ours.vocab_size) == (ref.sos_id, ref.eos_id,
                                                          ref.vocab_size)
    assert ours.vocab_size == 57 + min(merges, 78)
    for text in TEXTS[:64] + EXTRA:
        ids = ours.encode(text)
        np.testing.assert_array_equal(ids, ref.encode(text))
        assert ids.dtype == np.int32
        assert ours.decode(ids) == ref.decode(ids)


def test_decode_and_decode_ctc_match_jax():
    ours, ref = bpe.train_bpe(TEXTS, 256), jax_bpe.train_bpe(TEXTS, 256)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, ours.vocab_size + 2, size=30)
        assert ours.decode(ids) == ref.decode(ids)
        assert ours.decode_ctc(ids) == ref.decode_ctc(ids)
    assert ours.decode(ours.encode("hello world")) == "hello world"


def test_vocab_saved_by_either_package_loads_in_the_other(tmp_path):
    ours, ref = bpe.train_bpe(TEXTS, 40), jax_bpe.train_bpe(TEXTS, 40)
    ours.save(str(tmp_path / "ours.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    a = jax_bpe.BPETokenizer.load(str(tmp_path / "ours.json"))
    b = bpe.BPETokenizer.load(str(tmp_path / "ref.json"))
    assert a.pieces == b.pieces == ours.pieces and a.merges == b.merges == ours.merges
    (tmp_path / "v2.json").write_text(json.dumps({"version": 2, "pieces": [], "merges": []}))
    with pytest.raises(ValueError, match="version"):
        bpe.BPETokenizer.load(str(tmp_path / "v2.json"))
    with pytest.raises(ValueError, match="duplicate"):
        bpe.BPETokenizer(["a", "a"], [])


def test_get_tokenizer_loads_bpe_and_caches_by_the_string(tmp_path):
    path = tmp_path / "v.json"
    bpe.train_bpe(TEXTS, 256).save(str(path))
    tok = get_tokenizer(f"bpe:{path}")
    assert tok is get_tokenizer(f"bpe:{path}")
    ref = jax_get_tokenizer(f"bpe:{path}")
    assert tok.pieces == ref.pieces and tok.vocab_size == ref.vocab_size == 135
    with pytest.raises(ValueError, match="bpe:<vocab.json>"):
        get_tokenizer("sentencepiece:x.model")


def test_train_bpe_cli_writes_the_jax_cli_file(tmp_path, capsys):
    text = tmp_path / "t.txt"
    text.write_text("\n".join(TEXTS[:100]) + "\n")
    for args in ([], [f"text={text}", "merges=30"], ["num_synthetic=64", "merges=9"]):
        train_bpe.main([str(tmp_path / "ours.json"), *args])
        jax_train_bpe_main([str(tmp_path / "ref.json"), *args])
        assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
        out = capsys.readouterr().out.splitlines()
        assert out[0].split(":", 1)[1] == out[1].split(":", 1)[1]
    # librispeech_root= reads a tree's transcripts; a missing tree raises as JAX's.
    for main in (train_bpe.main, jax_train_bpe_main):
        with pytest.raises(FileNotFoundError, match="train-clean-100"):
            main([str(tmp_path / "x.json"), f"librispeech_root={tmp_path / 'none'}"])
    with pytest.raises(SystemExit):
        train_bpe.main([])


def test_checkpoint_meta_holds_the_pieces(tmp_path):
    """A ``bpe:`` vocab's checkpoint meta carries its pieces and merges, as
    JAX's does, and the ``experiment.json`` the manager writes holds them."""
    path = tmp_path / "v.json"
    bpe.train_bpe(TEXTS, 256).save(str(path))
    cfg = get_config("ctc_bilstm_dev1h", **{"data.vocab": f"bpe:{path}"})
    meta = checkpoint._meta(cfg)
    tok = get_tokenizer(f"bpe:{path}")
    assert meta["vocab"] == f"bpe:{path}"
    assert meta["bpe"] == {"pieces": tok.pieces, "merges": [list(m) for m in tok.merges]}
    checkpoint.CheckpointManager(cfg, str(tmp_path / "ckpt"))
    stored = json.loads((tmp_path / "ckpt" / "experiment.json").read_text())
    assert stored["bpe"] == meta["bpe"]
    assert "bpe" not in checkpoint._meta(get_config("ctc_bilstm_dev1h"))


@pytest.fixture(scope="module")
def piece_lms():
    """A KN 4-gram over the pieces, estimated by each package."""
    tok, jtok = bpe.train_bpe(TEXTS, 256), jax_bpe.train_bpe(TEXTS, 256)
    return (tok, lm.train_char_ngram_kn(TEXTS, 4, tokenizer=tok),
            jtok, jax_lm.train_char_ngram_kn(TEXTS, 4, tokenizer=jtok))


def test_piece_ngram_matches_jax(piece_lms):
    tok, ours, _, ref = piece_lms
    assert ours.order == ref.order == 4
    assert ours.logprobs.keys() == ref.logprobs.keys()
    assert ours.backoffs.keys() == ref.backoffs.keys()
    for ng, lp in ref.logprobs.items():
        assert ours.logprobs[ng] == pytest.approx(lp, rel=1e-12, abs=1e-12)
    assert any(len(ng) == 4 for ng in ours.logprobs)
    assert all(0 <= i < tok.vocab_size for ng in ours.logprobs for i in ng)


def test_arpa_over_pieces_round_trips_between_packages(piece_lms, tmp_path):
    """Either package's ARPA file over pieces is the other's, byte for byte
    and UTF-8 (the marker "▁" is in it), and reads back to the same LM in
    both: each symbol is a whole piece, not its chars."""
    tok, ours, jtok, ref = piece_lms
    lm.write_arpa(ours, str(tmp_path / "ours.arpa"), tok)
    jax_lm.write_arpa(ref, str(tmp_path / "ref.arpa"), jtok)
    text = (tmp_path / "ours.arpa").read_bytes().decode("utf-8")
    assert "▁" in text and text.startswith("\\data\\")
    assert (tmp_path / "ours.arpa").read_bytes() == (tmp_path / "ref.arpa").read_bytes()
    a = lm.read_arpa(str(tmp_path / "ref.arpa"), tok)
    b = jax_lm.read_arpa(str(tmp_path / "ours.arpa"), jtok)
    assert a.order == b.order == 4
    assert a.logprobs.keys() == b.logprobs.keys() == ours.logprobs.keys()
    assert a.backoffs.keys() == b.backoffs.keys()
    for ng in a.logprobs:
        assert a.logprobs[ng] == b.logprobs[ng]
        assert a.logprobs[ng] == pytest.approx(ours.logprobs[ng], abs=2e-6)
    for ctx, c in (((), 5), ((tok.encode("the")[0],), 7), (tuple(tok.encode("quick brown")), 3)):
        assert a.score(ctx, c) == b.score(ctx, c)


def test_char_arpa_is_unchanged(tmp_path):
    """The char LM's ARPA text stays the JAX package's (``<space>`` for the
    space)."""
    ours = lm.train_char_ngram_kn(TEXTS[:50], 3)
    lm.write_arpa(ours, str(tmp_path / "c.arpa"))
    jax_lm.write_arpa(jax_lm.train_char_ngram_kn(TEXTS[:50], 3), str(tmp_path / "j.arpa"))
    assert (tmp_path / "c.arpa").read_bytes() == (tmp_path / "j.arpa").read_bytes()
    assert "<space>" in (tmp_path / "c.arpa").read_text(encoding="utf-8")
    back = lm.read_arpa(str(tmp_path / "c.arpa"))
    assert back.logprobs.keys() == ours.logprobs.keys()
