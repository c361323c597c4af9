"""The port's CTC forced alignment (``decoding/align.py``) against the JAX
package's ``ctc_forced_align`` and its brute-force oracle, on the CPU; and
the ``align`` CLI on the CPU at a tiny width.

Both sides run log-softmax and float32 adds on the same logits, so every
integer output must be equal and the score within 1e-6 relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.decoding.align import ctc_forced_align as jax_align
from pytorch_asr_tpu_torch import align as align_cli
from pytorch_asr_tpu_torch.decoding.align import NEG_INF, ctc_forced_align
from tests.test_align import _oracle, _rand_logp

INTS = ("frame_state", "frame_label", "starts", "ends")
SCORE_RTOL = 1e-6


def _both(logits, logit_len, tokens, token_len):
    want = jax_align(jnp.asarray(logits), jnp.asarray(logit_len), jnp.asarray(tokens),
                     jnp.asarray(token_len))
    got = ctc_forced_align(torch.from_numpy(logits), torch.from_numpy(logit_len),
                           torch.from_numpy(tokens), torch.from_numpy(token_len))
    return got, {k: np.asarray(v) for k, v in want.items()}


def _assert_equal(got, want):
    for k in INTS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["score"].dtype == torch.float32
    np.testing.assert_allclose(got["score"].numpy(), want["score"], rtol=SCORE_RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_matches_jax_on_random_logits(seed):
    """Ragged logit_len (one row of no frames), token_len 0, repeated tokens
    (no skip between them), rows past token_len, and an infeasible row:
    [3, 3, 3] needs 5 frames and has 4."""
    rng = np.random.default_rng(seed)
    B, T, V, L = 6, 21, 7, 5
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    tokens = rng.integers(1, V, (B, L)).astype(np.int32)
    tokens[1, :4] = [2, 2, 5, 5]
    tokens[4, :3] = 3
    logit_len = np.array([T, 17, 9, 0, 4, 12], np.int32)
    token_len = np.array([5, 4, 0, 2, 3, 1], np.int32)
    tokens[np.arange(L)[None, :] >= token_len[:, None]] = 0
    got, want = _both(logits, logit_len, tokens, token_len)
    _assert_equal(got, want)
    assert (want["score"][4] < NEG_INF / 2) and np.isfinite(want["score"]).all()
    assert (got["frame_state"].numpy()[np.arange(T)[None] >= logit_len[:, None]] == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_score_matches_bruteforce(seed):
    """The JAX test's oracle: every CTC path of 1-2 tokens over T 6."""
    V, T = 4, 6
    rng = np.random.default_rng(100 + seed)
    L = int(rng.integers(1, 3))
    tokens = rng.integers(1, V, size=L)
    logp = _rand_logp(T, V, seed)
    path, oracle = _oracle(logp, T, list(tokens))
    got = ctc_forced_align(torch.from_numpy(logp[None]), torch.tensor([T]),
                           torch.from_numpy(tokens[None].astype(np.int32)), torch.tensor([L]))
    np.testing.assert_allclose(float(got["score"][0]), oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["frame_state"][0].numpy(), path)


def test_batch_independence():
    """Each row's outputs equal its single-row run's."""
    V, T = 6, 12
    logits = np.stack([_rand_logp(T, V, 0), _rand_logp(T, V, 1), _rand_logp(T, V, 2)])
    tokens = np.array([[2, 3, 2], [1, 1, 0], [4, 0, 0]], np.int32)
    token_len = np.array([3, 2, 1], np.int32)
    logit_len = np.array([T, T - 4, 5], np.int32)
    full = ctc_forced_align(torch.from_numpy(logits), torch.from_numpy(logit_len),
                            torch.from_numpy(tokens), torch.from_numpy(token_len))
    for b in range(3):
        solo = ctc_forced_align(torch.from_numpy(logits[b:b + 1]),
                                torch.from_numpy(logit_len[b:b + 1]),
                                torch.from_numpy(tokens[b:b + 1]),
                                torch.from_numpy(token_len[b:b + 1]))
        for k in (*INTS, "score"):
            assert torch.equal(solo[k][0], full[k][b]), (b, k)


def test_cli_on_cpu(tmp_path):
    """``align.main`` over one batch of a tiny config 1: the TSV format, a
    segment per token of each utterance, and times equal to the aligner's
    spans times the frame's seconds (hop 10 ms x time strides 4)."""
    dump = tmp_path / "segs.tsv"
    argv = ["ctc_bilstm_dev1h", "device=cpu", "max_batches=1", f"dump_path={dump}",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}", "model.encoder.hidden_dim=16",
            "model.encoder.num_layers=1", "model.encoder.conv_channels=4,4",
            "data.synthetic_num_utts=4", "data.batch_size=4", "data.auto_buckets=1",
            "data.synthetic_max_sec=2"]
    res = align_cli.main(argv)
    assert res["frame_sec"] == pytest.approx(0.04)
    rows = [line.split("\t") for line in dump.read_text().splitlines()]
    assert len(rows) == res["segments"] > 0 and res["utts"] == 4
    # The spans again, from the same model and batch.
    from pytorch_asr_tpu_torch.evaluate import model_outputs
    from pytorch_asr_tpu_torch.training.trainer import Trainer

    cfg, _, runtime = align_cli.train.parse_args([a for a in argv
                                                  if not a.startswith(("dump", "max_"))])
    trainer = Trainer(cfg, **runtime)
    batch = next(trainer.dataset.epoch_batches(seed=0))
    with torch.inference_mode():
        out = model_outputs(trainer.state.model, batch)
        spans = ctc_forced_align(out["ctc_logits"], out["enc_len"],
                                 torch.from_numpy(batch["tokens"]),
                                 torch.from_numpy(batch["token_len"]))
    want = [(f"utt{b:06d}", trainer.dataset.tokenizer.decode([int(batch["tokens"][b, j])]),
             f"{int(spans['starts'][b, j]) * 0.04:.3f}", f"{int(spans['ends'][b, j]) * 0.04:.3f}")
            for b in range(4) for j in range(int(batch["token_len"][b]))]
    assert [tuple(r) for r in rows] == want
