"""The port's two study designs of the prefix beam search, K13
(``prefix_beam_fused``) and K12 (``prefix_beam_lanes_stepwise``, one launch
a frame), and the two benchmark scripts that reach them, on the CPU.

On CPU tensors both wrappers take the plain search.  They are held to the
JAX package's ``prefix_beam_fused`` and ``prefix_beam_lanes_stepwise`` in
interpret mode at the JAX tests' tiny size, and to its scan on a
blank-dominated and a peaky input.  The kernels are held to the plain search
(and K12's pointers and state to the plain frames) in
``test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.decoding.prefix_beam import prefix_beam_search as jax_search
from pytorch_asr_tpu.ops import runtime as jax_runtime
from pytorch_asr_tpu.ops.beam_pallas import prefix_beam_fused as jax_fused
from pytorch_asr_tpu.ops.beam_pallas import prefix_beam_lanes_stepwise as jax_stepwise
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.ops import beam_cuda, build
from pytorch_asr_tpu_torch.scripts import bench_beam_compile, bench_prefix_beam, bench_study_turns

# float32 log-space sums: XLA's and torch's exp/log1p round apart.  A
# near-certain path (the peaky input) scores a few 1e-6 below 0, a sum of
# per-frame log-softmax terms that each package rounds on its own: there
# the absolute difference is what a float32 log-softmax of logits near 8
# resolves (~1e-6 a frame).
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-5
PORT = {"fused": beam_cuda.prefix_beam_fused, "stepwise": beam_cuda.prefix_beam_lanes_stepwise}


def _same(port, ref):
    """Lengths and each row's tokens up to its length equal, scores close."""
    tk, lk, sk = (np.asarray(a) for a in port)
    tx, lx, sx = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(lk, lx)
    for b in range(len(lk)):
        np.testing.assert_array_equal(tk[b, : lk[b]], tx[b, : lk[b]])
    np.testing.assert_allclose(sk, sx, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("design", ["fused", "stepwise"])
def test_matches_the_jax_kernel_in_interpret_mode(design):
    rng = np.random.default_rng(5)
    B, T, V, K, L = 2, 12, 16, 4, 16
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    lens = np.array([T, T - 3], np.int32)
    build.reset_launches()
    port = PORT[design](torch.from_numpy(logits), torch.from_numpy(lens), beam_size=K,
                        max_len=L)
    assert not any(build.LAUNCHES.values())
    jax_runtime.force_interpret(True)
    try:
        fn = jax_fused if design == "fused" else jax_stepwise
        ref = fn(jnp.asarray(logits), jnp.asarray(lens), beam_size=K, max_len=L)
    finally:
        jax_runtime.force_interpret(None)
    _same(port, ref)


def _blank_dominated():
    logits = np.full((1, 12, 32), -8.0, np.float32)
    logits[..., 0] = 6.0
    return logits


def _peaky():
    path = np.random.default_rng(3).integers(0, 6, 14)
    logits = np.full((1, 14, 32), -10.0, np.float32)
    logits[0, np.arange(14), path] = 8.0
    return logits


@pytest.mark.parametrize("design", ["fused", "stepwise"])
@pytest.mark.parametrize("make", [_blank_dominated, _peaky])
def test_matches_the_jax_scan(design, make):
    """The blank-dominated input decodes to nothing, the peaky one to its
    greedy collapse; both as the JAX scan does."""
    logits = make()
    lens = np.array([logits.shape[1]], np.int32)
    port = PORT[design](torch.from_numpy(logits), torch.from_numpy(lens), beam_size=4,
                        max_len=16)
    ref = jax_search(jnp.asarray(logits), jnp.asarray(lens), beam_size=4, max_len=16,
                     use_fused=False)
    _same(port, ref)
    if make is _blank_dominated:
        assert int(port[1][0]) == 0 and np.isfinite(float(port[2][0]))


def test_one_frame_at_a_time_equals_the_plain_search():
    """K12's plain frames, carried over every frame (what its scratch
    receives) and backtraced through their pointers, give the plain
    search's tokens, lengths and scores."""
    rng = np.random.default_rng(6)
    B, T, V, K, L = 3, 15, 9, 4, 6
    logp = torch.log_softmax(torch.from_numpy(rng.standard_normal((B, T, V)).astype(
        np.float32)), -1)
    lens = torch.tensor([T, 0, 7], dtype=torch.int32)
    st = {}
    tokens, lengths, scores = beam_cuda.prefix_beam_lanes_stepwise(logp, lens, K, 0, L,
                                                                   scratch=st)
    assert st.keys() == {"pb", "pnb", "hash", "last", "length", "parent", "append"}
    assert st["parent"].shape == st["append"].shape == (B, T, K)
    final = pb._lse(st["pb"], st["pnb"])
    best = torch.argmax(final, dim=1)
    assert torch.equal(final[torch.arange(B), best], scores)
    assert torch.equal(st["length"][torch.arange(B), best], lengths)
    for b in range(B):
        k, chars = int(best[b]), []
        for t in range(T - 1, -1, -1):
            if st["append"][b, t, k] >= 0:
                chars.append(int(st["append"][b, t, k]))
            k = int(st["parent"][b, t, k])
        assert chars[::-1][:L] == tokens[b, : lengths[b]].tolist()


TINY = ["B=2", "T=12", "K=4", "V=8", "iters=1", "device=cpu"]


@pytest.mark.parametrize("argv,arms", [
    (["fused=1", "hashed=0"], ["plain scan", "dense LM", "rnn LM", "fused beam", "lanes beam",
                               "lanes+dense", "lanes rnn full-vocab", "cand+merge+topk scan"]),
    (["lm=0", "lanes=0"], ["plain scan", "cand+merge+topk scan"]),
])
def test_bench_prefix_beam_runs_its_arms_on_the_cpu(capsys, argv, arms):
    out = bench_prefix_beam.main(TINY + argv)
    assert list(out["arms"]) == arms and out["device"] == "cpu"
    printed = capsys.readouterr().out
    assert all(f"{a}" in printed for a in arms)
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in out["arms"].values())


def test_bench_prefix_beam_refuses_the_unported_hashed_arms():
    """The hashed arms are ported: ``hashed=1`` runs the hashed LM's arm
    (and past V 256 its ``lm_top_k`` and ``ext_top_a`` arms); unknown keys
    are refused."""
    out = bench_prefix_beam.main(TINY + ["hashed=1", "lanes=0"])
    assert list(out["arms"]) == ["plain scan", "dense LM", "hashed LM", "rnn LM",
                                 "cand+merge+topk scan"]
    with pytest.raises(ValueError, match="unknown keys"):
        bench_prefix_beam.main(TINY + ["hashed=0", "use_fused=1"])


@pytest.mark.parametrize("arm,names", [
    ("stepwise=1", ["monolithic lanes", "stepwise lanes (per-frame kernel)", "plain scan"]),
    ("merge=1", ["plain merge scan", "fused merge scan"]),
])
def test_bench_beam_compile_runs_its_arms_on_the_cpu(arm, names):
    argv = ["T=12", "K=4", "V=8", "iters=1", "batches=2", "device=cpu", arm]
    out = bench_beam_compile.main(argv)
    assert list(out["arms"]) == names and out["B"] == 2


def test_bench_beam_compile_has_no_compile_time_arm():
    with pytest.raises(SystemExit, match="stepwise=1 or merge=1"):
        bench_beam_compile.main(["T=12", "device=cpu"])


@pytest.mark.parametrize("main,argv", [(bench_prefix_beam.main, ["hashed=0"]),
                                       (bench_beam_compile.main, ["stepwise=1"]),
                                       (bench_study_turns.main, [])])
def test_scripts_run_on_the_card_unless_asked_for_the_cpu(main, argv):
    """Without ``device=`` the scripts ask for ``cuda`` and, with no card,
    refuse before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run the full benchmark")
    with pytest.raises(RuntimeError, match="device=cpu"):
        main(argv)


def test_study_turns_times_only_on_the_card():
    """``bench_study_turns`` times kernels: asked for the CPU, it refuses."""
    with pytest.raises(SystemExit, match="needs the card"):
        bench_study_turns.main(["device=cpu", "T=4"])
