"""The port's paired CTC alpha recursion (two frames an iteration) vs the JAX
package's ``_fwd_kernel_paired``, on the CPU.

The JAX kernel runs in interpret mode behind its module switch
``ctc_pallas.PAIRED_FWD``, set inside ``try/finally`` as
``tests/test_ctc_pallas.py`` sets it; the port's loss runs its plain paired
recursion (``ops/ctc.py::PAIRED_PLAIN``).  Inputs are made with numpy from a
seed: odd lengths that freeze mid-pair, a row of one frame (the t = 0 pair
alone), an odd T; one run of JAX's kernel serves every comparison.  The
kernel is held to this plain version in ``test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_asr_tpu.ops import ctc_pallas as cp
from pytorch_asr_tpu_torch.ops import build, ctc, ctc_cuda

# The JAX study's own tolerances for its paired kernel against the scan
# (tests/test_ctc_pallas.py): the composed step sums in another order.
LOSS_TOL, GRAD_TOL = 1e-4, 2e-3
# Alphas, paired plain vs JAX's paired kernel and vs the port's unpaired
# recursion: log values up to ~T log V, float32.
ALPHA_RTOL, ALPHA_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(T):
    """The JAX study's case: lengths T, T-1, T-2, 37, 1, 5 over 6 rows."""
    rng = np.random.default_rng(7)
    B, V, S = 6, 12, 9
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    llen = np.array([T, T - 1, T - 2, 37, 1, 5], np.int32)
    toks = rng.integers(1, V, size=(B, S)).astype(np.int32)
    tlen = np.array([S, S - 1, 3, 5, 1, 2], np.int32)
    return logits, llen, toks, tlen


@pytest.fixture(scope="module")
def paired_reference():
    """One interpret-mode run of JAX's paired kernel at an odd T (71): the
    two rules that ``ctc_loss_pallas``'s custom VJP runs, its forward (loss
    and the alphas among its residuals) and its backward (the logits'
    gradient for a cotangent of ones)."""
    args = _case(71)
    jargs = tuple(map(jnp.asarray, args))
    try:
        with pltpu.force_tpu_interpret_mode():
            cp.PAIRED_FWD = True
            loss, res = cp._forward_impl(*jargs, 0)
            grad = cp._bwd_rule(0, res, jnp.ones_like(loss))[0]
    finally:
        cp.PAIRED_FWD = False
    return args, np.asarray(loss), np.asarray(grad), np.asarray(res[2])


def test_loss_and_grad_match_the_paired_pallas_kernel(paired_reference):
    """An odd T: the last pair's second frame is padding."""
    args, ref, g_ref, _ = paired_reference
    logits = torch.from_numpy(args[0]).requires_grad_(True)
    loss = ctc.CTCLoss.apply(logits, *map(torch.from_numpy, args[1:]), 0, ctc.PAIRED_PLAIN)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(logits.grad.numpy(), g_ref, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_alphas_match_the_paired_pallas_kernel_and_the_unpaired_recursion(paired_reference):
    """Every live alpha (above the sentinel) of the paired plain recursion
    against JAX's paired kernel on the same lattice, and against the port's
    one-frame recursion; the sentinel states agree on both sides.  Rows of
    lengths 71, 70 and 69 freeze after a whole pair and mid-pair."""
    (logits, llen, toks, tlen), _, _, ref = paired_reference
    _, logp_tbs, _, skip = ctc.prep(torch.from_numpy(logits), torch.from_numpy(toks).long(),
                                    torch.from_numpy(tlen), 0)
    got, final = ctc.alphas_paired_plain(logp_tbs, skip, torch.from_numpy(llen))
    T, B, S = got.shape
    ref = torch.from_numpy(ref[:T, :B, :S].copy())
    live = ref > ctc.NEG_INF / 2
    assert torch.equal(live, got > ctc.NEG_INF / 2)
    torch.testing.assert_close(got[live], ref[live], rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    torch.testing.assert_close(final, got[-1])
    one, _ = ctc.alphas_plain(logp_tbs, skip, torch.from_numpy(llen))
    torch.testing.assert_close(got[live], one[live], rtol=ALPHA_RTOL, atol=ALPHA_ATOL)


def test_paired_switch_routes_the_cpu_loss_to_the_paired_plain_version(monkeypatch):
    """``ctc_cuda.PAIRED_FWD`` picks the paired recursion; on CPU tensors
    that is its plain version, and no kernel is counted."""
    logits, llen, toks, tlen = map(torch.from_numpy, _case(71))
    monkeypatch.setattr(ctc_cuda, "PAIRED_FWD", True)
    build.reset_launches()
    got = ctc_cuda.ctc_loss(logits, llen, toks, tlen)
    want = ctc.CTCLoss.apply(logits, llen, toks, tlen, 0, ctc.PAIRED_PLAIN)
    assert torch.equal(got, want) and not any(build.LAUNCHES.values())
