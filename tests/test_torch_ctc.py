"""The port's plain CTC loss vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages: the JAX scan
reference ``ops/ctc.py::ctc_loss`` and the Pallas kernel ``ctc_loss_pallas``
in interpret mode.  The K4 kernel itself is held against the plain version in
test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_asr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from pytorch_asr_tpu.ops.ctc import ctc_loss_mean as jax_ctc_loss_mean
from pytorch_asr_tpu.ops.ctc_pallas import ctc_loss_pallas
from pytorch_asr_tpu_torch.ops import build, ctc, ctc_cuda

# As tests/test_ctc_pallas.py holds the Pallas kernel to the scan: float32
# log-space recursions summed in other orders.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, B=5, T=40, V=7, Lmax=9):
    """Ragged rows plus the edge rows: a padded row (logit_len = label_len =
    0), an infeasible row (more labels than frames), and repeated labels."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logit_len = rng.integers(2 * Lmax + 2, T + 1, size=B).astype(np.int32)
    label_len = rng.integers(1, Lmax + 1, size=B).astype(np.int32)
    labels = np.zeros((B, Lmax), np.int32)
    for b in range(B):
        labels[b, : label_len[b]] = rng.integers(1, V, size=label_len[b])
    labels[0, :4] = [3, 3, 5, 5]                 # repeats block the skip
    label_len[0] = max(label_len[0], 4)
    logit_len[1] = label_len[1] = 0              # padded row
    logit_len[2], label_len[2] = 5, Lmax         # infeasible: 9 labels in 5 frames
    labels[2] = rng.integers(1, V, size=Lmax)
    return logits, logit_len, labels, label_len


def _port(args):
    logits, logit_len, labels, label_len = map(torch.from_numpy, args)
    logits = logits.clone().requires_grad_(True)
    loss = ctc.ctc_loss(logits, logit_len, labels, label_len)
    w = torch.linspace(0.5, 1.5, loss.shape[0])            # a non-uniform upstream grad
    (loss * w).sum().backward()
    return loss.detach().numpy(), logits.grad.numpy(), w.numpy()


def _jax(fn, args, w):
    logits, *rest = map(jnp.asarray, args)
    loss = fn(logits, *rest)
    grad = jax.grad(lambda lg: jnp.sum(fn(lg, *rest) * w))(logits)
    return np.asarray(loss), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_scan_reference(seed):
    args = _case(seed)
    loss, grad, w = _port(args)
    ref_loss, ref_grad = _jax(jax_ctc_loss, args, w)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL, atol=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_plain_matches_pallas_interpret(seed):
    args = _case(seed)
    loss, grad, w = _port(args)
    with pltpu.force_tpu_interpret_mode():
        ref_loss, ref_grad = _jax(ctc_loss_pallas, args, w)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL, atol=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_edge_rows_give_zero_loss_and_grad():
    loss, grad, _ = _port(_case(4))
    assert loss[1] == 0.0 and loss[2] == 0.0
    assert not grad[1].any() and not grad[2].any()
    assert np.all(loss[[0, 3, 4]] > 0)


def test_repeated_labels_block_the_skip():
    labels = torch.tensor([[3, 3, 5, 2]])
    skip = ctc.skip_allowed(labels, torch.tensor([4]))
    # odd s = 2k+1 holds label k; s=3 (second 3) may not skip from s=1.
    assert skip[0].tolist() == [False, False, False, False, False, True, False, True, False]


def test_ctc_loss_mean_matches_jax():
    args = _case(5)
    logits, logit_len, labels, label_len = map(torch.from_numpy, args)
    ours = ctc.ctc_loss_mean(logits, logit_len, labels, label_len)
    ref = jax_ctc_loss_mean(*map(jnp.asarray, args))
    np.testing.assert_allclose(float(ours), float(ref), rtol=LOSS_RTOL)


def test_matches_torch_ctc_loss_on_feasible_rows():
    """torch's own CTC as a third opinion, with zero_infinity on."""
    args = _case(6)
    logits, logit_len, labels, label_len = map(torch.from_numpy, args)
    ours = ctc.ctc_loss(logits, logit_len, labels, label_len)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(logits, -1).transpose(0, 1), labels.long(), logit_len.long(),
        label_len.long(), blank=0, reduction="none", zero_infinity=True)
    torch.testing.assert_close(ours, ref, rtol=LOSS_RTOL, atol=LOSS_RTOL)


def test_cuda_wrapper_takes_plain_version_on_cpu():
    args = _case(7)
    logits, logit_len, labels, label_len = map(torch.from_numpy, args)
    build.reset_launches()
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    la = ctc_cuda.ctc_loss(a, logit_len, labels, label_len)
    lb = ctc.ctc_loss(b, logit_len, labels, label_len)
    la.sum().backward()
    lb.sum().backward()
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    assert build.LAUNCHES["ctc_alpha"] == build.LAUNCHES["ctc_beta"] == 0
