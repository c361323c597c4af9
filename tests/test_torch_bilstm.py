"""The port's BiLSTM layer op (K11's plain versions) vs the JAX package's
``bilstm_seq``, on the CPU.

JAX's ``bilstm_seq`` runs both directions in one Pallas program
(``_fwd_kernel_dual``, ``_bwd_kernel_dual``), here in interpret mode; the
port's ``bilstm_seq`` takes its plain version for CPU tensors: the one-
direction plain versions once a direction.  Inputs are made with numpy from
a seed, at the sizes of ``tests/test_lstm_pallas.py``'s dual-kernel tests.
The kernel itself is held against these plain versions, and against two K2
(K3) launches bit for bit, in ``test_torch_kernels_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_asr_tpu.ops.lstm_pallas import _dual_vjp_fwd
from pytorch_asr_tpu.ops.lstm_pallas import bilstm_seq as jax_bilstm_seq
from pytorch_asr_tpu_torch.ops import build, lstm_cuda

# float32 outputs, residuals and gradients on both sides: the same
# arithmetic summed in other orders, as tests/test_torch_lstm_train.py holds
# one direction.
F32_TOL = 1e-4


def _case(seed, B=4, T=37, D=12, H=16):
    """Stacked [forward, reverse] weights; ragged rows: full length, empty,
    two in between."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((2, D, 4 * H)) * 0.3).astype(np.float32)
    whh = (rng.standard_normal((2, H, 4 * H)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal((2, 4 * H)) * 0.1).astype(np.float32)
    lengths = np.array([T, 0] + list(rng.integers(1, T, size=B - 2)), np.int32)
    return x, wih, whh, bias, lengths


def test_forward_matches_pallas_dual_kernel():
    args = _case(0)
    got = lstm_cuda.bilstm_seq(*map(torch.from_numpy, args))
    with pltpu.force_tpu_interpret_mode():
        want = jax_bilstm_seq(*map(jnp.asarray, args), jnp.float32, jnp.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_train_forward_residuals_match_pallas_dual_kernel():
    """Output, gate activations and cell carries of both directions, as
    JAX's training forward saves them (float32 residuals)."""
    args = _case(1, B=3, T=24, D=8, H=8)
    out, acts, ct = lstm_cuda.bilstm_seq_train_plain(*map(torch.from_numpy, args),
                                                     residual_dtype=torch.float32)
    with pltpu.force_tpu_interpret_mode():
        hs, res = _dual_vjp_fwd(*map(jnp.asarray, args), None, jnp.float32)
    T = args[0].shape[1]
    actsf, ctf, actsb, ctb = (np.asarray(r)[:T] for r in res[9:13])
    np.testing.assert_allclose(out.numpy(), np.asarray(hs), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(acts.numpy(), np.stack([actsf, actsb]), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(ct.numpy(), np.stack([ctf, ctb]), rtol=F32_TOL, atol=F32_TOL)


def test_grads_match_pallas_dual_kernel():
    """``jax.grad`` through JAX's dual VJP against the port's training pair
    with float32 residuals, for a non-uniform upstream gradient."""
    x, wih, whh, bias, lengths = _case(2, B=2, T=24, D=8, H=8)
    g = np.random.default_rng(3).standard_normal((2, 24, 16)).astype(np.float32)
    params = [torch.from_numpy(a).requires_grad_(True) for a in (x, wih, whh, bias)]
    out = lstm_cuda.bilstm_seq(*params, torch.from_numpy(lengths),
                               residual_dtype=torch.float32)
    (out * torch.from_numpy(g)).sum().backward()

    def loss(*p):
        return jnp.sum(jax_bilstm_seq(*p, jnp.asarray(lengths), jnp.float32, jnp.float32)
                       * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, wih, whh, bias)))
    for name, p, r in zip(("dx", "dwih", "dwhh", "db"), params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_one_direction_twice(out_dtype):
    """On the CPU the layer is exactly the one-direction op once a direction,
    the outputs concatenated, and launches no kernel."""
    x, wih, whh, bias, lengths = map(torch.from_numpy, _case(4))
    build.reset_launches()
    got = lstm_cuda.bilstm_seq(x, wih, whh, bias, lengths, out_dtype)
    want = torch.cat([lstm_cuda.lstm_seq(x, wih[d], whh[d], bias[d], lengths, bool(d), out_dtype)
                      for d in (0, 1)], dim=-1)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert not any(build.LAUNCHES.values())
