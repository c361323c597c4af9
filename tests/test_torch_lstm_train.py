"""The port's LSTM training forward and backward vs the JAX package, on the CPU.

The plain versions that the K3 wrappers take for CPU tensors are held against
the JAX ``lstm_seq`` with its Pallas kernels in interpret mode: the residuals
of its training forward (``_vjp_fwd``) and ``jax.grad`` through its custom
VJP.  Inputs are made with numpy from a seed.  The kernels themselves are
held against these plain versions in test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_asr_tpu.models.encoder_bilstm import _lstm_scan
from pytorch_asr_tpu.ops.lstm_pallas import _vjp_fwd
from pytorch_asr_tpu.ops.lstm_pallas import lstm_seq as jax_lstm_seq
from pytorch_asr_tpu_torch.ops import build, lstm_cuda

# float32 residuals: the same arithmetic in two frameworks, summed in other
# orders; 1e-4 as the JAX package holds its own VJP to the scan.
F32_TOL = 1e-4
# bf16 residuals on both sides: each side rounds its own float32 gate values,
# which differ in the last bits, so an entry may land one bf16 step (2^-8
# relative) apart and carry that into the gradients.  Held relative to the
# largest entry: 3.5e-4 measured, against 4e-3 between bf16 and float32
# residuals.
BF16_TOL = 2e-3


def _case(seed, B=4, T=40, D=12, H=8):
    """Ragged rows: one of full length T (the reverse direction's first step
    is then t = T-1 from zeros), one of length 0, two in between."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((D, 4 * H)) * 0.3).astype(np.float32)
    whh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    lengths = np.array([T, 0] + list(rng.integers(1, T, size=B - 2)), np.int32)
    return x, wih, whh, bias, lengths


def _port_grads(x, wih, whh, bias, lengths, reverse, residual_dtype):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, wih, whh, bias)]
    out = lstm_cuda.lstm_seq(*ts, torch.from_numpy(lengths), reverse,
                             residual_dtype=residual_dtype)
    torch.tanh(out).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(x, wih, whh, bias, lengths, reverse, residual_dtype):
    def loss(x_, wih_, whh_, b_):
        return jnp.sum(jnp.tanh(jax_lstm_seq(x_, wih_, whh_, b_, jnp.asarray(lengths),
                                             reverse, None, residual_dtype)))

    with pltpu.force_tpu_interpret_mode():
        gs = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, wih, whh, bias)))
    return [np.asarray(g) for g in gs]


@pytest.mark.parametrize("reverse", [False, True])
def test_train_forward_residuals_match_pallas(reverse):
    x, wih, whh, bias, lengths = _case(0)
    out, acts, ct = lstm_cuda.lstm_seq_train_plain(
        *map(torch.from_numpy, (x, wih, whh, bias, lengths)), reverse,
        residual_dtype=torch.float32)
    with pltpu.force_tpu_interpret_mode():
        hs, res = _vjp_fwd(*map(jnp.asarray, (x, wih, whh, bias, lengths)), reverse,
                           None, jnp.float32)
    ref_acts, ref_ct = np.asarray(res[7]), np.asarray(res[8])
    assert acts.shape == ref_acts.shape and ct.shape == ref_ct.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(hs), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(acts.numpy(), ref_acts, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(ct.numpy(), ref_ct, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_grads_match_pallas_f32_residuals(reverse):
    args = _case(1)
    ours = _port_grads(*args, reverse, torch.float32)
    ref = _jax_grads(*args, reverse, jnp.float32)
    for name, p, r in zip(("dx", "dwih", "dwhh", "db"), ours, ref):
        np.testing.assert_allclose(p, r, rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_grads_match_scan_reference(reverse):
    """Against plain autograd of the lax.scan cell, no Pallas in the way."""
    x, wih, whh, bias, lengths = _case(2)
    ours = _port_grads(x, wih, whh, bias, lengths, reverse, torch.float32)
    T = x.shape[1]

    def loss(x_, wih_, whh_, b_):
        xp = jnp.swapaxes(x_ @ wih_ + b_, 0, 1)
        valid = jnp.arange(T)[:, None] < jnp.asarray(lengths)[None, :]
        hs = jnp.where(valid[..., None], _lstm_scan(xp, whh_, valid, reverse=reverse), 0.0)
        return jnp.sum(jnp.tanh(hs))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, wih, whh, bias)))
    for name, p, r in zip(("dx", "dwih", "dwhh", "db"), ours, ref):
        np.testing.assert_allclose(p, np.asarray(r), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_grads_match_pallas_bf16_residuals(reverse):
    """bf16 residuals, the training default on both sides: the port is held
    to JAX's bf16-residual gradients, not to something more exact."""
    args = _case(3)
    ours = _port_grads(*args, reverse, torch.bfloat16)
    ref = _jax_grads(*args, reverse, jnp.bfloat16)
    exact = _jax_grads(*args, reverse, jnp.float32)
    for name, p, r, e in zip(("dx", "dwih", "dwhh", "db"), ours, ref, exact):
        scale = np.abs(r).max()
        np.testing.assert_allclose(p, r, rtol=0, atol=BF16_TOL * scale, err_msg=name)
        # closer to JAX's bf16 gradients than JAX's bf16 is to its float32 ones
        assert np.abs(p - r).max() < np.abs(r - e).max(), name


def test_bf16_inputs_give_grads_in_input_types():
    """x and wih in bf16 (the model casts wih before the call): dx and dwih
    come back in bf16, dwhh and db in float32, as ``_vjp_bwd`` returns them."""
    x, wih, whh, bias, lengths = _case(4)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(wih).bfloat16().requires_grad_(True)
    ht, bt = (torch.from_numpy(a).requires_grad_(True) for a in (whh, bias))
    out = lstm_cuda.lstm_seq(xt, wt, ht, bt, torch.from_numpy(lengths), False, torch.bfloat16)
    out.float().sum().backward()
    assert (xt.grad.dtype, wt.grad.dtype) == (torch.bfloat16, torch.bfloat16)
    assert (ht.grad.dtype, bt.grad.dtype) == (torch.float32, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c, d: jax_lstm_seq(a, b, c, d, jnp.asarray(lengths),
                                                         False, jnp.bfloat16),
                         jnp.asarray(x, jnp.bfloat16), jnp.asarray(wih, jnp.bfloat16),
                         jnp.asarray(whh), jnp.asarray(bias))
        ref = vjp(jnp.ones(out.shape, jnp.bfloat16))
    for name, p, r in zip(("dx", "dwih", "dwhh", "db"), (xt, wt, ht, bt), ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(p.grad.float().numpy(), r, rtol=0,
                                   atol=BF16_TOL * np.abs(r).max(), err_msg=name)


def test_zero_length_rows_get_zero_grads():
    x, wih, whh, bias, lengths = _case(5)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = lstm_cuda.lstm_seq(xt, *map(torch.from_numpy, (wih, whh, bias, lengths)), True)
    out.sum().backward()
    assert not xt.grad[1].any()
    assert not xt.grad[2, lengths[2]:].any()


def test_grad_mode_picks_the_training_pair_and_counts_nothing_on_cpu():
    args = list(map(torch.from_numpy, _case(6)))
    build.reset_launches()
    with torch.no_grad():
        ref = lstm_cuda.lstm_seq(*args)
    x = args[0].clone().requires_grad_(True)
    out = lstm_cuda.lstm_seq(x, *args[1:])
    assert out.grad_fn is not None and out.grad_fn.name().startswith("LSTMSeq")
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    assert all(v == 0 for v in build.LAUNCHES.values())
