"""Port's LSTM direction vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The LSTM
kernel itself is held against its plain version in test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from pytorch_asr_tpu.models.encoder_bilstm import _lstm_scan
from pytorch_asr_tpu.ops.lstm_pallas import lstm_seq as jax_lstm_seq
from pytorch_asr_tpu_torch.ops import build, lstm_cuda

# float32 recurrences over <= 40 steps in two frameworks: the dot products
# sum in other orders, 1e-5 as in the JAX package's own kernel test.
F32_TOL = 1e-5
# bfloat16 outputs: both round the same float32 value, so they differ by at
# most one bf16 step where the float32 values straddle a rounding boundary.
BF16_TOL = 1e-2


def _case(seed, B=4, T=40, D=24, H=16, ragged=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((D, 4 * H)) * 0.3).astype(np.float32)
    whh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    lengths = (np.array([T] + list(rng.integers(0, T, size=B - 1)), np.int32)
               if ragged else np.full(B, T, np.int32))
    return x, wih, whh, bias, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _scan_ref(x, wih, whh, bias, lengths, reverse):
    """``_lstm_scan`` over the projected inputs, with the window mask."""
    T = x.shape[1]
    xp = jnp.swapaxes(jnp.asarray(x) @ jnp.asarray(wih) + jnp.asarray(bias), 0, 1)
    valid = jnp.arange(T)[:, None] < jnp.asarray(lengths)[None, :]
    hs = _lstm_scan(xp, jnp.asarray(whh), valid, reverse=reverse)
    return np.asarray(jnp.swapaxes(jnp.where(valid[..., None], hs, 0.0), 0, 1))


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_interpret(reverse, ragged):
    x, wih, whh, bias, lengths = _case(0, ragged=ragged)
    ours = lstm_cuda.lstm_seq_plain(*_torch(x, wih, whh, bias, lengths), reverse)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_lstm_seq(*map(jnp.asarray, (x, wih, whh, bias, lengths)), reverse)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_lstm_scan(reverse, ragged):
    x, wih, whh, bias, lengths = _case(1, ragged=ragged)
    ours = lstm_cuda.lstm_seq_plain(*_torch(x, wih, whh, bias, lengths), reverse)
    np.testing.assert_allclose(ours.numpy(), _scan_ref(x, wih, whh, bias, lengths, reverse),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bf16_inputs_match_pallas_interpret(reverse):
    """x and wih in bf16, whh and bias fp32, output bf16: the kernel's types."""
    x, wih, whh, bias, lengths = _case(2)
    xt, wt, ht, bt, lt = _torch(x, wih, whh, bias, lengths)
    ours = lstm_cuda.lstm_seq_plain(xt.bfloat16(), wt.bfloat16(), ht, bt, lt, reverse,
                                    torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = jax_lstm_seq(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wih, jnp.bfloat16),
                           jnp.asarray(whh), jnp.asarray(bias), jnp.asarray(lengths),
                           reverse, jnp.bfloat16)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch(*_case(3))
    build.reset_launches()
    torch.testing.assert_close(lstm_cuda.lstm_seq(*args, True),
                               lstm_cuda.lstm_seq_plain(*args, True), rtol=0, atol=0)
    assert build.LAUNCHES["lstm_seq"] == 0


def test_zero_outside_window_and_reverse_starts_at_len():
    """The reverse direction's first step is t = len-1 from a zero state."""
    x, wih, whh, bias, lengths = _case(4, B=3, T=12)
    lengths[:] = [12, 7, 0]
    out = lstm_cuda.lstm_seq_plain(*_torch(x, wih, whh, bias, lengths), True).numpy()
    assert not out[1, 7:].any() and not out[2].any()
    H = whh.shape[0]
    gates = x[1, 6] @ wih + bias
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    c = sig(gates[:H]) * np.tanh(gates[2 * H:3 * H])
    np.testing.assert_allclose(out[1, 6], sig(gates[3 * H:]) * np.tanh(c),
                               rtol=F32_TOL, atol=F32_TOL)
