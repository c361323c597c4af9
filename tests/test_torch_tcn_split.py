"""The TCN block's model-axis split: K6's training pair at a GLU half-width
Cm below C, on the CPU (its plain versions, which the card's kernels are
held to in ``chip_smoke.py``).

Model rank k of m takes the GLU pairs ``[k cm, (k+1) cm)`` of w_conv and
b_conv (with their gate columns C + the same), the matching w_point rows
and b_point / m, as the JAX package's ``TCNBlock._tp_pallas`` slices them.
Each rank's block body, and its seven gradients, against JAX's
``tcn_block_train`` in interpret mode on the same slices; the m bodies and
their gradients summed against the square block.  Multi-rank training
through the split is ``tests/test_torch_train_ranks.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_asr_tpu_torch.ops import tcn_cuda

B, T, C, K = 2, 48, 16, 5
# float32 on both sides; the products sum in other orders (as
# tests/test_torch_tcn.py holds the square block).
BODY_TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lengths = np.array([T, T - 13])
    x = f(B, T, C) * (np.arange(T)[None, :, None] < lengths[:, None, None])
    p = [1 + 0.1 * f(C), 0.1 * f(C), f(K, C, 2 * C) / (K * C) ** 0.5, 0.1 * f(2 * C),
         f(C, C) / C ** 0.5, 0.1 * f(C)]
    w = f(B, T, C)
    return x.astype(np.float32), [a.astype(np.float32) for a in p], w


def _slice(p, k: int, m: int):
    """Rank k's weights of m, as ``_tp_pallas`` and ``TCNBlock._split`` take them."""
    s, b, wc, bc, wp, bp = p
    cm = C // m
    lin, gate = slice(k * cm, (k + 1) * cm), slice(C + k * cm, C + (k + 1) * cm)
    return [s, b, np.concatenate([wc[:, :, lin], wc[:, :, gate]], axis=2),
            np.concatenate([bc[lin], bc[gate]]), wp[lin], bp / np.float32(m)]


def _port(x, p, w, dilation):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in (x, *p)]
    y = tcn_cuda.tcn_block_train(*ts, dilation)
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax(x, p, w, dilation):
    import jax
    import jax.numpy as jnp

    from pytorch_asr_tpu.ops import runtime
    from pytorch_asr_tpu.ops.dilated_conv_pallas import tcn_block_train

    runtime.force_interpret(True)
    try:
        args = [jnp.asarray(a) for a in (x, *p)]
        y = tcn_block_train(*args, dilation)
        grads = jax.grad(lambda *a: jnp.sum(tcn_block_train(*a, dilation) * w),
                         argnums=tuple(range(7)))(*args)
    finally:
        runtime.force_interpret(None)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("m,k,dilation", [(2, 1, 1), (4, 2, 4), (4, 3, 8)])
def test_split_width_matches_jax_interpret(m, k, dilation):
    """One rank's body at Cm = C / m and its seven gradients against JAX's
    Pallas kernel (interpret mode), which reads the widths off the weights."""
    x, p, w = _case(m * 10 + k)
    ps = _slice(p, k, m)
    assert ps[2].shape == (K, C, 2 * C // m) and ps[4].shape == (C // m, C)
    y, grads = _port(x, ps, w, dilation)
    y_ref, grads_ref = _jax(x, ps, w, dilation)
    _close(y, y_ref, BODY_TOL, "y")
    for name, g, g_ref in zip(("x", "ln_scale", "ln_bias", "w_conv", "b_conv", "w_point",
                               "b_point"), grads, grads_ref):
        assert g.shape == g_ref.shape, name
        _close(g, g_ref, GRAD_TOL, name)


@pytest.mark.parametrize("m", [2, 4])
def test_slices_sum_to_the_square_block(m):
    """The m ranks' bodies sum to the square block's, their x and LayerNorm
    gradients sum to its gradients, their conv and pointwise weight
    gradients are its gradients' slices, and b_point's, through the / m
    each rank's input takes, sum to its gradient."""
    x, p, w = _case(50 + m)
    y, grads = _port(x, p, w, 2)
    parts = [_port(x, _slice(p, k, m), w, 2) for k in range(m)]
    _close(sum(part[0] for part in parts), y, BODY_TOL, "y")
    for i, name in enumerate(("x", "ln_scale", "ln_bias")):
        _close(sum(part[1][i] for part in parts), grads[i], GRAD_TOL, name)
    for k, (_, g) in enumerate(parts):
        sliced = _slice([grads[1], grads[2], grads[3], grads[4], grads[5], grads[6]], k, m)
        for name, got, want in zip(("w_conv", "b_conv", "w_point"), g[3:6], sliced[2:5]):
            _close(got, want, GRAD_TOL, f"{name} rank {k}")
    _close(sum(part[1][6] for part in parts) / m, grads[6], GRAD_TOL, "b_point")
