"""The 3xTF32 arithmetic of K5 and K6 (``csrc/tcn_block.cu``,
``tc_gemm_kernel``), emulated in numpy: no device.

The kernel splits each fp32 operand a into big = tf32(a), rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``), and small = tf32(a - big),
and takes each product as small*big + big*small + big*big, accumulated in
fp32 a k-step of 8 at a time, the small terms first.  These tests rehearse
that arithmetic on the CPU: the split rebuilds an operand, the product at
config 3's reduction depths stays well inside the JAX package's tolerance,
where a single TF32 product would not, and so does the whole forward block
(LayerNorm, the conv with its GLU, the pointwise product) built on it.
"""

from __future__ import annotations

import numpy as np
import pytest

TCN_TOL = 2e-4   # the JAX package's tolerance for its TCN kernel, of the largest entry
DEPTHS = {"conv, dw_conv": 1920, "dxn": 3840, "dw_point, dw_conv over rows": 6400,
          "pointwise, dglu": 384}


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the bits: add half of the dropped 13 bits' unit,
    then clear them (finite inputs)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32_rna(a)
    return big, tf32_rna(np.asarray(a, np.float32) - big)


def mma_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, K) @ (K, N) as the kernel takes it: per k-step of 8, the three
    TF32 products added to an fp32 accumulator, small terms first.  TF32
    products are exact in fp32 (11-bit by 11-bit significands)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc += x[:, k:k + 8] @ y[k:k + 8]
    return acc


def test_rna_rounds_to_nearest_on_the_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                       # tf32's unit at 1: 10 mantissa bits
    cases = {one: one, one + ulp: one + ulp,
             one + ulp * np.float32(0.25): one,        # below half a unit: down
             one + ulp * np.float32(0.75): one + ulp,  # above half: up
             one + ulp * np.float32(0.5): one + ulp,   # a tie: away from zero
             -(one + ulp * np.float32(0.5)): -(one + ulp)}
    for x, want in cases.items():
        got = tf32_rna(np.array([x], np.float32))[0]
        assert got == want, (x, got, want)
        assert got.view(np.uint32) & 0x1FFF == 0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_big_plus_small_rebuilds_the_operand(scale):
    a = (np.random.default_rng(0).standard_normal(100_000) * scale).astype(np.float32)
    big, small = split(a)
    assert np.all(big.view(np.uint32) & 0x1FFF == 0) and np.all(small.view(np.uint32) & 0x1FFF == 0)
    rebuilt = big.astype(np.float64) + small.astype(np.float64)
    rel = np.abs(rebuilt - a.astype(np.float64)) / np.abs(a.astype(np.float64))
    assert rel.max() <= 2.0 ** -21
    # big alone keeps only tf32's precision (about 2^-11 relative).
    assert (np.abs(big.astype(np.float64) - a) / np.abs(a.astype(np.float64))).max() > 2.0 ** -14


@pytest.mark.parametrize("depth", list(DEPTHS.values()), ids=list(DEPTHS))
def test_3xtf32_product_at_config3_depths(depth):
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((32, depth)).astype(np.float32)
    b = rng.standard_normal((depth, 24)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = mma_3xtf32(a, b)
    assert np.abs(got - want).max() / np.abs(want).max() <= TCN_TOL / 10


def test_one_tf32_product_misses_the_tolerance():
    """Why the split: a single TF32 product (about three decimal digits)
    at the conv's depth is far off the fp32 budget the 3xTF32 one keeps."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((32, 1920)).astype(np.float32)
    b = rng.standard_normal((1920, 24)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    one = tf32_rna(a) @ tf32_rna(b)
    three = mma_3xtf32(a, b)
    err = lambda got: np.abs(got - want).max() / np.abs(want).max()  # noqa: E731
    assert err(one) > TCN_TOL / 10 > 10 * err(three)


def _block_forward(x, p, dilation: int, product):
    """The block body y = (GLU(conv(LN(x)))) @ w_point + b_point for x (T, C),
    its two products taken by ``product``: the conv as the kernel's implicit
    GEMM, A = the K taps of xn side by side (0 outside [0, T)), B = w_conv
    as (K C, 2C); the LayerNorm and the GLU in the dtype of x."""
    ln_scale, ln_bias, w_conv, b_conv, w_point, b_point = p
    T, C = x.shape
    K = w_conv.shape[0]
    mu = x.mean(-1, keepdims=True)
    var = np.square(x - mu).mean(-1, keepdims=True)
    xn = (x - mu) / np.sqrt(var + x.dtype.type(1e-6)) * ln_scale + ln_bias
    pad = (K // 2) * dilation
    padded = np.pad(xn, ((pad, pad), (0, 0)))
    taps = np.concatenate([padded[k * dilation: k * dilation + T] for k in range(K)], axis=1)
    acc = product(taps, w_conv.reshape(K * C, 2 * C)) + b_conv
    glu = acc[:, :C] / (1 + np.exp(-acc[:, C:]))
    return product(glu, w_point) + b_point


def test_3xtf32_forward_block_at_config3_width():
    """K5's and K6's forward at config 3's C 384, K 5 and its widest
    dilation 16 on a short seeded row (T 48: every tap reaches past an edge
    somewhere): fp32 LayerNorm and GLU, both products 3xTF32, against the
    same block in float64."""
    C, K, T, d = 384, 5, 48, 16
    rng = np.random.default_rng(16)
    x = rng.standard_normal((T, C)).astype(np.float32)
    p = [1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
         rng.standard_normal((K, C, 2 * C)) / np.sqrt(K * C), 0.1 * rng.standard_normal(2 * C),
         rng.standard_normal((C, C)) / np.sqrt(C), 0.1 * rng.standard_normal(C)]
    want = _block_forward(x.astype(np.float64), p, d, np.matmul)
    got = _block_forward(x, [t.astype(np.float32) for t in p], d, mma_3xtf32)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / np.abs(want).max() <= TCN_TOL / 10
