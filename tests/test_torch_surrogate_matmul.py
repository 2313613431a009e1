"""Port parity: the plain versions of the fused surrogate matmuls B5, B6 and
B7 (``repro_torch.kernels.ops``) against the JAX package's kernel ops, run
as the Pallas kernels in interpret mode (small blocks) and as the fused-XLA
spelling.

The port pins its summation order (k blocks of 16, sequential within a
block); XLA and the Pallas grid sum in their own orders (ROADMAP C3), so
the two are held within the float32 summation bound: for a sum of K
products, |got - want| <= 2 K eps sum_k |x_k w_k| (each side's error is at
most K eps times the sum of magnitudes). The noisy output adds, through
|sqrt(a) - sqrt(b)| <= sqrt(|a - b|), at most |z| sqrt(2 K eps (x^2 @ |w_var|)),
and one rounding of the result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import surrogate
from repro_torch.kernels import ops, ref

EPS = float(np.finfo(np.float32).eps)
BLOCK = (8, 8, 8)
JAX_IMPLS = ("kernel", "fused_xla")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _operands(rng, x_shape, w_shape):
    x = rng.standard_normal(x_shape).astype(np.float32)
    wm = rng.standard_normal(w_shape).astype(np.float32)
    wv = (rng.standard_normal(w_shape) ** 2 * 1e-3).astype(np.float32)
    return x, wm, wv


def _sum_bound(x, w):
    """2 K eps (|x| @ |w|), broadcasting a population axis on either side."""
    k = x.shape[-1]
    return 2 * k * EPS * np.matmul(np.abs(x.astype(np.float64)), np.abs(w.astype(np.float64)))


def _assert_moments(got, want, x, wm, wv):
    mean, var = (np.asarray(t) for t in got)
    wmean, wvar = (np.asarray(t) for t in want)
    assert mean.shape == wmean.shape and var.shape == wvar.shape
    assert np.all(np.abs(mean - wmean) <= _sum_bound(x, wm))
    assert np.all(np.abs(var - wvar) <= _sum_bound(x * x, wv))


def _assert_noisy(got, want, x, wm, wv, z):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = (_sum_bound(x, wm) + np.abs(z) * np.sqrt(_sum_bound(x * x, wv))
           + EPS * np.abs(want))
    assert np.all(np.abs(got - want) <= tol)


# (M, K, N): block-aligned, ragged everywhere, one narrow output (N=4), K
# over several k blocks of 16 with a ragged last one.
SHAPES = [(16, 32, 16), (37, 45, 29), (5, 70, 4)]


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("mkn", SHAPES)
def test_b5_single_vs_jax(impl, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    x, wm, wv = _operands(rng, (m, k), (k, n))
    z = rng.standard_normal((m, n)).astype(np.float32)
    want = jops.am_surrogate_matmul_epilogue(x, wm, wv, z, block=BLOCK, impl=impl)
    got = ops.am_surrogate_matmul_epilogue(_t(x), _t(wm), _t(wv), _t(z))
    _assert_noisy(got.numpy(), want, x, wm, wv, z)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("pop_x", [False, True])
def test_b5_population_vs_jax(impl, pop_x):
    p, m, k, n = 3, 21, 40, 13
    rng = np.random.default_rng(10 + pop_x)
    x, wm, wv = _operands(rng, (p, m, k) if pop_x else (m, k), (p, k, n))
    z = rng.standard_normal((m, n)).astype(np.float32)
    want = jops.am_surrogate_matmul_epilogue(x, wm, wv, z, block=BLOCK, impl=impl)
    got = ops.am_surrogate_matmul_epilogue(_t(x), _t(wm), _t(wv), _t(z))
    assert got.shape == (p, m, n)
    _assert_noisy(got.numpy(), want, x, wm, wv, z)


def test_b5_population_shares_z_and_equals_single_calls():
    """Each genome of a population call is bitwise its own single call (the
    order is the same), with the one z shared across the population."""
    rng = np.random.default_rng(20)
    x, wm, wv = _operands(rng, (3, 9, 33), (3, 33, 7))
    z = _t(rng.standard_normal((9, 7)))
    pop = ops.am_surrogate_matmul_epilogue(_t(x), _t(wm), _t(wv), z)
    shared = ops.am_surrogate_matmul_epilogue(_t(x[0]), _t(wm), _t(wv), z)
    for p in range(3):
        one = ops.am_surrogate_matmul_epilogue(_t(x[p]), _t(wm[p]), _t(wv[p]), z)
        np.testing.assert_array_equal(pop[p].numpy().view(np.uint32),
                                      one.numpy().view(np.uint32))
        one = ops.am_surrogate_matmul_epilogue(_t(x[0]), _t(wm[p]), _t(wv[p]), z)
        np.testing.assert_array_equal(shared[p].numpy().view(np.uint32),
                                      one.numpy().view(np.uint32))


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("mkn", SHAPES)
def test_b6_folded_moments_vs_jax(impl, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(30 + m)
    x, wm, wv = _operands(rng, (m, k), (k, n))
    want = jops.am_surrogate_moments_folded(x, wm, wv, block=BLOCK, impl=impl)
    got = ops.am_surrogate_moments_folded(_t(x), _t(wm), _t(wv))
    _assert_moments(got, want, x, wm, wv)


@pytest.mark.parametrize("impl", JAX_IMPLS)
@pytest.mark.parametrize("mkn", SHAPES)
def test_b7_unfolded_moments_vs_jax(impl, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(40 + m)
    x, w, _ = _operands(rng, (m, k), (k, n))
    mu = (rng.standard_normal((k, n)) * 1e-3).astype(np.float32)
    sg = np.abs(rng.standard_normal((k, n)) * 1e-2).astype(np.float32)
    want = jops.am_surrogate_moments(x, w, mu, sg, block=BLOCK, impl=impl)
    got = ops.am_surrogate_moments(_t(x), _t(w), _t(mu), _t(sg))
    # The folded weights are elementwise float32 in both packages: bitwise.
    wm, wv = (np.asarray(t) for t in (w * (1.0 + mu), (w * w) * (sg * sg)))
    _assert_moments(got, want, x, wm, wv)
    # B7 equals B6 on the folded weights, bitwise (the kernel forms them so).
    folded = ops.am_surrogate_moments_folded(_t(x), _t(wm), _t(wv))
    for g, f in zip(got, folded):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), f.numpy().view(np.uint32))


def test_noisy_unfolded_matmul_with_reference_noise(monkeypatch):
    """ops.am_surrogate_matmul with the reference's z handed over."""
    m, k, n = 11, 36, 9
    rng = np.random.default_rng(50)
    x, w, _ = _operands(rng, (m, k), (k, n))
    mu = (rng.standard_normal((k, n)) * 1e-3).astype(np.float32)
    sg = np.abs(rng.standard_normal((k, n)) * 1e-2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.normal(key, (m, n), jnp.float32))
    monkeypatch.setattr(surrogate, "crn_normal", lambda key, shape, device="cuda": _t(z))
    want = jops.am_surrogate_matmul(x, w, mu, sg, key, block=BLOCK, impl="kernel")
    got = ops.am_surrogate_matmul(_t(x), _t(w), _t(mu), _t(sg), key=4)
    wm, wv = (w * (1.0 + mu)), (w * w) * (sg * sg)
    _assert_noisy(got.numpy(), want, x, wm, wv, z)


def test_plain_order_is_blocks_of_16():
    """The plain version's sum is sequential within k blocks of 16 and then
    over blocks: a case where that order and a single sequential sum give
    different float32 results."""
    x = torch.ones((1, 32))
    w = torch.tensor([[1.0]] + [[2.0 ** -24]] * 31)
    # Block 0: each 1 + 2^-24 rounds back to 1; block 1 sums 16 * 2^-24 =
    # 2^-20 exactly. One sequential sum would stay at 1.
    for mean, _ in (ref.am_surrogate_moments_ref(x, w, w),
                    ops.am_surrogate_moments_folded(x, w, w)):
        assert float(mean) == 1.0 + 2.0 ** -20


def test_entry_points_reject_other_devices():
    x = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="no AM kernel for device"):
        ops.am_surrogate_moments_folded(x, x.T, x.T)
