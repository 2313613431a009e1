"""Port parity: the AM engine (canonical maps, moment folding, backends),
the surrogate calibration and the hardware cost model, against the JAX
reference.

Host-side folding and the cost model are numpy in both packages and are
held bitwise. Float32 convolutions and matmuls are held within 1e-5
relative to the output scale plus 1e-6: XLA's and PyTorch's CPU kernels
sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import hwmodel as jhw
from repro.core import surrogate as jsur
from repro.kernels import ref as jref
from repro_torch.core import engine, hwmodel, schemes, surrogate
from repro_torch.kernels import ref

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale + ATOL)


@pytest.fixture(scope="module")
def tables():
    """The port's CPU calibration (n = 2^18): bitwise the reference's."""
    return surrogate.moment_tables("cpu")


def test_moment_tables_equal_jax_bitwise(tables):
    jmu, jsg = jsur.moment_tables()
    np.testing.assert_array_equal(tables[0].view(np.uint32), jmu.view(np.uint32))
    np.testing.assert_array_equal(tables[1].view(np.uint32), jsg.view(np.uint32))


def test_calibrate_moments_equal_jax_at_reduced_n():
    n = 1 << 12
    stats = surrogate.seed_variant_stats(n=n, device="cpu")
    for v in schemes.AM_VARIANTS:
        want = jsur.calibrate_moments(schemes.scheme_map(v), n=n)
        assert stats[v] == want, v
        assert surrogate.calibrate_moments(schemes.scheme_map(v), n=n,
                                           device="cpu") == want
    assert stats["exact"] == {"mre": 0.0, "rmsre": 0.0}


@pytest.mark.parametrize("spelling", ["uniform:nm_si", "rr:3", "flat", "grid",
                                      "full", "pop_grid"])
def test_canonical_matmul_map_equals_jax(spelling):
    k, n, tk, tn = 70, 50, 32, 16
    rng = np.random.default_rng(0)
    gk, gn = -(-k // tk), -(-n // tn)
    slot = {"flat": rng.integers(0, 9, gk * gn), "grid": rng.integers(0, 9, (gk, gn)),
            "full": rng.integers(0, 9, (k, n)),
            "pop_grid": rng.integers(0, 9, (3, gk, gn))}.get(spelling, spelling)
    got = engine.canonical_matmul_map(slot, k, n, tile_k=tk, tile_n=tn)
    want = jengine.canonical_matmul_map(slot, k, n, tile_k=tk, tile_n=tn)
    assert got.pop == want.pop
    np.testing.assert_array_equal(got.vids, want.vids)


@pytest.mark.parametrize("spelling", ["uniform:pm_csi", "rr:2", "flat", "full",
                                      "pop_flat", "pop_full"])
def test_canonical_conv_map_equals_jax(spelling):
    f = 10
    rng = np.random.default_rng(1)
    slot = {"flat": rng.integers(0, 9, f * 9), "full": rng.integers(0, 9, (f, 3, 3)),
            "pop_flat": rng.integers(0, 9, (4, f * 9)),
            "pop_full": rng.integers(0, 9, (2, f, 3, 3))}.get(spelling, spelling)
    got = engine.canonical_conv_map(slot, f, 3, 3)
    want = jengine.canonical_conv_map(slot, f, 3, 3)
    assert got.pop == want.pop
    np.testing.assert_array_equal(got.vids, want.vids)


@pytest.mark.parametrize("layout", ["tap_major", "channel_major"])
@pytest.mark.parametrize("pop", [False, True])
def test_fold_conv_gemm_weights_bitwise_vs_jax(tables, layout, pop):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((12, 3, 3, 10)).astype(np.float32)
    vids = rng.integers(0, 9, (5, 12 * 9) if pop else (12 * 9,))
    for noise_scale in (1.0, 4.0):
        got = engine.fold_conv_gemm_weights(
            w, engine.canonical_conv_map(vids, 12, 3, 3), noise_scale=noise_scale,
            layout=layout, device="cpu")
        want = jengine.fold_conv_gemm_weights(
            w, jengine.canonical_conv_map(vids, 12, 3, 3), noise_scale=noise_scale,
            layout=layout)
        for g, wt in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint32), wt.view(np.uint32))


def test_patch_matrix_and_population_padding_equal_jax():
    x = np.random.default_rng(3).random((3, 8, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(engine.conv_patch_matrix(x, 3, 3),
                                  jengine.conv_patch_matrix(x, 3, 3))
    np.testing.assert_array_equal(engine.conv_patch_matrix(_t(x), 3, 3).numpy(),
                                  jengine.conv_patch_matrix(x, 3, 3))
    for p in (1, 2, 3, 5, 8, 24):
        for block in (1, 2, 4):
            assert engine.population_blocks(p, block) == jengine.population_blocks(p, block)
            g = np.arange(p * 2).reshape(p, 2)
            np.testing.assert_array_equal(engine.pad_population(g, block),
                                          jengine.pad_population(g, block))


def test_hwmodel_costs_equal_jax():
    rng = np.random.default_rng(4)
    pop = rng.integers(0, 9, (7, 198))
    assert hwmodel.sequence_cost(pop[0]) == jhw.sequence_cost(pop[0])
    got, want = hwmodel.sequence_cost_batch(pop), jhw.sequence_cost_batch(pop)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(hwmodel.objectives_batch(pop), jhw.objectives_batch(pop))


def test_exact_and_bitexact_conv_backends_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 7, 7, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    slot = rng.integers(0, 9, (4, 3, 3))
    _close(engine.am_conv2d(_t(x), _t(w)).numpy(),
           jengine.am_conv2d(jnp.asarray(x), jnp.asarray(w)))
    want = np.asarray(jax.jit(lambda a, b: jengine.am_conv2d(
        a, b, slot, backend="bitexact_ref"))(jnp.asarray(x), jnp.asarray(w)))
    got_ref = engine.am_conv2d(_t(x), _t(w), slot, backend="bitexact_ref").numpy()
    got_cuda = engine.am_conv2d(_t(x), _t(w), slot, backend="bitexact_cuda").numpy()
    _close(got_ref, want)
    # On the CPU, bitexact_cuda is the kernel's plain version: the same order.
    np.testing.assert_array_equal(got_cuda.view(np.uint32), got_ref.view(np.uint32))


def test_matmul_backends_vs_jax_and_fused_matmul_not_ported():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 20)).astype(np.float32)  # lead dims (2, 3)
    w = rng.standard_normal((20, 6)).astype(np.float32)
    vids = rng.integers(0, 9, (20, 6))
    _close(engine.am_matmul(_t(x), _t(w)).numpy(),
           jengine.am_matmul(jnp.asarray(x), jnp.asarray(w)))
    want = jax.jit(lambda a, b: jengine.am_matmul(a, b, vids, backend="bitexact_ref"))(
        jnp.asarray(x), jnp.asarray(w))
    for backend in ("bitexact_ref", "bitexact_cuda"):
        got = engine.am_matmul(_t(x), _t(w), vids, backend=backend)
        assert got.shape == (2, 3, 6)
        _close(got.numpy(), want)
    # The surrogate_fused matmul is ported (B5, B6): it runs, keeps the lead
    # dims, and matches the per-call surrogate_torch spelling.
    fused = engine.am_matmul(_t(x), _t(w), vids, backend="surrogate_fused", key=0)
    _close(fused.numpy(), engine.am_matmul(_t(x), _t(w), vids, backend="surrogate_torch",
                                           key=0).numpy())
    moments = engine.am_matmul(_t(x), _t(w), vids, backend="surrogate_fused", key=0,
                               return_moments=True)
    assert fused.shape == moments[0].shape == moments[1].shape == (2, 3, 6)


def test_surrogate_matmul_moments_vs_jax(tables):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 20)).astype(np.float32)
    w = rng.standard_normal((20, 6)).astype(np.float32)
    vids = rng.integers(0, 9, (3, 20, 6))
    got = engine.am_matmul(_t(x), _t(w), vids, backend="surrogate_torch",
                           return_moments=True)
    want = jengine.am_matmul(jnp.asarray(x), jnp.asarray(w), vids,
                             backend="surrogate_xla", key=jax.random.PRNGKey(0),
                             return_moments=True)
    for g, wt in zip(got, want):
        assert g.shape == (3, 5, 6)
        _close(g.numpy(), wt)


def test_surrogate_conv_ref_with_reference_noise(tables):
    """The reference's z handed over: same output within tolerance."""
    rng = np.random.default_rng(8)
    x = rng.random((2, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    slot = rng.integers(0, 9, (5, 3, 3)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    for scale in (1.0, 1000.0):
        want = np.asarray(jref.am_conv2d_surrogate_ref(
            jnp.asarray(x), jnp.asarray(w), slot, key, scale))
        z = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
        got = ref.am_conv2d_surrogate_ref(_t(x), _t(w), slot, _t(z), scale,
                                          moment_tables=tables).numpy()
        _close(got, want)


def test_surrogate_conv_backends_agree_and_share_noise(tables):
    """Fused (im2col GEMMs) and per-genome torch convs agree; a population
    call equals the per-genome calls (common random numbers)."""
    rng = np.random.default_rng(9)
    x = _t(rng.random((2, 8, 8, 3)).astype(np.float32))
    w = _t(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    genomes = rng.integers(0, 9, (3, 4 * 9))
    fused = engine.am_conv2d(x, w, genomes, backend="surrogate_fused", key=11)
    torch_ = engine.am_conv2d(x, w, genomes, backend="surrogate_torch", key=11)
    assert fused.shape == (3, 2, 6, 6, 4)
    _close(fused.numpy(), torch_.numpy())
    for p in range(3):
        one = engine.am_conv2d(x, w, genomes[p], backend="surrogate_fused", key=11)
        _close(one.numpy(), fused[p].numpy())
    mean, var = engine.am_conv2d(x, w, genomes, backend="surrogate_fused",
                                 return_moments=True)
    assert float(var.min()) >= 0.0 and mean.shape == fused.shape
    with pytest.raises(ValueError, match="key"):
        engine.am_conv2d(x, w, genomes, backend="surrogate_torch")


def test_select_backend():
    assert engine.select_backend("conv2d", has_map=False, work=10) == "exact"
    assert engine.select_backend("conv2d", has_map=True, work=10,
                                 device="cuda") == "bitexact_cuda"
    assert engine.select_backend("conv2d", has_map=True, work=10,
                                 device="cpu") == "bitexact_ref"
    assert engine.select_backend("matmul", has_map=True, work=1 << 20) == "surrogate_fused"
    with pytest.raises(ValueError, match="unknown AM backend"):
        engine.get_backend("bitexact_pallas")


def test_crn_normal_is_a_function_of_key_and_shape():
    a = surrogate.crn_normal(5, (3, 4), "cpu")
    np.testing.assert_array_equal(a.numpy(), surrogate.crn_normal(5, (3, 4), "cpu").numpy())
    assert not torch.equal(a, surrogate.crn_normal(6, (3, 4), "cpu"))
    assert surrogate.fold_in(5, 0) != surrogate.fold_in(5, 1)
    assert surrogate.fold_in(5, 1) == surrogate.fold_in(5, 1)
