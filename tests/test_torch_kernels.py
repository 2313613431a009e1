"""Port parity: the plain versions of the bit-exact kernels B2, B3, B4 and
their dispatch, against the JAX reference's oracles and golden fixtures.

Products are held bitwise. Sums are held bitwise where the order is the
same in both packages (the conv fixtures: Cin = 2, so one add per tap; the
matmul fixtures summed in the 4-lane order that XLA-CPU used, ROADMAP C1),
and elsewhere within the float32 summation error bound
``n_adds * eps * sum|p|``, because the reference leaves the order within a
tap or k block to XLA while the port pins it (sequential).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp32_mul as jfp
from repro.core import schemes as jschemes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import fp32_mul, schemes
from repro_torch.kernels import (approx_conv, approx_matmul, bitexact_emulator,
                                 cuda_build, ops, ref)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "artifacts"
          / "golden_bitexact.npz")
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_within_sum_bound(got, want, abs_sum, n_adds):
    """|got - want| <= 2 * n_adds * eps * sum|p| + one ulp of the result:
    two summation orders of the same float32 products."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 2 * n_adds * EPS * np.asarray(abs_sum, np.float64) + EPS * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))


# --- B4: stacked emulator -----------------------------------------------------


def test_b4_plain_equals_jax_per_map_batch():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    a[:4] = [0.0, np.inf, 1e-40, np.nan]
    maps = schemes.scheme_stack()
    got = ops.fp32_multiply_stacked(_t(a), _t(b), maps).numpy()
    assert got.shape == (9, 3000)
    for vid, variant in enumerate(jschemes.SEED_VARIANTS):
        want = jfp.fp32_multiply_batch(a, b, variant)
        np.testing.assert_array_equal(_bits(got[vid]), _bits(want), err_msg=variant)


@pytest.mark.parametrize("n_maps", [1, 3, 11])
def test_b4_plain_matches_jax_stacked_ops(n_maps):
    """Any map count and explicit (non-seed) maps: the JAX stacked op."""
    rng = np.random.default_rng(n_maps)
    maps = rng.integers(0, 5, (n_maps, 3, 48)).astype(np.int32)
    a = rng.standard_normal(700).astype(np.float32)
    b = rng.standard_normal(700).astype(np.float32)
    want = jops.fp32_multiply_stacked(a, b, maps, impl="fused_xla")
    got = ops.fp32_multiply_stacked(_t(a), _t(b), maps).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_b4_rejects_bad_maps():
    with pytest.raises(ValueError):
        ops.fp32_multiply_stacked(torch.zeros(4), torch.zeros(4), np.zeros((2, 3, 47)))
    with pytest.raises(ValueError):
        ops.fp32_multiply_stacked(torch.zeros(4), torch.zeros(4),
                                  np.full((1, 3, 48), 5))


# --- B2: bit-exact conv -------------------------------------------------------


def _conv_inputs(seed, b=1, h=6, w=5, cin=3, f=3):
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((f, 3, 3, cin)).astype(np.float32)
    slot = rng.integers(0, 9, (f, 3, 3)).astype(np.int32)
    return x, wt, slot


def test_b2_per_tap_products_bitwise_vs_jax():
    x, w, slot = _conv_inputs(1)
    ho, wo = x.shape[1] - 2, x.shape[2] - 2
    masks = fp32_mul.stack_masks("cpu")
    jmul = jax.jit(jfp.fp32_multiply_interleaved)
    for ky in range(3):
        for kx in range(3):
            patch = x[:, ky:ky + ho, kx:kx + wo, :]
            want = jmul(jnp.asarray(patch)[..., None, :], jnp.asarray(w[:, ky, kx, :]),
                        jnp.asarray(slot[:, ky, kx])[:, None])
            got = fp32_mul.fp32_multiply_masks(
                _t(patch)[..., None, :], _t(w[:, ky, kx, :]),
                masks[_t(slot[:, ky, kx]).long()][:, None])
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_b2_plain_vs_jax_ref_within_sum_bound():
    x, w, slot = _conv_inputs(2, cin=5)
    want = np.asarray(jax.jit(jref.am_conv2d_bitexact_ref)(jnp.asarray(x), jnp.asarray(w),
                                                         slot))
    got = ops.am_conv2d_bitexact(_t(x), _t(w), slot).numpy()
    abs_sum = np.asarray(jref.conv2d_exact_ref(jnp.abs(jnp.asarray(x)),
                                               jnp.abs(jnp.asarray(w))))
    _assert_within_sum_bound(got, want, abs_sum, n_adds=9 * 5)


def test_b2_plain_vs_jax_pallas_interpret():
    """The Pallas kernel itself, in interpret mode as the JAX tests run it."""
    x, w, slot = _conv_inputs(3, b=1, h=5, w=5, cin=2, f=3)
    want = np.asarray(jops.am_conv2d_bitexact(jnp.asarray(x), jnp.asarray(w), slot,
                                              impl="kernel"))
    got = ops.am_conv2d_bitexact(_t(x), _t(w), slot).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))  # Cin = 2: one add per tap


@pytest.mark.parametrize("variant", list(jschemes.SEED_VARIANTS) + ["mixed"])
def test_b2_conv_golden_fixture(golden, variant):
    """Cin = 2 leaves one add per tap, so the fixture's order is the port's."""
    f = golden["w_cv"].shape[0]
    slot = (golden["mixed_cv_vids"] if variant == "mixed"
            else np.full((f, 3, 3), schemes.VARIANT_IDS[variant], np.int32))
    got = ops.am_conv2d_bitexact(_t(golden["x_cv"]), _t(golden["w_cv"]), slot)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(golden[f"{variant}__conv2d"]))


# --- B3: bit-exact matmul -----------------------------------------------------


@pytest.mark.parametrize("variant", list(jschemes.SEED_VARIANTS) + ["mixed"])
def test_b3_matmul_golden_fixture_4_lane_order(golden, variant):
    """Products from the port, summed in the fixture's 4-lane order
    ((p0+p4)+p2) + ((p1+p5)+p3) (ROADMAP C1), equal the fixture bitwise."""
    x, w = golden["x_mm"], golden["w_mm"]
    k, n = w.shape
    vids = (golden["mixed_mm_vids"] if variant == "mixed"
            else np.full((k, n), schemes.VARIANT_IDS[variant], np.int32))
    p = fp32_mul.fp32_multiply_interleaved(
        _t(x)[:, :, None], _t(w)[None], _t(vids)[None]).numpy()  # (M, K, N)
    p0, p1, p2, p3, p4, p5 = (p[:, i] for i in range(6))
    got = ((p0 + p4) + p2) + ((p1 + p5) + p3)
    np.testing.assert_array_equal(_bits(got), _bits(golden[f"{variant}__matmul"]))


def test_b3_plain_vs_jax_ref_within_sum_bound():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 6)).astype(np.float32)
    vids = rng.integers(0, 9, (24, 6)).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, b: jref.am_matmul_bitexact_ref(
        a, b, vids, chunk_k=16))(jnp.asarray(x), jnp.asarray(w)))
    got = ops.am_matmul_bitexact(_t(x), _t(w), vids).numpy()  # chunk_k = 16
    _assert_within_sum_bound(got, want, np.abs(x) @ np.abs(w), n_adds=24)
    whole = ref.am_matmul_bitexact_ref(_t(x), _t(w), vids).numpy()  # one k block
    _assert_within_sum_bound(whole, want, np.abs(x) @ np.abs(w), n_adds=24)


def test_b3_plain_vs_jax_pallas_interpret():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    vids = rng.integers(0, 9, (32, 16)).astype(np.int32)
    want = np.asarray(jops.am_matmul_bitexact(jnp.asarray(x), jnp.asarray(w), vids,
                                              block=(8, 16, 16), impl="kernel"))
    got = ops.am_matmul_bitexact(_t(x), _t(w), vids, chunk_k=16).numpy()
    _assert_within_sum_bound(got, want, np.abs(x) @ np.abs(w), n_adds=32)


def test_b3_pinned_order_is_sequential_blocks():
    """The pinned order written out by hand: blocks of chunk_k, each summed
    from 0.0 in k order, added to an accumulator that starts at 0.0."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 37)).astype(np.float32)
    w = rng.standard_normal((37, 4)).astype(np.float32)
    vids = rng.integers(0, 9, (37, 4)).astype(np.int32)
    p = fp32_mul.fp32_multiply_interleaved(
        _t(x)[:, :, None], _t(w)[None], _t(vids)[None]).numpy()
    want = np.zeros((3, 4), np.float32)
    for k0 in range(0, 37, 16):
        blk = np.zeros((3, 4), np.float32)
        for kk in range(k0, min(k0 + 16, 37)):
            blk = blk + p[:, kk]
        want = want + blk
    got = ops.am_matmul_bitexact(_t(x), _t(w), vids, chunk_k=16).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --- dispatch: CPU tensors go to the plain version, nothing else does ------


def test_cuda_wrappers_refuse_cpu_tensors():
    masks = fp32_mul.stack_masks("cpu")
    x = torch.zeros(1, 5, 5, 2)
    with pytest.raises(ValueError, match="CUDA"):
        approx_conv.am_conv2d_bitexact_cuda(x, torch.zeros(3, 3, 3, 2),
                                            torch.zeros(3, 3, 3, dtype=torch.int32), masks)
    with pytest.raises(ValueError, match="CUDA"):
        approx_matmul.am_matmul_bitexact_cuda(torch.zeros(2, 3), torch.zeros(3, 4),
                                              torch.zeros(3, 4, dtype=torch.int32), masks, 16)
    with pytest.raises(ValueError, match="CUDA"):
        bitexact_emulator.fp32_multiply_stacked_cuda(torch.zeros(8), torch.zeros(8), masks)
    for k in (approx_conv.KERNEL, approx_matmul.KERNEL, bitexact_emulator.KERNEL):
        assert k.launches == 0


def test_ops_reject_other_devices_and_bad_ids():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no AM kernel"):
        ops.am_matmul_bitexact(x, torch.zeros(3, 4, device="meta"),
                               np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="variant ids"):
        ops.am_matmul_bitexact(torch.zeros(2, 3), torch.zeros(3, 4),
                               np.full((3, 4), 9, np.int32))
    with pytest.raises(ValueError, match="shape"):
        ops.am_conv2d_bitexact(torch.zeros(1, 5, 5, 2), torch.zeros(3, 3, 3, 2),
                               np.zeros((3, 3), np.int32))


def test_build_needs_nvcc_and_hashes_sources(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.nvcc()
    paths = {cuda_build.library_path(s) for s in cuda_build.KERNEL_SOURCES}
    assert len(paths) == len(cuda_build.KERNEL_SOURCES) == 4
    assert all(p.parent == cuda_build.BUILD_DIR for p in paths)
    assert cuda_build.library_path("approx_conv.cu") == cuda_build.library_path(
        "approx_conv.cu")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-G",))
    assert cuda_build.library_path("approx_conv.cu") not in paths
