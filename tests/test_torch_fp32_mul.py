"""Port parity: the bit-level emulation core (compressors, Booth rows, FP32
multiply) against the JAX reference, bitwise; and the CUDA header's host
path (built with g++) against the PyTorch version, bitwise."""
import ctypes
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import booth as jbooth
from repro.core import compressors as jcomp
from repro.core import fp32_mul as jfp
from repro.core import schemes as jschemes
from repro_torch.core import booth, compressors, fp32_mul, schemes

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "artifacts"
          / "golden_bitexact.npz")
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _operands(seed: int, n: int = 6000):
    """Random normals at wide exponents, raw bit patterns (NaN payloads,
    subnormals, infinities) and a grid of special values."""
    rng = np.random.default_rng(seed)
    scale = np.ldexp(np.float32(1), rng.integers(-140, 128, (2, n))).astype(np.float32)
    with np.errstate(over="ignore"):
        wide = rng.standard_normal((2, n)).astype(np.float32) * scale
    raw = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32).view(np.float32)
    spec = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-42, 1.4e-45,
                     1.1754942e-38, 3.4e38, 1.0, -1.5, 1e-20, 1e20, 2.0**-63,
                     2.0**64], np.float32)
    ga, gb = np.meshgrid(spec, spec)
    a = np.concatenate([wide[0], raw[0], ga.ravel()])
    b = np.concatenate([wide[1], raw[1], gb.ravel()])
    return a, b


@pytest.mark.parametrize("variant", jschemes.SEED_VARIANTS)
def test_fp32_multiply_bitwise_vs_jax(variant):
    a, b = _operands(list(jschemes.SEED_VARIANTS).index(variant))
    want = jfp.fp32_multiply(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(jschemes.scheme_map(variant)))
    got = fp32_mul.fp32_multiply(torch.from_numpy(a), torch.from_numpy(b),
                                 schemes.scheme_map(variant))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


SPECIAL_CASES = {
    # name: (a, b) operand pairs that exercise one rule
    "zero": ([0.0, -0.0, 0.0, 5.0], [3.0, 2.0, -0.0, -0.0]),
    "subnormal_in": ([1e-40, -2.5e-39, 1.4e-45, 3e-39], [1e30, 3e20, 2.0**100, -7.0]),
    "ftz_out": ([1e-30, 2.0**-100, -1e-20], [1e-10, 2.0**-30, 1e-19]),
    "overflow": ([1e30, -3e38, 2.0**100], [1e10, 2.0, 2.0**40]),
    "nan": ([np.nan, np.inf, 0.0, -np.nan], [1.0, 0.0, -np.inf, np.nan]),
    "inf": ([np.inf, -np.inf, np.inf], [2.0, 1e-40, -np.inf]),
}


@pytest.mark.parametrize("case", sorted(SPECIAL_CASES))
def test_special_operand_rules_bitwise_vs_jax(case):
    """Each case under all nine maps at once (cases padded to one shape)."""
    a, b = (np.resize(np.asarray(t, np.float32), 8) for t in SPECIAL_CASES[case])
    stack = schemes.scheme_stack()[:, None]  # (9, 1, 3, 48) against (1, 8)
    want = jfp.fp32_multiply(jnp.asarray(a)[None], jnp.asarray(b)[None],
                             jnp.asarray(stack))
    got = fp32_mul.fp32_multiply(torch.from_numpy(a)[None], torch.from_numpy(b)[None],
                                 stack)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), err_msg=case)


@pytest.mark.parametrize("code,cols", [(compressors.NC1, 13), (compressors.NC1, 25),
                                       (compressors.NC2, 13)])
def test_c2_mod_2_48_wrap(code, cols):
    """mantissa_multiply_bits(1, 6) under NC-only maps wraps to 2^48 - 10."""
    codes = np.zeros((3, 48), np.int32)
    codes[:, :cols] = code
    want_bits = np.asarray(jfp.mantissa_multiply_bits(
        jnp.asarray(1, jnp.int32), jnp.asarray(6, jnp.int32), jnp.asarray(codes)))
    want = int(sum(int(v) << j for j, v in enumerate(want_bits)))
    got = int(fp32_mul.mantissa_multiply(torch.tensor(1), torch.tensor(6),
                                         fp32_mul.code_masks(codes)))
    assert got == want == 2**48 - 10


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("variant", jschemes.SEED_VARIANTS)
def test_elementwise_golden_fixture(golden, variant):
    vid = schemes.VARIANT_IDS[variant]
    a, b = golden["a_el"], golden["b_el"]
    got = fp32_mul.fp32_multiply_interleaved(torch.from_numpy(a), torch.from_numpy(b),
                                             torch.full(a.shape, vid))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(golden[f"{variant}__elementwise"]))


def test_interleaved_per_element_variants_vs_jax():
    a, b = _operands(11, 1000)
    vids = np.random.default_rng(3).integers(0, 9, a.size).astype(np.int32)
    want = jfp.fp32_multiply_interleaved(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vids))
    got = fp32_mul.fp32_multiply_interleaved(torch.from_numpy(a), torch.from_numpy(b),
                                             torch.from_numpy(vids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fp32_multiply_batch_vs_jax():
    a, b = _operands(5, 2000)
    for variant in ("nm_csi", schemes.scheme_map("pm_si")):
        want = jfp.fp32_multiply_batch(a, b, variant, chunk=1000)
        got = fp32_mul.fp32_multiply_batch(a, b, variant, chunk=1000)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_booth_rows_equal_jax_ppm():
    rng = np.random.default_rng(7)
    a24 = np.concatenate([rng.integers(0, 2**24, 3000), [0, 1, 2**24 - 1, 2**23]])
    b24 = np.concatenate([rng.integers(0, 2**24, 3000), [2**24 - 1, 0, 2**24 - 1, 7]])
    want = np.asarray(jbooth.booth_ppm(jnp.asarray(a24, jnp.int32),
                                       jnp.asarray(b24, jnp.int32)))
    rows = booth.booth_rows(torch.from_numpy(a24), torch.from_numpy(b24))
    bits = (rows.unsqueeze(-1) >> torch.arange(48)) & 1  # words -> columns
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(
        booth.booth_digits(torch.from_numpy(b24)).numpy(),
        np.asarray(jbooth.booth_digits(jnp.asarray(b24, jnp.int32))))


@pytest.mark.parametrize("code", range(compressors.N_COMPRESSORS))
def test_compress42_truth_table_vs_jax(code):
    bits = (np.arange(32)[:, None] >> np.arange(5)) & 1  # all 32 inputs
    x = [bits[:, i].astype(np.int32) for i in range(5)]
    want = jcomp.compress42(*map(jnp.asarray, x), jnp.asarray(code))
    masks = [torch.tensor(int(k == code)) for k in range(compressors.N_COMPRESSORS)]
    got = compressors.compress42(*(torch.from_numpy(v).long() for v in x), masks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seed_maps_and_signature_equal_jax():
    np.testing.assert_array_equal(schemes.scheme_stack(), jschemes.scheme_stack())
    assert schemes.VARIANT_IDS == jschemes.VARIANT_IDS
    assert schemes.AM_VARIANTS == jschemes.AM_VARIANTS
    assert schemes.registry_signature() == jschemes.registry_signature()


_HOST_HARNESS = r"""
#include "am_fp32.cuh"
extern "C" void am_mul_host(const float* a, const float* b, const int* vids,
                            const unsigned long long* masks, float* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint64_t m[am::MASKS_PER_VARIANT];
    for (int j = 0; j < am::MASKS_PER_VARIANT; ++j)
      m[j] = masks[vids[i] * am::MASKS_PER_VARIANT + j];
    out[i] = am::mul(a[i], b[i], m);
  }
}
// B4's split: the map-free head once per operand pair, the tail per map.
extern "C" void am_stacked_host(const float* a, const float* b,
                                const unsigned long long* masks, int V, float* out,
                                long n) {
  for (long i = 0; i < n; ++i) {
    const am::Operand oa = am::decode(a[i]), ob = am::decode(b[i]);
    const am::Pair pr = am::pair(oa, ob);
    uint64_t rows[10];
    am::booth_rows(oa.man24, ob.man24, rows);
    const am::TreeHead head = am::tree_head(rows);
    for (int v = 0; v < V; ++v) {
      uint64_t m[am::MASKS_PER_VARIANT];
      for (int j = 0; j < am::MASKS_PER_VARIANT; ++j)
        m[j] = masks[v * am::MASKS_PER_VARIANT + j];
      out[v * n + i] = am::finish(am::tree_tail(head, m), pr);
    }
  }
}
"""


def test_cuda_header_host_path_bitwise_vs_torch(tmp_path):
    """am_fp32.cuh's arithmetic, built for the host with g++, equals the
    PyTorch version bitwise, both as one multiply (B2, B3) and split into a
    map-free head and a per-map tail (B4): the kernels' bit logic checked
    without a card."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = tmp_path / "harness.cpp"
    src.write_text(_HOST_HARNESS)
    lib_path = tmp_path / "libam_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib_path), str(src)], check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    lib.am_mul_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_long]
    lib.am_mul_host.restype = None
    a, b = _operands(21, 20000)
    vids = np.random.default_rng(4).integers(0, 9, a.size).astype(np.int32)
    masks = fp32_mul.stack_masks("cpu").numpy()
    out = np.zeros_like(a)
    lib.am_mul_host(a.ctypes.data, b.ctypes.data, vids.ctypes.data, masks.ctypes.data,
                    out.ctypes.data, a.size)
    want = fp32_mul.fp32_multiply_interleaved(torch.from_numpy(a), torch.from_numpy(b),
                                              torch.from_numpy(vids))
    np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))

    maps = np.concatenate([schemes.scheme_stack(),
                           np.random.default_rng(5).integers(0, 5, (3, 3, 48))])
    stacked_masks = fp32_mul.code_masks(maps)
    lib.am_stacked_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
    lib.am_stacked_host.restype = None
    out = np.zeros((maps.shape[0], a.size), np.float32)
    lib.am_stacked_host(a.ctypes.data, b.ctypes.data, stacked_masks.numpy().ctypes.data,
                        maps.shape[0], out.ctypes.data, a.size)
    want = fp32_mul.fp32_multiply_masks(torch.from_numpy(a)[None], torch.from_numpy(b)[None],
                                        stacked_masks[:, None])
    np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))
