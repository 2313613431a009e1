"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the kernels have no CPU mode. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, fp32_mul, schemes
from repro_torch.data import cifar_like
from repro_torch.experiments import paper_cnn
from repro_torch.kernels import approx_conv, approx_matmul, bitexact_emulator, ops, ref
from repro_torch.models import cnn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def test_b2_bitwise_vs_plain_ragged_shapes(dev):
    rng = np.random.default_rng(0)
    masks = ops.seed_masks(dev)
    x = _t(rng.random((3, 13, 11, 5)).astype(np.float32), dev)
    w = _t(rng.standard_normal((6, 3, 3, 5)).astype(np.float32), dev)
    slot = _t(rng.integers(0, 9, (6, 3, 3)).astype(np.int32), dev)
    n0 = approx_conv.KERNEL.launches
    got = approx_conv.am_conv2d_bitexact_cuda(x, w, slot, masks)
    assert approx_conv.KERNEL.launches == n0 + 1
    np.testing.assert_array_equal(_bits(got), _bits(ref.am_conv2d_bitexact_ref(x, w, slot,
                                                                               masks)))


def test_b3_bitwise_vs_plain_ragged_shapes(dev):
    rng = np.random.default_rng(1)
    masks = ops.seed_masks(dev)
    x = _t(rng.standard_normal((37, 45)).astype(np.float32), dev)
    w = _t(rng.standard_normal((45, 29)).astype(np.float32), dev)
    vids = _t(rng.integers(0, 9, (45, 29)).astype(np.int32), dev)
    for chunk_k in (1, 16, 45):
        got = approx_matmul.am_matmul_bitexact_cuda(x, w, vids, masks, chunk_k)
        want = ref.am_matmul_bitexact_ref(x, w, vids, chunk_k=chunk_k, masks=masks)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_b4_bitwise_vs_plain_with_specials(dev):
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 2**32, (2, 5000), dtype=np.uint64).astype(np.uint32)
    a, b = (_t(r.view(np.float32), dev) for r in raw)
    maps = np.concatenate([schemes.scheme_stack(),
                           rng.integers(0, 5, (4, 3, 48)).astype(np.int32)])
    masks = fp32_mul.code_masks(maps).to(dev)
    got = bitexact_emulator.fp32_multiply_stacked_cuda(a, b, masks)
    np.testing.assert_array_equal(_bits(got), _bits(ref.fp32_multiply_stacked_ref(a, b,
                                                                                  masks)))


def test_engine_and_cnn_on_card_equal_cpu(dev):
    """bitexact_cuda on the card and its plain version on the CPU give the
    same bits through the engine and the CNN's conv features."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    w = rng.standard_normal((40, 7)).astype(np.float32)
    vids = rng.integers(0, 9, (40, 7))
    card = engine.am_matmul(_t(x, dev), _t(w, dev), vids, backend="bitexact_cuda")
    cpu = engine.am_matmul(torch.from_numpy(x), torch.from_numpy(w), vids,
                           backend="bitexact_cuda")
    np.testing.assert_array_equal(_bits(card), _bits(cpu))
    params = paper_cnn.load_params(dev)
    model = cnn.PaperCNN(params)
    cfg = cnn.AMConfig.from_sequence(rng.integers(0, 9, cnn.N_SLOTS), "bitexact_cuda")
    xs, _ = cifar_like.make_batch("test", 0, 3)
    with torch.no_grad():
        f_card = model.features(_t(xs, dev), cfg)
        f_cpu = cnn.PaperCNN({k: v.cpu() for k, v in params.items()}).features(
            torch.from_numpy(xs), cfg)
    np.testing.assert_array_equal(_bits(f_card), _bits(f_cpu))
