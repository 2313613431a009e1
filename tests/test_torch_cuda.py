"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the kernels have no CPU mode. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import xlstm_125m
from repro_torch.core import amlinear, engine, fp32_mul, schemes, surrogate
from repro_torch.data import cifar_like, synthetic
from repro_torch.experiments import paper_cnn
from repro_torch.kernels import (am_surrogate_matmul, approx_conv, approx_matmul,
                                 bitexact_emulator, ops, ref)
from repro_torch.models import cnn, transformer

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


@pytest.mark.parametrize("p, pop_x", [(0, False), (3, False), (3, True)])
@pytest.mark.parametrize("mkn", [(37, 45, 29), (130, 70, 4), (64, 16, 200)])
def test_b5_b6_b7_bitwise_vs_plain_ragged_shapes(dev, p, pop_x, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n + p)
    x = _t(rng.standard_normal((p, m, k) if pop_x else (m, k)).astype(np.float32), dev)
    wshape = (p, k, n) if p else (k, n)
    wm = _t(rng.standard_normal(wshape).astype(np.float32), dev)
    wv = _t(rng.standard_normal(wshape).astype(np.float32), dev)  # some var < 0
    z = _t(rng.standard_normal((m, n)).astype(np.float32), dev)
    n0 = am_surrogate_matmul.EPILOGUE.launches
    got = am_surrogate_matmul.am_surrogate_matmul_epilogue_cuda(x, wm, wv, z)
    assert am_surrogate_matmul.EPILOGUE.launches == n0 + 1
    np.testing.assert_array_equal(_bits(got), _bits(ref.am_surrogate_epilogue_ref(
        x, wm, wv, z)))
    if p:
        return
    for g, w in zip(am_surrogate_matmul.am_surrogate_moments_folded_cuda(x, wm, wv),
                    ref.am_surrogate_moments_ref(x, wm, wv)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    mu = wv * 1e-3
    for g, w in zip(am_surrogate_matmul.am_surrogate_moments_cuda(x, wm, mu, wv),
                    ref.am_surrogate_unfolded_ref(x, wm, mu, wv)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_surrogate_fused_engine_on_card_equals_cpu(dev, monkeypatch):
    """The fold on the device and B5/B6 on the card give the CPU plain
    path's bits, given the same z."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 50, 300)).astype(np.float32)
    w = rng.standard_normal((300, 130)).astype(np.float32)
    z = torch.from_numpy(rng.standard_normal((150, 130)).astype(np.float32))
    monkeypatch.setattr(surrogate, "crn_normal", lambda key, shape, device="cuda":
                        z.to(device))
    for kw in ({"key": 1}, {"key": 1, "return_moments": True}):
        card = engine.am_matmul(_t(x, dev), _t(w, dev), "rr:8", backend="surrogate_fused",
                                **kw)
        cpu = engine.am_matmul(torch.from_numpy(x), torch.from_numpy(w), "rr:8",
                               backend="surrogate_fused", **kw)
        for c, h in zip(card if isinstance(card, tuple) else (card,),
                        cpu if isinstance(cpu, tuple) else (cpu,)):
            np.testing.assert_array_equal(_bits(c), _bits(h))


def test_xlstm_smoke_surrogate_forward_on_card(dev):
    """Every projection of the SMOKE LM is one B5 launch on the card (21);
    the surrogate loss is finite and near the exact one."""
    cfg = xlstm_125m.SMOKE.with_numerics(
        amlinear.NumericsConfig.for_backend("surrogate_fused", "rr:8"))
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch = synthetic.batch_for(cfg, 0, global_batch=2, seq=40)
    with torch.no_grad():
        exact = float(transformer.loss_fn(params, batch, cfg.with_numerics(amlinear.EXACT)))
        n0 = am_surrogate_matmul.EPILOGUE.launches
        loss = float(transformer.loss_fn(params, batch, cfg, key=3))
    assert am_surrogate_matmul.EPILOGUE.launches == n0 + 21
    assert np.isfinite(loss) and abs(loss - exact) <= 0.01 * exact
