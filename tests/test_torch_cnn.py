"""Port parity: the paper CNN (exact and bit-exact numerics) against the JAX
reference, at full width on the committed trained parameters.

Tolerance: logits within 1e-5 of their largest magnitude (plus 1e-6),
argmax equal. Both packages sum the same float32 values (exact products,
or bitwise-equal emulated products) in different orders: XLA's conv and
``jnp.sum`` orders against PyTorch's and the port's pinned sequential ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import cifar_like as jdata
from repro.experiments import paper_cnn as jpaper
from repro.models import cnn as jcnn
from repro_torch import weights
from repro_torch.data import cifar_like
from repro_torch.models import cnn


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jpaper.load_params()


@pytest.fixture(scope="module")
def model(jparams):
    return cnn.PaperCNN(weights.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu"))


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.max(np.abs(want)) + 1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_procedural_data_equals_jax():
    for split, start, n in (("test", 0, 8), ("train", 100, 5)):
        x, y = cifar_like.make_batch(split, start, n)
        jx, jy = jdata.make_batch(split, start, n)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_exact_cnn_logits_vs_jax(jparams, model):
    x, _ = cifar_like.make_batch("test", 0, 16)
    want = jcnn.apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (16, 10)
    _close_logits(got.numpy(), want)


def test_bitexact_cnn_whole_slice_vs_jax(jparams, model):
    """Both convs bit-exact under a random 198-slot interleave, 2 images at
    full width (10 and 12 filters, 32x32x3), against JAX bitexact_ref."""
    x, _ = cifar_like.make_batch("test", 0, 2)
    seq = np.random.default_rng(0).integers(0, 9, cnn.N_SLOTS).astype(np.int32)
    jcfg = jcnn.AMConfig.from_sequence(seq, backend="bitexact_ref")
    want = jax.jit(lambda xx: jcnn.apply(jparams, xx, jcfg))(jnp.asarray(x))
    for backend in ("bitexact_ref", "bitexact_cuda"):  # the CUDA backend's plain version
        with torch.no_grad():
            got = model(torch.from_numpy(x), cnn.AMConfig.from_sequence(seq, backend))
        _close_logits(got.numpy(), want)


def test_maxpool_and_slot_maps_equal_jax():
    x = np.random.default_rng(1).standard_normal((2, 13, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(cnn.maxpool2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcnn._maxpool2(jnp.asarray(x))))
    seq = np.arange(cnn.N_SLOTS) % 9
    for got, want in zip(cnn.slot_maps_from_sequence(seq),
                         jcnn.slot_maps_from_sequence(seq)):
        np.testing.assert_array_equal(got, want)
    cfg = cnn.AMConfig.from_sequence(seq)
    assert cfg.backend == "surrogate_torch" and cfg.needs_key and not cfg.is_exact


def test_accuracy_exact_vs_jax_and_surrogate_needs_key(jparams, model):
    x, y = cifar_like.make_batch("test", 0, 64)
    want = jcnn.accuracy(jparams, x, y)
    got = cnn.accuracy(model, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(got - want) <= 1 / 64
    cfg = cnn.AMConfig.from_sequence(np.full(cnn.N_SLOTS, 4))
    with pytest.raises(ValueError, match="key"):
        model(torch.from_numpy(x[:2]), cfg)
    acc = cnn.accuracy(model, torch.from_numpy(x), torch.from_numpy(y), cfg, key=3)
    assert abs(acc - got) <= 4 / 64  # calibrated noise barely moves accuracy
