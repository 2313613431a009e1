"""Port parity: the xLSTM language model (xlstm-125m's SMOKE config: 4
layers, d 64, S = 40 so that the mLSTM runs three chunks of 16 with padding)
against the JAX package, with the reference's parameters carried over by
``weights.lm_params_from_jax``.

Tolerances. The random mLSTM divides by a small normalizer, which amplifies
float32 summation-order differences between XLA and PyTorch: float32
logits are held within 5e-4 of their largest magnitude, and losses within
1e-5 relative. In bfloat16 both packages round at slightly different
places, and the reference's own bfloat16 logits lie up to a few units from
its float32 logits. The port's bfloat16 logits are held no farther from the
reference's bfloat16 logits, in RMS and in max, than those lie from the
reference's float32 logits, and the losses agree within 1e-3 relative.

Surrogate numerics are compared with zero noise: ``crn_normal`` returns
zeros in both packages (replaced for the test), so each projection is its
folded mean, summed in the two packages' own orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_125m as jcfgs
from repro.core import amlinear as jam
from repro.core import surrogate as jsur
from repro.data import synthetic as jsyn
from repro.models import transformer as jtr
from repro_torch import weights
from repro_torch.configs import xlstm_125m as cfgs
from repro_torch.core import amlinear, surrogate
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import registry, transformer

POLICY = "rr:8"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str, surrogate_fused: bool):
    jc = dataclasses.replace(jcfgs.SMOKE, dtype=dtype)
    c = dataclasses.replace(cfgs.SMOKE, dtype=dtype)
    if surrogate_fused:
        jc = jc.with_numerics(jam.NumericsConfig.for_backend("surrogate_fused", POLICY))
        c = c.with_numerics(amlinear.NumericsConfig.for_backend("surrogate_fused", POLICY))
    return jc, c


@pytest.fixture(scope="module")
def jax_params():
    return jtr.init_params(jcfgs.SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def batch():
    return jsyn.lm_batch(0, global_batch=2, seq=40, vocab=jcfgs.SMOKE.vocab)


def _zero_noise(monkeypatch):
    monkeypatch.setattr(jsur, "crn_normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(surrogate, "crn_normal",
                        lambda key, shape, device="cuda": torch.zeros(
                            tuple(shape), device=device))


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def _jax_run(jc, jp, batch, key):
    jp = jax.tree.map(lambda a: a.astype(jc.jnp_dtype), jp)
    logits, loss = jax.jit(lambda p, b: (jtr.forward(p, b, jc, key=key),
                                         jtr.loss_fn(p, b, jc, key=key)))(jp, batch)
    return np.asarray(logits, np.float32), float(loss)


def _port_run(c, jp, batch, key):
    params = weights.lm_params_from_jax(jax.tree.map(np.asarray, jp), c, "cpu")
    with torch.no_grad():
        return (transformer.forward(params, batch, c, key=key).float().numpy(),
                float(transformer.loss_fn(params, batch, c, key=key)))


@pytest.mark.parametrize("surrogate_fused", [False, True])
def test_forward_and_loss_float32_vs_jax(monkeypatch, jax_params, batch, surrogate_fused):
    _zero_noise(monkeypatch)
    jc, c = _configs("float32", surrogate_fused)
    want, want_loss = _jax_run(jc, jax_params, batch, jax.random.PRNGKey(1))
    got, loss = _port_run(c, jax_params, batch, 1)
    assert got.shape == want.shape == (2, 40, 256)
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()
    assert loss == pytest.approx(want_loss, rel=1e-5)


@pytest.mark.parametrize("surrogate_fused", [False, True])
def test_forward_and_loss_bfloat16_vs_jax(monkeypatch, jax_params, batch, surrogate_fused):
    _zero_noise(monkeypatch)
    jc, c = _configs("bfloat16", surrogate_fused)
    jc32, _ = _configs("float32", surrogate_fused)
    want, want_loss = _jax_run(jc, jax_params, batch, jax.random.PRNGKey(1))
    want32, _ = _jax_run(jc32, jax_params, batch, jax.random.PRNGKey(1))
    got, loss = _port_run(c, jax_params, batch, 1)
    assert got.shape == want.shape
    assert _rms(got - want) <= _rms(want - want32)
    assert np.abs(got - want).max() <= np.abs(want - want32).max()
    assert loss == pytest.approx(want_loss, rel=1e-3)


def test_surrogate_forward_launches_b5_once_per_projection(monkeypatch, batch):
    """Under surrogate_fused every projection is one B5 call (its plain
    version here): 3 mLSTM x 5 + 1 sLSTM x 5 + the head = 21 for SMOKE; the
    noise is finite and moves the loss."""
    calls = []
    real = ops.am_surrogate_matmul_epilogue

    def counted(x, wm, wv, z):
        calls.append((tuple(x.shape), tuple(wm.shape)))
        return real(x, wm, wv, z)

    monkeypatch.setattr(ops, "am_surrogate_matmul_epilogue", counted)
    _, c = _configs("float32", True)
    params = transformer.init_params(c, seed=0, device="cpu")
    with torch.no_grad():
        noisy = float(transformer.loss_fn(params, batch, c, key=3))
        assert len(calls) == 21
        assert calls[-1] == ((80, 64), (64, 256))
        exact = float(transformer.loss_fn(params, batch, c.with_numerics(amlinear.EXACT)))
    assert len(calls) == 21
    assert np.isfinite(noisy) and noisy != exact


def test_configs_equal_jax():
    for name in ("CONFIG", "SMOKE"):
        got, want = getattr(cfgs, name), getattr(jcfgs, name)
        for f in dataclasses.fields(got):
            if f.name != "numerics":
                assert getattr(got, f.name) == getattr(want, f.name), (name, f.name)
        assert (got.n_rep, got.n_tail) == (want.n_rep, want.n_tail)
    assert registry.get("xlstm-125m").config == cfgs.CONFIG
    assert registry.get("xlstm-125m").smoke == cfgs.SMOKE
    assert registry.forward_fn(cfgs.CONFIG) is transformer.forward
    assert registry.loss_fn(cfgs.CONFIG) is transformer.loss_fn
    with pytest.raises(ValueError, match="not ported"):
        registry.get("llama3-8b")


def test_param_layout_carries_the_reference_tree(jax_params):
    """init_params' shapes and dtypes are the reference tree's, unstacked:
    layer r * len(pattern) + j is blocks/l{j}[r]."""
    c = cfgs.SMOKE
    ours = registry.init_params(c, seed=0, device="cpu")
    carried = weights.lm_params_from_jax(jax.tree.map(np.asarray, jax_params), c, "cpu")
    assert len(ours["layers"]) == len(carried["layers"]) == c.n_layers
    for name in ("embed", "head", "norm_f"):
        assert ours[name].shape == carried[name].shape == jax_params[name].shape
        assert ours[name].dtype == carried[name].dtype == torch.bfloat16
    per = len(c.pattern)
    for i, layer in enumerate(carried["layers"]):
        r, j = divmod(i, per)
        ref = jax_params["blocks"][f"l{j}"]
        assert set(layer["mixer"]) == set(ref["mixer"]) == set(ours["layers"][i]["mixer"])
        for k, v in layer["mixer"].items():
            assert v.shape == ours["layers"][i]["mixer"][k].shape == ref["mixer"][k].shape[1:]
            np.testing.assert_array_equal(v.float().numpy(),
                                          np.asarray(ref["mixer"][k][r], np.float32))


def test_init_params_is_seeded_and_module_matches_functions(batch):
    c = cfgs.SMOKE
    a = transformer.init_params(c, seed=5, device="cpu")
    b = transformer.init_params(c, seed=5, device="cpu")
    assert torch.equal(a["head"], b["head"])
    assert not torch.equal(a["head"], transformer.init_params(c, seed=6, device="cpu")["head"])
    model = transformer.DecoderLM(c, a)
    with torch.no_grad():
        np.testing.assert_array_equal(model(batch).float().numpy(),
                                      transformer.forward(a, batch, c).float().numpy())
        assert float(model.loss(batch)) == float(transformer.loss_fn(a, batch, c))
    assert not any(p.requires_grad for p in model.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            transformer.init_params(c)  # device defaults to "cuda"


def test_synthetic_batches_equal_jax():
    for step in (0, 3):
        got = synthetic.batch_for(cfgs.SMOKE, step, global_batch=3, seq=17, seed=2)
        want = jsyn.batch_for(jcfgs.SMOKE, step, global_batch=3, seq=17, seed=2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])

