"""Port parity: the engine's surrogate_fused matmul (folded weights, B5 and
B6 through their plain versions here) and the AM-aware linear layers
(``core/amlinear.py``) against the JAX package.

The fold is elementwise float32 in both packages and is held bitwise. The
matmuls are held within the float32 summation bound of
``test_torch_surrogate_matmul.py`` (the two packages sum in different
orders, ROADMAP C3); the reference's noise z is handed to the port by
replacing its ``surrogate.crn_normal``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amlinear as jam
from repro.core import engine as jengine
from repro.core import surrogate as jsur
from repro_torch.core import amlinear, engine, surrogate

EPS = float(np.finfo(np.float32).eps)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _bound(x, w):
    k = x.shape[-1]
    return 2 * k * EPS * np.matmul(np.abs(np.float64(x)), np.abs(np.float64(w)))


def _reference_z(monkeypatch, shape):
    """The reference engine's z for KEY and an (M, N) output, handed to the
    port's crn_normal."""
    z = np.asarray(jsur.crn_normal(KEY, shape, jnp.float32))
    monkeypatch.setattr(surrogate, "crn_normal",
                        lambda key, shape_, device="cuda": _t(z).to(device))
    return z


@pytest.mark.parametrize("noise_scale", [1.0, 4.0])
@pytest.mark.parametrize("slot", ["uniform:nm_si", "rr:8", "grid", "full", "pop"])
def test_fold_matmul_weights_bitwise_vs_jax(slot, noise_scale):
    k, n, tk, tn = 70, 50, 32, 16
    rng = np.random.default_rng(0)
    gk, gn = -(-k // tk), -(-n // tn)
    smap = {"grid": rng.integers(0, 9, (gk, gn)), "full": rng.integers(0, 9, (k, n)),
            "pop": rng.integers(0, 9, (3, gk, gn))}.get(slot, slot)
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = engine.fold_matmul_weights(
        _t(w), engine.canonical_matmul_map(smap, k, n, tile_k=tk, tile_n=tn),
        noise_scale=noise_scale)
    want = jengine.fold_matmul_weights(
        w, jengine.canonical_matmul_map(smap, k, n, tile_k=tk, tile_n=tn),
        noise_scale=noise_scale)
    for g, wt in zip(got, want):
        assert g.shape == wt.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wt))


def test_policy_maps_are_expanded_once_and_cached():
    a = engine.canonical_matmul_map("rr:3", 300, 200)
    assert engine.canonical_matmul_map("rr:3", 300, 200) is a
    assert not a.vids.flags.writeable and a.policy == ("rr:3", 128, 128)
    mu, sg = engine.device_moment_maps(a, 2.0, "cpu")
    assert engine.device_moment_maps(a, 2.0, "cpu")[0] is mu
    want = engine.moment_maps(a.vids, 2.0, "cpu")
    np.testing.assert_array_equal(_bits(mu.numpy()), _bits(want[0]))
    np.testing.assert_array_equal(_bits(sg.numpy()), _bits(want[1]))


def _am_matmul_both(monkeypatch, x, w, smap, **kw):
    z = _reference_z(monkeypatch, (x.shape[-2], w.shape[1]))
    want = jengine.am_matmul(jnp.asarray(x), jnp.asarray(w), smap,
                             backend="surrogate_fused", key=KEY, **kw)
    got = engine.am_matmul(_t(x), _t(w), smap, backend="surrogate_fused", key=7, **kw)
    return got, want, z


@pytest.mark.parametrize("case", ["single", "pop", "pop_x"])
def test_engine_fused_matmul_vs_jax_with_reference_noise(monkeypatch, case):
    rng = np.random.default_rng(1)
    k, n = 40, 24
    w = rng.standard_normal((k, n)).astype(np.float32)
    smap = rng.integers(0, 9, (3, 3, 3)) if case != "single" else "rr:8"
    x = rng.standard_normal((3, 10, k) if case == "pop_x" else (10, k)).astype(np.float32)
    got, want, z = _am_matmul_both(monkeypatch, x, w, smap, tile_k=16, tile_n=8)
    cmap = jengine.canonical_matmul_map(smap, k, n, tile_k=16, tile_n=8)
    wm, wv = jengine.fold_matmul_weights(w, cmap)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    tol = _bound(x, wm) + np.abs(z) * np.sqrt(_bound(x * x, wv)) + EPS * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("case", ["single", "pop", "pop_x"])
def test_engine_fused_matmul_moments_vs_jax(case):
    rng = np.random.default_rng(2)
    k, n = 36, 20
    w = rng.standard_normal((k, n)).astype(np.float32)
    smap = rng.integers(0, 9, (2, k, n)) if case != "single" else rng.integers(0, 9, (k, n))
    x = rng.standard_normal((2, 2, 5, k) if case == "pop_x" else (2, 5, k))
    x = x.astype(np.float32)
    xp = x.reshape(2, 10, k) if case == "pop_x" else x
    want = jengine.am_matmul(jnp.asarray(xp), jnp.asarray(w), smap,
                             backend="surrogate_fused", key=KEY, return_moments=True)
    got = engine.am_matmul(_t(xp), _t(w), smap, backend="surrogate_fused", key=7,
                           return_moments=True)
    wm, wv = jengine.fold_matmul_weights(w, jengine.canonical_matmul_map(smap, k, n))
    xf = xp.reshape(-1, 10, k) if case == "pop_x" else xp.reshape(10, k)
    for g, wt, xx, ww in zip(got, want, (xf, xf * xf), (wm, wv)):
        g, wt = g.numpy(), np.asarray(wt)
        assert g.shape == wt.shape
        assert np.all(np.abs(g.reshape(-1, 10, n) - wt.reshape(-1, 10, n))
                      <= _bound(xx, ww).reshape(-1, 10, n))


def test_engine_fused_matmul_needs_a_key_and_matches_surrogate_torch():
    rng = np.random.default_rng(3)
    x, w = _t(rng.standard_normal((6, 30))), _t(rng.standard_normal((30, 9)))
    vids = rng.integers(0, 9, (4, 30, 9))
    with pytest.raises(ValueError, match="key"):
        engine.am_matmul(x, w, vids, backend="surrogate_fused")
    fused = engine.am_matmul(x, w, vids, backend="surrogate_fused", key=5)
    torch_ = engine.am_matmul(x, w, vids, backend="surrogate_torch", key=5)
    assert fused.shape == (4, 6, 9)
    np.testing.assert_allclose(fused.numpy(), torch_.numpy(), rtol=0,
                               atol=1e-5 * float(torch_.abs().max()))


# Every am_einsum spec of xlstm-125m with its (x, w) shapes.
XLSTM_SPECS = {
    "bsd,dhk->bshk": ((2, 5, 768), (768, 4, 192)),
    "bshk,hkd->bsd": ((2, 5, 4, 192), (4, 192, 768)),
    "bsd,de->bse": ((2, 5, 768), (768, 768)),
    "bsd,dv->bsv": ((2, 5, 768), (768, 50304)),
}


@pytest.mark.parametrize("spec", sorted(XLSTM_SPECS))
def test_dense_form_and_canonical_maps_of_xlstm_specs_equal_jax(spec):
    xs, ws = XLSTM_SPECS[spec]
    form = amlinear._dense_form(spec, len(xs), len(ws))
    assert form is not None and form == jam._dense_form(spec, len(xs), len(ws))
    k, n = int(np.prod(ws[:form[0]])), int(np.prod(ws[form[0]:]))
    for policy in ("uniform:pm_csi", "rr:8"):
        got = engine.canonical_matmul_map(policy, k, n)
        want = jengine.canonical_matmul_map(policy, k, n)
        np.testing.assert_array_equal(got.vids, want.vids)


@pytest.mark.parametrize("spec", ["bsd,hd->bsh", "bhd,hde->bhe", "bsd,dd->bsd",
                                  "ab,bc->ca", "abc,bc->a"])
def test_dense_form_rejects_like_jax(spec):
    xs, ws = spec.split("->")[0].split(",")
    assert amlinear._dense_form(spec, len(xs), len(ws)) == jam._dense_form(
        spec, len(xs), len(ws))


@pytest.mark.parametrize("backend", ["exact", "surrogate_fused"])
def test_am_einsum_projection_vs_jax(monkeypatch, backend):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 2, 20)) / 7).astype(np.float32)
    jcfg = jam.NumericsConfig.for_backend(backend, "rr:8", tile_k=16, tile_n=16)
    cfg = amlinear.NumericsConfig.for_backend(backend, "rr:8", tile_k=16, tile_n=16)
    assert (cfg.mode, cfg.engine_backend) == (jcfg.mode, jcfg.engine_backend)
    z = _reference_z(monkeypatch, (10, 40))
    want = np.asarray(jam.am_einsum("bsd,dhk->bshk", jnp.asarray(x), jnp.asarray(w),
                                    cfg=jcfg, key=KEY))
    got = amlinear.am_einsum("bsd,dhk->bshk", _t(x), _t(w), cfg=cfg, key=7).numpy()
    assert got.shape == want.shape == (2, 5, 2, 20)
    x2, w2 = x.reshape(10, 48), w.reshape(48, 40)
    if backend == "exact":
        bound = _bound(x2, w2)
    else:
        wm, wv = jengine.fold_matmul_weights(w2, jengine.canonical_matmul_map(
            "rr:8", 48, 40, tile_k=16, tile_n=16))
        bound = _bound(x2, wm) + np.abs(z) * np.sqrt(_bound(x2 * x2, wv))
    want2 = want.reshape(10, 40)
    assert np.all(np.abs(got.reshape(10, 40) - want2) <= bound + EPS * np.abs(want2))


def test_am_einsum_non_dense_spec_falls_back_like_jax(monkeypatch):
    """A batched-weight spec takes the surrogate moment-einsum fallback."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 6, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 12)).astype(np.float32)
    spec = "ebd,edf->ebf"
    jcfg = jam.NumericsConfig(mode="surrogate", policy="rr:2", tile_k=8, tile_n=8)
    cfg = amlinear.NumericsConfig(mode="surrogate", policy="rr:2", tile_k=8, tile_n=8)
    z = np.asarray(jax.random.normal(KEY, (3, 6, 12), jnp.float32))
    monkeypatch.setattr(surrogate, "crn_normal", lambda key, shape, device="cuda": _t(z))
    want = np.asarray(jam.am_einsum(spec, jnp.asarray(x), jnp.asarray(w), cfg=jcfg,
                                    key=KEY))
    got = amlinear.am_einsum(spec, _t(x), _t(w), cfg=cfg, key=7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="key"):
        amlinear.am_einsum(spec, _t(x), _t(w), cfg=cfg)


def test_am_dense_keeps_dtype_and_config_validates():
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((4, 32))).to(torch.bfloat16)
    w = _t(rng.standard_normal((32, 8))).to(torch.bfloat16)
    cfg = amlinear.NumericsConfig.for_backend("surrogate_fused")
    assert cfg.mode == "surrogate" and cfg.policy == "uniform:pm_csi"
    assert amlinear.am_dense(x, w, cfg=cfg, key=1).dtype == torch.bfloat16
    assert amlinear.am_dense(x, w).dtype == torch.bfloat16
    assert amlinear.NumericsConfig.for_backend("bitexact_cuda").mode == "bitexact"
    assert amlinear.NumericsConfig(mode="surrogate").engine_backend == "surrogate_torch"
    with pytest.raises(ValueError, match="mode"):
        amlinear.NumericsConfig(mode="fast")
    with pytest.raises(ValueError, match="backend"):
        amlinear.NumericsConfig(backend="surrogate_xla")
