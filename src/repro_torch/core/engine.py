"""AM numerics engine: one backend-dispatched matmul / conv2d API.

    am_matmul(x, w, slot_map, *, backend=..., key=...)
    am_conv2d(x, w, slot_map, *, backend=..., key=...)

``slot_map`` is anything the canonicalizer understands (None, a policy
string ``uniform:<variant>`` or ``rr:<k>``, a flat variant sequence, a tile
grid, a full per-slot map), each optionally with a leading population axis
(P, ...) of genomes; outputs then gain a leading P axis. ``backend`` picks
the fidelity:

  backend           fidelity                 runs as
  ----------------  -----------------------  ---------------------------------
  exact             reference f32            torch matmul / conv (TF32 off)
  bitexact_ref      bit-level AM emulation   plain PyTorch (kernels/ref.py)
  bitexact_cuda     bit-level AM emulation   CUDA kernels B2/B3 on the card,
                                             their plain versions on the CPU
  surrogate_torch   calibrated moments       per-genome torch matmul / conv
  surrogate_fused   calibrated moments       conv: population im2col GEMMs;
                                             matmul: folded weights and one
                                             launch of B5 (B6 for moments)

``backend=None`` picks exact without a (non-trivial) map, bit-exact for
small work (``bitexact_cuda`` for CUDA tensors), the fused surrogate
otherwise.

Surrogate noise uses common random numbers: z is a function of the call's
integer ``key`` and the single-genome output shape only, shared across the
population, so genomes are compared under one noise realization.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import interleave, surrogate
from repro_torch.kernels import ops, ref

# Auto-selector threshold: emulated multiplies per bit-exact call.
BITEXACT_AUTO_MAX_MULS = 1 << 14


# ---------------------------------------------------------------------------
# Slot-map canonicalization (shared by every backend)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _policy_sequence(policy: str, n: int) -> np.ndarray:
    """Deterministic flat variant-id sequence of length n for a policy."""
    if policy.startswith("uniform:"):
        seq = interleave.uniform_sequence(policy.split(":", 1)[1], n)
    elif policy.startswith("rr:"):
        k = int(policy.split(":", 1)[1])
        alpha = np.asarray(interleave.alphabet_for_k(k), np.int32)
        seq = alpha[np.arange(n) % k]
    else:
        raise ValueError(f"unknown numerics policy {policy!r}")
    seq.setflags(write=False)
    return seq


@dataclasses.dataclass(frozen=True)
class CanonicalMap:
    """Per-slot variant ids: (K, N) for matmul, (F, kh, kw) for conv, with a
    leading P axis when ``pop`` is set. Always a host int32 array."""

    vids: np.ndarray
    pop: bool
    # (policy, tile_k, tile_n) when vids expand a policy's tile grid: the
    # device moment maps of such a map are built once and cached.
    policy: tuple | None = None

    @property
    def population(self) -> int:
        return self.vids.shape[0] if self.pop else 1

    def per_genome(self):
        """Iterate single-genome maps (pop=False each)."""
        if not self.pop:
            yield self
        else:
            for p in range(self.vids.shape[0]):
                yield CanonicalMap(self.vids[p], False)


def canonical_matmul_map(slot_map, k: int, n: int, *, tile_k: int = 128,
                         tile_n: int = 128) -> CanonicalMap:
    """Canonicalize a matmul slot map to per-(K, N) variant ids.

    Accepted: None (exact), a policy string, a full (K, N) map, a (gk, gn)
    tile grid, a flat gk*gn sequence, each with an optional leading
    population axis (use an explicit 3-D (P, gk, gn) where a 2-D population
    would collide with those shapes).
    """
    gk, gn = -(-k // tile_k), -(-n // tile_n)
    if slot_map is None:
        return CanonicalMap(np.zeros((k, n), np.int32), False)
    if isinstance(slot_map, str):
        return _policy_matmul_map(slot_map, k, n, tile_k, tile_n)
    arr = np.asarray(slot_map, np.int32)

    def expand(a: np.ndarray) -> np.ndarray:
        if a.ndim == 1:
            if a.size != gk * gn:
                raise ValueError(
                    f"flat matmul sequence length {a.size} != tile grid {gk}x{gn}")
            a = a.reshape(gk, gn)
        if a.shape == (k, n):
            return a
        if a.shape == (gk, gn):
            return np.repeat(np.repeat(a, tile_k, 0), tile_n, 1)[:k, :n]
        raise ValueError(f"matmul slot map shape {a.shape} matches neither full "
                         f"({k}, {n}) nor tile grid ({gk}, {gn})")

    single = arr.ndim == 1 or (arr.ndim == 2 and arr.shape in ((k, n), (gk, gn)))
    if single:
        return CanonicalMap(expand(arr), False)
    return CanonicalMap(np.stack([expand(a) for a in arr]), True)


@functools.lru_cache(maxsize=256)
def _policy_matmul_map(policy: str, k: int, n: int, tile_k: int,
                       tile_n: int) -> CanonicalMap:
    """A policy's (K, N) map, expanded on the host once per shape (read-only)."""
    gk, gn = -(-k // tile_k), -(-n // tile_n)
    grid = _policy_sequence(policy, gk * gn).reshape(gk, gn)
    vids = np.repeat(np.repeat(grid, tile_k, 0), tile_n, 1)[:k, :n]
    vids.setflags(write=False)
    return CanonicalMap(vids, False, (policy, tile_k, tile_n))


def canonical_conv_map(slot_map, f: int, kh: int, kw: int) -> CanonicalMap:
    """Canonicalize a conv slot map to per-(F, kh, kw) variant ids.

    Accepted: None (exact), a policy string, a (F, kh, kw) map, a flat
    F*kh*kw sequence, each with an optional leading population axis.
    """
    n = f * kh * kw
    if slot_map is None:
        return CanonicalMap(np.zeros((f, kh, kw), np.int32), False)
    if isinstance(slot_map, str):
        slot_map = _policy_sequence(slot_map, n)
    arr = np.asarray(slot_map, np.int32)
    if arr.ndim == 1:
        if arr.size != n:
            raise ValueError(f"flat conv sequence length {arr.size} != {n} slots")
        return CanonicalMap(arr.reshape(f, kh, kw), False)
    if arr.shape == (f, kh, kw):
        return CanonicalMap(arr, False)
    if arr.ndim == 2 and arr.shape[1] == n:
        return CanonicalMap(arr.reshape(-1, f, kh, kw), True)
    if arr.ndim == 4 and arr.shape[1:] == (f, kh, kw):
        return CanonicalMap(arr, True)
    raise ValueError(f"conv slot map shape {arr.shape} does not fit "
                     f"(F,kh,kw)=({f},{kh},{kw})")


def moment_maps(vids: np.ndarray, noise_scale: float = 1.0, device="cuda"):
    """Per-slot (mu, sigma) float32 numpy maps for canonical variant ids,
    from the seed tables calibrated on ``device``."""
    mu_t, sg_t = surrogate.moment_tables(device)
    mu_t = (mu_t * noise_scale).astype(np.float32)
    sg_t = (sg_t * noise_scale).astype(np.float32)
    return mu_t[vids], sg_t[vids]


def _scaled_tables(noise_scale: float, device):
    """The seed (mu, sigma) tables times noise_scale, in numpy float32 as
    ``moment_maps`` scales them, on ``device``."""
    mu_t, sg_t = surrogate.moment_tables(device)
    return (torch.from_numpy((t * noise_scale).astype(np.float32)).to(device)
            for t in (mu_t, sg_t))


@functools.lru_cache(maxsize=64)
def _policy_moment_maps(policy: str, tile_k: int, tile_n: int, k: int, n: int,
                        noise_scale: float, device: str):
    """Device (mu, sigma) (K, N) maps of a policy: the (gk, gn) tile grid is
    gathered from the tables and expanded on the device, once per shape."""
    gk, gn = -(-k // tile_k), -(-n // tile_n)
    grid = torch.from_numpy(_policy_sequence(policy, gk * gn).reshape(gk, gn)
                            .astype(np.int64)).to(device)

    def expand(t):
        return (t[grid].repeat_interleave(tile_k, 0)[:k]
                .repeat_interleave(tile_n, 1)[:, :n].contiguous())

    return tuple(expand(t) for t in _scaled_tables(noise_scale, device))


def device_moment_maps(maps: CanonicalMap, noise_scale: float = 1.0, device="cuda"):
    """Per-slot (mu, sigma) float32 maps of a canonical map as tensors on
    ``device``, (P?, ...) like maps.vids; bitwise ``moment_maps``' values."""
    dev = torch.device(device)
    if maps.policy is not None:
        policy, tile_k, tile_n = maps.policy
        k, n = maps.vids.shape
        return _policy_moment_maps(policy, tile_k, tile_n, k, n, float(noise_scale),
                                   str(dev))
    idx = torch.from_numpy(np.asarray(maps.vids, np.int64)).to(dev)
    return tuple(t[idx] for t in _scaled_tables(noise_scale, dev))


def fold_matmul_weights(w: torch.Tensor, maps: CanonicalMap, *,
                        noise_scale: float = 1.0):
    """Fold per-slot moments into (P?, K, N) mean/var matmul weights on w's
    device: ``w * (1 + mu)`` and ``(w * w) * (sg * sg)``, elementwise float32,
    bitwise the reference's fold. w: (K, N) tensor of any float type."""
    mu, sg = device_moment_maps(maps, noise_scale, w.device)
    wf = w.float()
    return wf * (1.0 + mu), (wf * wf) * (sg * sg)


def fold_conv_gemm_weights(w, maps: CanonicalMap, *, noise_scale: float = 1.0,
                           layout: str = "tap_major", device="cuda"):
    """Fold per-slot moments into (P?, F, kh*kw*Cin) mean/var GEMM weights.

    w: (F, kh, kw, Cin), folded on the host in numpy float32. Column order:
    "tap_major" is (tap, channel) with the channel fastest, "channel_major"
    (channel, tap) with the tap fastest. ``device`` names the calibration's
    device. Returns (w_mean, w_var), with a population axis iff maps.pop.
    """
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    f, kh, kw, cin = w.shape
    vids = maps.vids if maps.pop else maps.vids[None]
    taps = vids.reshape(vids.shape[0], f, kh * kw)
    mu, sg = moment_maps(taps, noise_scale, device)
    if layout == "tap_major":
        wf = w.reshape(f, kh * kw * cin)
        mu_c = np.repeat(mu, cin, axis=2)
        sg_c = np.repeat(sg, cin, axis=2)
    elif layout == "channel_major":
        wf = w.transpose(0, 3, 1, 2).reshape(f, cin * kh * kw)
        mu_c = np.tile(mu, (1, 1, cin))
        sg_c = np.tile(sg, (1, 1, cin))
    else:
        raise ValueError(f"unknown layout {layout!r}")
    wm = wf[None] * (1.0 + mu_c)
    wv = (wf * wf)[None] * (sg_c * sg_c)
    if not maps.pop:
        wm, wv = wm[0], wv[0]
    return wm.astype(np.float32), wv.astype(np.float32)


def conv_patch_matrix(x, kh: int, kw: int):
    """Tap-major im2col of images: (B, H, W, C) -> (kh*kw*C, B, ho*wo).

    Row order matches fold_conv_gemm_weights(layout="tap_major"): taps scan
    (ky, kx) row-major with the channel fastest. Works on numpy arrays and
    on tensors alike.
    """
    b, h, wd, c = x.shape
    ho, wo = h - kh + 1, wd - kw + 1
    taps = [x[:, i:i + ho, j:j + wo, :] for i in range(kh) for j in range(kw)]
    if isinstance(x, torch.Tensor):
        px = torch.stack(taps, 0).permute(0, 4, 1, 2, 3)
    else:
        px = np.stack(taps, 0).transpose(0, 4, 1, 2, 3)  # (taps, C, B, ho, wo)
    return px.reshape(kh * kw * c, b, ho * wo)


def population_blocks(p: int, block: int) -> int:
    """Number of ``block``-genome blocks for a population of p, padded to a
    power of two so per-block shapes are fixed: a genome's score does not
    depend on the batch it is scored in."""
    return 1 << (max(1, -(-p // block)) - 1).bit_length()


def pad_population(arr: np.ndarray, block: int) -> np.ndarray:
    """Pad genomes (P, ...) to population_blocks(P) * block rows with copies
    of row 0 (the caller discards the padded scores)."""
    p = arr.shape[0]
    p_pad = population_blocks(p, block) * block
    if p_pad == p:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], p_pad - p, axis=0)])


def select_backend(kind: str, *, has_map: bool, work: int, device="cuda") -> str:
    """Automatic backend choice: bit-exact for small work (the CUDA kernels
    for CUDA tensors), the fused surrogate for search-scale work. ``work``
    is scalar multiplies for the whole call, population included."""
    del kind
    if not has_map:
        return "exact"
    if work <= BITEXACT_AUTO_MAX_MULS:
        return "bitexact_cuda" if torch.device(device).type == "cuda" else "bitexact_ref"
    return "surrogate_fused"


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Ctx:
    return_moments: bool
    pop_x: bool  # x carries a leading population axis
    noise_scale: float


def _require_key(key, backend: str):
    if key is None:
        raise ValueError(f"backend {backend!r} draws noise and needs a key")


def _noise(key, mean, var):
    z = surrogate.crn_normal(key, mean.shape, mean.device)
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0))


def _map_pop(ctx: _Ctx, cmap: CanonicalMap, fn, x):
    """Apply fn(x_slice, single_map) over the population axis, stacking."""
    if not cmap.pop:
        return fn(x, cmap)
    outs = [fn(x[p] if ctx.pop_x else x, m) for p, m in enumerate(cmap.per_genome())]
    if ctx.return_moments:
        means, vars_ = zip(*outs)
        return torch.stack(means), torch.stack(vars_)
    return torch.stack(outs)


def _broadcast_pop(ctx: _Ctx, cmap: CanonicalMap, out):
    """Give map-ignoring backends (exact) the population axis of the API."""
    if not cmap.pop or ctx.pop_x:
        return out
    if ctx.return_moments:
        mean, var = out
        shape = (cmap.population,)
        return (mean.expand(shape + mean.shape), var.expand(shape + var.shape))
    return out.expand((cmap.population,) + out.shape)


def _with_moments(ctx, y):
    """Deterministic backends: mean = y, var = 0."""
    return (y, torch.zeros_like(y)) if ctx.return_moments else y


def _exact_matmul(ctx, x, w, cmap, key):
    del key
    y = x.float() @ w.float()
    return _broadcast_pop(ctx, cmap, _with_moments(ctx, y))


def _exact_conv2d(ctx, x, w, cmap, key):
    del key
    if ctx.pop_x:
        y = ref.conv2d_exact_ref(x.reshape((-1,) + x.shape[2:]), w)
        y = y.reshape((x.shape[0], -1) + y.shape[1:])
    else:
        y = ref.conv2d_exact_ref(x, w)
    return _broadcast_pop(ctx, cmap, _with_moments(ctx, y))


def _bitexact_matmul_ref(ctx, x, w, cmap, key):
    del key
    return _map_pop(ctx, cmap, lambda xs, m: _with_moments(
        ctx, ref.am_matmul_bitexact_ref(xs, w, m.vids)), x)


def _bitexact_matmul_cuda(ctx, x, w, cmap, key):
    del key
    return _map_pop(ctx, cmap, lambda xs, m: _with_moments(
        ctx, ops.am_matmul_bitexact(xs, w, m.vids)), x)


def _bitexact_conv2d_ref(ctx, x, w, cmap, key):
    del key
    return _map_pop(ctx, cmap, lambda xs, m: _with_moments(
        ctx, ref.am_conv2d_bitexact_ref(xs, w, m.vids)), x)


def _bitexact_conv2d_cuda(ctx, x, w, cmap, key):
    del key
    return _map_pop(ctx, cmap, lambda xs, m: _with_moments(
        ctx, ops.am_conv2d_bitexact(xs, w, m.vids)), x)


def _surrogate_matmul_torch(ctx, x, w, cmap, key):
    if not ctx.return_moments:
        _require_key(key, "surrogate_torch")

    def one(xs, m):
        mu, sg = device_moment_maps(m, ctx.noise_scale, xs.device)
        xf, wf = xs.float(), w.float()
        mean = xf @ (wf * (1.0 + mu))
        var = (xf * xf) @ ((wf * wf) * (sg * sg))
        return (mean, var) if ctx.return_moments else _noise(key, mean, var)

    return _map_pop(ctx, cmap, one, x)


def _surrogate_matmul_fused(ctx, x, w, cmap, key):
    """Moments folded into (P?, K, N) weights once per call; both
    contractions and the noise epilogue are one launch of B5 (z drawn for the
    single-genome (M, N) output and shared across the population). Moments
    without a population are one launch of B6; with one they are plain
    einsums, as in the reference."""
    _require_key(key, "surrogate_fused")
    wm, wv = fold_matmul_weights(w, cmap, noise_scale=ctx.noise_scale)
    xf = x.float()
    if ctx.return_moments:
        if not cmap.pop:
            return ops.am_surrogate_moments_folded(xf, wm, wv)
        spec = "pmk,pkn->pmn" if ctx.pop_x else "mk,pkn->pmn"
        return torch.einsum(spec, xf, wm), torch.einsum(spec, xf * xf, wv)
    z = surrogate.crn_normal(key, (xf.shape[-2], wm.shape[-1]), x.device)
    return ops.am_surrogate_matmul_epilogue(xf, wm, wv, z)


def _surrogate_conv2d_torch(ctx, x, w, cmap, key):
    if not ctx.return_moments:
        _require_key(key, "surrogate_torch")

    def one(xs, m):
        mu, sg = device_moment_maps(m, ctx.noise_scale, xs.device)
        mean = ref.conv2d_exact_ref(xs, w * (1.0 + mu[..., None]))
        var = ref.conv2d_exact_ref(xs * xs, (w * w) * (sg * sg)[..., None])
        return (mean, var) if ctx.return_moments else _noise(key, mean, var)

    return _map_pop(ctx, cmap, one, x)


def _surrogate_conv2d_fused(ctx, x, w, cmap, key):
    """Population surrogate conv: im2col GEMMs with the moments folded into
    per-genome tap-major weights; one z per output position, shared across
    the population."""
    if not ctx.return_moments:
        _require_key(key, "surrogate_fused")
    f, kh, kw, cin = w.shape
    wm, wv = (torch.from_numpy(t).to(x.device) for t in fold_conv_gemm_weights(
        w, cmap, noise_scale=ctx.noise_scale, layout="tap_major", device=x.device))

    if ctx.pop_x:
        b, ho, wo = x.shape[1], x.shape[2] - kh + 1, x.shape[3] - kw + 1
        pat = torch.stack([conv_patch_matrix(xs, kh, kw).reshape(kh * kw * cin, -1)
                           for xs in x])
        mean = torch.einsum("pfk,pkm->pfm", wm, pat)
        var = torch.einsum("pfk,pkm->pfm", wv, pat * pat)
    else:
        b, ho, wo = x.shape[0], x.shape[1] - kh + 1, x.shape[2] - kw + 1
        pat = conv_patch_matrix(x, kh, kw).reshape(kh * kw * cin, -1)
        mean, var = wm @ pat, wv @ (pat * pat)

    def unflatten(t):  # (..., F, B*ho*wo) -> (..., B, ho, wo, F)
        return torch.movedim(t.reshape(t.shape[:-1] + (b, ho, wo)), -4, -1)

    mean, var = unflatten(mean), unflatten(var)
    if ctx.return_moments:
        return mean, var
    z_shape = mean.shape[1:] if cmap.pop else mean.shape
    z = surrogate.crn_normal(key, z_shape, x.device)
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0))


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    matmul: Callable
    conv2d: Callable


_BACKENDS = {
    "exact": BackendSpec(_exact_matmul, _exact_conv2d),
    "bitexact_ref": BackendSpec(_bitexact_matmul_ref, _bitexact_conv2d_ref),
    "bitexact_cuda": BackendSpec(_bitexact_matmul_cuda, _bitexact_conv2d_cuda),
    "surrogate_torch": BackendSpec(_surrogate_matmul_torch, _surrogate_conv2d_torch),
    "surrogate_fused": BackendSpec(_surrogate_matmul_fused, _surrogate_conv2d_fused),
}


BACKEND_NAMES = tuple(_BACKENDS)


def get_backend(name: str) -> BackendSpec:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown AM backend {name!r}; have {sorted(_BACKENDS)}") from None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _resolve_pop_x(x, cmap: CanonicalMap, base_ndim: int, x_population):
    pop_x = (cmap.pop and x.dim() == base_ndim + 1) if x_population is None \
        else bool(x_population)
    if pop_x:
        if not cmap.pop:
            raise ValueError("x has a population axis but slot_map does not")
        if x.shape[0] != cmap.population:
            raise ValueError(f"x population axis {x.shape[0]} != slot-map "
                             f"population {cmap.population}")
    return pop_x


def am_matmul(x: torch.Tensor, w: torch.Tensor, slot_map=None, *, backend=None,
              key=None, return_moments: bool = False, x_population=None,
              tile_k: int = 128, tile_n: int = 128, noise_scale: float = 1.0):
    """x (..., K) @ w (K, N) under AM numerics.

    Leading dims of x are flattened into M and restored. With a population
    slot_map, a 3-D x whose leading dim equals P is per-genome input
    (override with x_population). ``key`` (an int) seeds surrogate noise.
    """
    k, n = w.shape
    cmap = canonical_matmul_map(slot_map, k, n, tile_k=tile_k, tile_n=tile_n)
    pop_x = _resolve_pop_x(x, cmap, 2, x_population)
    lead = tuple(x.shape[(1 if pop_x else 0):-1])
    x2 = x.reshape((cmap.population, -1, k) if pop_x else (-1, k))
    m = int(np.prod(lead, dtype=np.int64)) if lead else 1
    name = backend or select_backend(
        "matmul", has_map=slot_map is not None and bool(np.any(cmap.vids)),
        work=m * k * n * cmap.population, device=x.device)
    ctx = _Ctx(return_moments, pop_x, noise_scale)
    out = get_backend(name).matmul(ctx, x2, w, cmap, key)

    def fix(t):
        if cmap.pop:
            return t.reshape((t.shape[0],) + lead + (n,))
        return t.reshape(lead + (n,))

    if return_moments:
        return fix(out[0]), fix(out[1])
    return fix(out)


def am_conv2d(x: torch.Tensor, w: torch.Tensor, slot_map=None, *, backend=None,
              key=None, return_moments: bool = False, x_population=None,
              noise_scale: float = 1.0):
    """NHWC VALID stride-1 conv2d under AM numerics.

    x: (B, H, W, Cin), or (P, B, H, W, Cin) with a population slot_map;
    w: (F, kh, kw, Cin); slot_map canonicalizes to (P?, F, kh, kw).
    """
    f, kh, kw, cin = w.shape
    cmap = canonical_conv_map(slot_map, f, kh, kw)
    pop_x = _resolve_pop_x(x, cmap, 4, x_population)
    ho, wo = x.shape[-3] - kh + 1, x.shape[-2] - kw + 1
    name = backend or select_backend(
        "conv2d", has_map=slot_map is not None and bool(np.any(cmap.vids)),
        work=int(x.shape[-4]) * ho * wo * f * kh * kw * cin * cmap.population,
        device=x.device)
    ctx = _Ctx(return_moments, pop_x, noise_scale)
    return get_backend(name).conv2d(ctx, x, w, cmap, key)
