"""Calibrated statistical surrogate of the approximate multipliers.

Each AM's output is modelled as ``p * (1 + eps_v)`` with ``eps_v`` drawn to
match the variant's relative-error moments (MRE, RMSRE), calibrated against
the bit-exact emulator on standard-normal operands. For a conv or matmul
with per-slot variants the first two moments fold into the weights:

    E[y]   = x (*) (w * (1 + mu_V))
    Var[y] = (x^2) (*) (w^2 * sigma^2_V)
    y      = E[y] + z * sqrt(Var[y]),   z ~ N(0, 1)

Calibration draws ``a`` then ``b`` from ``default_rng(1234)`` (2^18 each),
computes the products of the exact multiplier and of the eight AMs in one
launch of the stacked emulator (B4 on a CUDA device, its plain version on
the CPU), and takes the float64 means in numpy on the host. The products are
bitwise those of the JAX reference, so the (mu, sigma) tables equal its
tables bit for bit. They are computed per process, never read from disk.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import schemes

CALIB_N = 1 << 18
CALIB_SEED = 1234


def calibration_operands(n: int = CALIB_N, seed: int = CALIB_SEED):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n, dtype=np.float32)
    b = rng.standard_normal(n, dtype=np.float32)
    return a, b


def relative_moments(approx: np.ndarray, exact: np.ndarray) -> dict[str, float]:
    """MRE and RMSRE of approximate against exact products (float64)."""
    ok = np.isfinite(exact) & (exact != 0)
    rel = (approx[ok].astype(np.float64) - exact[ok]) / exact[ok].astype(np.float64)
    return {"mre": float(rel.mean()), "rmsre": float(np.sqrt((rel**2).mean()))}


def _stacked_products(maps: np.ndarray, n: int, seed: int, device) -> np.ndarray:
    from repro_torch.kernels import ops

    a, b = calibration_operands(n, seed)
    out = ops.fp32_multiply_stacked(torch.from_numpy(a).to(device),
                                    torch.from_numpy(b).to(device), maps)
    return out.cpu().numpy()


def calibrate_moments(scheme_codes, n: int = CALIB_N, seed: int = CALIB_SEED,
                      device="cuda") -> dict[str, float]:
    """Relative-error moments of one (3, 48) scheme map (one stacked launch
    over the exact map and this one)."""
    maps = np.stack([schemes.scheme_map("exact"),
                     schemes.validate_scheme_map(scheme_codes)])
    prods = _stacked_products(maps, n, seed, device)
    return relative_moments(prods[1], prods[0])


def seed_variant_stats(n: int = CALIB_N, seed: int = CALIB_SEED,
                       device="cuda") -> dict[str, dict[str, float]]:
    """Moments of the nine seed variants from one stacked launch over their
    maps; map 0 is the exact multiplier, whose moments are zero by definition."""
    prods = _stacked_products(schemes.scheme_stack(), n, seed, device)
    stats = {"exact": {"mre": 0.0, "rmsre": 0.0}}
    for vid, v in enumerate(schemes.SEED_VARIANTS[1:], start=1):
        stats[v] = relative_moments(prods[vid], prods[0])
    return stats


def tables_from_stats(stats: dict[str, dict[str, float]]):
    """(mu, sigma) float32 tables indexed by variant id."""
    mu = np.array([stats[v]["mre"] for v in schemes.VARIANTS], np.float32)
    # sigma^2 = RMSRE^2 - MRE^2 (centred second moment).
    sg = np.array([np.sqrt(max(stats[v]["rmsre"] ** 2 - stats[v]["mre"] ** 2, 0.0))
                   for v in schemes.VARIANTS], np.float32)
    return mu, sg


@functools.lru_cache(maxsize=None)
def _tables(device_type: str):
    mu, sg = tables_from_stats(seed_variant_stats(device=device_type))
    mu.setflags(write=False)
    sg.setflags(write=False)
    return mu, sg


def moment_tables(device="cuda"):
    """(mu, sigma) float32 numpy tables of the seed alphabet, calibrated once
    per process and device type (on the card: one B4 launch)."""
    return _tables(torch.device(device).type)


def fold_in(key: int, data: int) -> int:
    """A new noise key from a key and an integer (the port's ``fold_in``)."""
    return int(np.random.SeedSequence([int(key), int(data)]).generate_state(
        1, np.uint64)[0] >> 1)


def crn_normal(key: int, shape, device="cuda") -> torch.Tensor:
    """Standard-normal float32 draw that is a function of (key, shape,
    device type) only: the common random numbers shared across a population.

    The port's draws come from a ``torch.Generator`` and differ from
    ``jax.random``'s; tests that need the reference's z hand it over.
    """
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)
