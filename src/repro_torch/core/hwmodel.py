"""Hardware cost model: paper Table I (45 nm gpdk45, Cadence Genus).

The paper's accounting (Sec. III): power, delay and PDP add up over the
multiplier slots; area counts each *distinct* multiplier type once (the
multipliers are pre-implemented and reused), so the NSGA-II area objective
counts the distinct variants of a sequence.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import schemes


@dataclasses.dataclass(frozen=True)
class HwSpec:
    area_um2: float
    power_uw: float
    delay_ps: float

    @property
    def pdp_pj(self) -> float:
        # power(uW) * delay(ps) = 1e-6 W * 1e-12 s = 1e-18 J; report pJ.
        return self.power_uw * self.delay_ps * 1e-6


TABLE_I: dict[str, HwSpec] = {
    "exact": HwSpec(3864.60, 139.332, 11966),
    "pm_ni": HwSpec(3627.59, 113.623, 11939),
    "pm_si": HwSpec(3585.19, 110.189, 11524),
    "pm_ci": HwSpec(3589.29, 108.934, 11678),
    "pm_csi": HwSpec(3594.08, 108.736, 11681),
    "nm_ni": HwSpec(3606.73, 115.427, 11933),
    "nm_si": HwSpec(3593.05, 109.351, 11604),
    "nm_ci": HwSpec(3592.37, 109.838, 11588),
    "nm_csi": HwSpec(3603.65, 110.472, 11698),
}

# Lookups indexed by variant id (schemes.VARIANTS order).
_SPECS = [TABLE_I[v] for v in schemes.VARIANTS]
PDP_PJ = np.array([s.pdp_pj for s in _SPECS])
AREA_UM2 = np.array([s.area_um2 for s in _SPECS])
POWER_UW = np.array([s.power_uw for s in _SPECS])
DELAY_PS = np.array([s.delay_ps for s in _SPECS])
for _table in (PDP_PJ, AREA_UM2, POWER_UW, DELAY_PS):
    _table.setflags(write=False)


def sequence_cost(variant_ids) -> dict[str, float]:
    """Hardware cost of a multiplier-slot sequence (the paper's accounting)."""
    v = np.asarray(variant_ids).ravel()
    pdp = float(PDP_PJ[v].sum())
    pdp_exact = TABLE_I["exact"].pdp_pj * v.size
    return {
        "n_slots": int(v.size),
        "pdp_pj": pdp,
        "power_uw": float(POWER_UW[v].sum()),
        "delay_ps": float(DELAY_PS[v].sum()),
        "area_um2": float(AREA_UM2[np.unique(v)].sum()),
        "pdp_benefit_pct": (pdp_exact - pdp) / pdp_exact * 100.0,
    }


def sequence_cost_batch(variant_ids) -> dict[str, np.ndarray]:
    """`sequence_cost` over a (P, L) population, each value a (P,) array;
    per-row area counts distinct types only, as the scalar accounting."""
    v = np.atleast_2d(np.asarray(variant_ids))
    p, l = v.shape
    pdp = PDP_PJ[v].sum(axis=1)
    present = np.zeros((p, schemes.N_VARIANTS), bool)
    np.put_along_axis(present, v, True, axis=1)
    pdp_exact = TABLE_I["exact"].pdp_pj * l
    return {
        "n_slots": np.full(p, l, int),
        "pdp_pj": pdp,
        "power_uw": POWER_UW[v].sum(axis=1),
        "delay_ps": DELAY_PS[v].sum(axis=1),
        "area_um2": present @ AREA_UM2,
        "pdp_benefit_pct": (pdp_exact - pdp) / pdp_exact * 100.0,
    }


def objectives_batch(variant_ids) -> np.ndarray:
    """(P, L) sequences -> (P, 2) hardware objectives [area, pdp]; the
    caller appends the accuracy-loss column."""
    cost = sequence_cost_batch(variant_ids)
    return np.stack([cost["area_um2"], cost["pdp_pj"]], axis=1)
