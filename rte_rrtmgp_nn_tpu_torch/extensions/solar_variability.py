"""Solar variability: NRLSSI2 average-solar-cycle index interpolation.

Port of rte_rrtmgp_nn_tpu/extensions/solar_variability.py (reference
extensions/solar_variability/mo_solar_variability.F90, ty_solar_var: load
the average-cycle facular and sunspot index table, then
``solar_var_ind_interp`` :52-185 with its half-interval end points). Host
arithmetic on a small table; the indices it returns go to
``KDist.solar_source``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import ncio


@dataclasses.dataclass(frozen=True)
class SolarVar:
    avgcyc_ind: np.ndarray  # (2, nsolfrac): [0] = mg (facular), [1] = sb (sunspot)

    @staticmethod
    def load(path: str) -> "SolarVar":
        with ncio.NCFile(path) as f:
            # the file stores (n_solar_frac, n_solar_terms)
            tbl = f.read("solar_var_avgcyc", np.float64)
        return SolarVar(avgcyc_ind=tbl.T.copy())

    def ind_interp(self, solcycfrac: float) -> tuple[float, float]:
        """(mg_index, sb_index) at a fraction in [0, 1] through an average
        solar cycle."""
        if not 0.0 <= solcycfrac <= 1.0:
            raise ValueError("solcycfrac out of range [0,1]")
        tbl = self.avgcyc_ind
        nsolfrac = tbl.shape[1]
        if solcycfrac == 0.0:
            return float(tbl[0, 0]), float(tbl[1, 0])
        if solcycfrac == 1.0:
            return float(tbl[0, -1]), float(tbl[1, -1])
        intrvl_len = 1.0 / (nsolfrac - 2)
        half = 0.5 * intrvl_len
        if solcycfrac <= half:
            sfid, fraclo, frachi = 1, 0.0, half
        elif solcycfrac < 1.0 - half:
            sfid = int(np.floor((solcycfrac - half) * (nsolfrac - 2))) + 2
            fraclo = (sfid - 2) * intrvl_len + half
            frachi = fraclo + intrvl_len
        else:
            sfid, fraclo, frachi = nsolfrac - 1, 1.0 - half, 1.0
        intfrac = (solcycfrac - fraclo) / (frachi - fraclo)
        mg = tbl[0, sfid - 1] + intfrac * (tbl[0, sfid] - tbl[0, sfid - 1])
        sb = tbl[1, sfid - 1] + intfrac * (tbl[1, sfid] - tbl[1, sfid - 1])
        return float(mg), float(sb)
