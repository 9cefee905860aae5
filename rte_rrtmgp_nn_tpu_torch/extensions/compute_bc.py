"""Upper boundary condition from an isothermal cap layer.

Port of rte_rrtmgp_nn_tpu/extensions/compute_bc.py (reference
extensions/mo_compute_bc.F90:51-246): build one layer from the
k-distribution's minimum pressure down to the domain top, run single-layer
gas optics and transport on it, and return the spectral downward flux at
the domain top, for use as the solver's incident flux.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..gas_concs import GasConcs
from ..gasoptics.kdist import KDist
from ..gasoptics.lut_gas_optics import gas_optics_lw_lut, gas_optics_sw_lut
from ..rte import rte_lw, rte_sw


def compute_bc(kd: KDist, tlay_top: torch.Tensor, plev_top: torch.Tensor, gas_desc: GasConcs,
               mu0: Optional[torch.Tensor] = None, top_at_1: bool = True) -> torch.Tensor:
    """Spectral downward flux (ncol, ngpt) at the pressure ``plev_top``:
    tlay_top (ncol,) the cap layer's temperature, plev_top (ncol,) the
    domain-top pressure [Pa]; ``mu0`` selects the SW path. ``top_at_1``
    states the orientation of ``gas_desc``'s layer axis, so that the cap
    layer takes the top-of-domain concentrations either way."""
    ncol = tlay_top.shape[0]
    p_min = kd.press_ref_min
    play = torch.clamp_min((p_min + plev_top[:, None]) * 0.5, p_min * 1.0001)
    plev = torch.stack([torch.full_like(plev_top, p_min * 1.00005), plev_top], dim=1)
    tlay = tlay_top[:, None]
    tlev = torch.stack([tlay_top, tlay_top], dim=1)

    sl = slice(None, 1) if top_at_1 else slice(-1, None)
    top_concs = {}
    for g in gas_desc.gas_names:
        v = gas_desc.get_raw(g)
        top_concs[g] = v if v.ndim == 0 else v[..., sl]
    gd = GasConcs(top_concs)

    if mu0 is None:
        props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tlay_top, gd, tlev=tlev,
                                           top_at_1=True)
        sol = rte_lw(props, True, sources, torch.ones((ncol, kd.nband), dtype=tlay_top.dtype,
                                                      device=tlay_top.device))
        return sol.flux_dn[:, -1, :]
    props, src = gas_optics_sw_lut(kd, play, plev, tlay, gd)
    alb = torch.zeros_like(src.toa_source)
    sol = rte_sw(props, True, mu0, src.toa_source, alb, alb)
    return sol.flux_dn[:, -1, :]
