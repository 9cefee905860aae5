"""Combined clear/all-sky convenience drivers.

Port of rte_rrtmgp_nn_tpu/extensions/clr_all_sky.py (reference
extensions/mo_rrtmgp_clr_all_sky.F90:46-312): gas optics + optional
aerosol/cloud increments + solver in one call, returning both clear-sky and
all-sky fluxes when requested. The gas optics is the lookup-table one on a
k-distribution.
"""
from __future__ import annotations

from typing import Optional

from ..fluxes import reduce_broadband
from ..gas_concs import GasConcs
from ..gasoptics.kdist import KDist
from ..gasoptics.lut_gas_optics import gas_optics_lw_lut, gas_optics_sw_lut
from ..optical_props import OpticalProps2str, delta_scale, increment
from ..rte import rte_lw, rte_sw


def rte_lw_allsky(
    kd: KDist,
    play, plev, tlay, tsfc,
    gas_desc: GasConcs,
    sfc_emis,
    clouds=None,
    aerosols=None,
    tlev=None,
    col_dry=None,
    top_at_1: bool = True,
    n_gauss_angles: int = 1,
    compute_clear: bool = False,
):
    """Gas optics + increments + LW transport in one call. Returns
    FluxesBroadband (and the clear-sky fluxes if compute_clear)."""
    props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gas_desc, tlev=tlev,
                                       col_dry=col_dry, top_at_1=top_at_1)
    clear = None
    if compute_clear:
        sol = rte_lw(props, top_at_1, sources, sfc_emis, n_gauss_angles=n_gauss_angles)
        clear = reduce_broadband(sol.flux_up, sol.flux_dn)
    if aerosols is not None:
        props = increment(props, aerosols)
    if clouds is not None:
        props = increment(props, clouds)
    sol = rte_lw(props, top_at_1, sources, sfc_emis, n_gauss_angles=n_gauss_angles)
    allsky = reduce_broadband(sol.flux_up, sol.flux_dn)
    return (allsky, clear) if compute_clear else allsky


def rte_sw_allsky(
    kd: KDist,
    play, plev, tlay,
    gas_desc: GasConcs,
    mu0, sfc_alb_dir, sfc_alb_dif,
    clouds=None,
    aerosols=None,
    col_dry=None,
    tsi: Optional[float] = None,
    top_at_1: bool = True,
    compute_clear: bool = False,
):
    """Gas optics + increments + SW transport in one call; two-stream
    clouds are delta-scaled before incrementing (reference SW path). The
    surface albedos are per band."""
    props, src = gas_optics_sw_lut(kd, play, plev, tlay, gas_desc, col_dry=col_dry, tsi=tsi)
    toa_src = src.toa_source
    spectral = kd.spectral
    alb_dir = spectral.expand(sfc_alb_dir)
    alb_dif = spectral.expand(sfc_alb_dif)
    clear = None
    if compute_clear:
        sol = rte_sw(props, top_at_1, mu0, toa_src, alb_dir, alb_dif)
        clear = reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_dn_dir=sol.flux_dn_dir)
    if aerosols is not None:
        props = increment(props, aerosols)
    if clouds is not None:
        if isinstance(clouds, OpticalProps2str):
            clouds = delta_scale(clouds)
        props = increment(props, clouds)
    sol = rte_sw(props, top_at_1, mu0, toa_src, alb_dir, alb_dif)
    allsky = reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_dn_dir=sol.flux_dn_dir)
    return (allsky, clear) if compute_clear else allsky
