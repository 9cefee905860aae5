"""Combined clear/all-sky convenience drivers.

Port of rte_rrtmgp_nn_tpu/extensions/clr_all_sky.py (reference
extensions/mo_rrtmgp_clr_all_sky.F90:46-312): gas optics + optional
aerosol/cloud increments + solver in one call, returning both clear-sky and
all-sky fluxes when requested.

The JAX functions take a k-distribution and run the lookup-table gas optics
on it. That gas optics is still to be ported (ROADMAP Queue 1 item 8), so
here the first argument is the gas-optics step itself, a callable: any gas
optics of this package bound to its data fits, and the k-distribution's
will when it is ported.
"""
from __future__ import annotations

from typing import Callable

from ..fluxes import reduce_broadband
from ..gas_concs import GasConcs
from ..optical_props import OpticalProps2str, delta_scale, increment
from ..rte import rte_lw, rte_sw


def rte_lw_allsky(
    gas_optics: Callable,
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
    """Gas optics + increments + LW transport in one call.
    ``gas_optics(play, plev, tlay, tsfc, gas_desc, tlev=, col_dry=,
    top_at_1=)`` returns (optical props, SourceFuncLW). Returns
    FluxesBroadband (and the clear-sky fluxes if compute_clear)."""
    props, sources = gas_optics(play, plev, tlay, tsfc, gas_desc, tlev=tlev, col_dry=col_dry,
                                top_at_1=top_at_1)
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
    gas_optics: Callable,
    play, plev, tlay,
    gas_desc: GasConcs,
    mu0, sfc_alb_dir, sfc_alb_dif,
    clouds=None,
    aerosols=None,
    col_dry=None,
    top_at_1: bool = True,
    compute_clear: bool = False,
):
    """Gas optics + increments + SW transport in one call; two-stream
    clouds are delta-scaled before incrementing (reference SW path).
    ``gas_optics(play, plev, tlay, gas_desc, col_dry=)`` returns (two-stream
    optical props, TOA source (ncol, ngpt)); the surface albedos are per
    band."""
    props, toa_src = gas_optics(play, plev, tlay, gas_desc, col_dry=col_dry)
    spectral = props.spectral
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
