"""Clear-sky regression harness: many solver variants over one atmosphere.

Port of rte_rrtmgp_nn_tpu/drivers/clear_sky_regression.py. Reference parity: ``tests/clear_sky_regression.F90`` (the 10 LW + SW solver
variants written as named broadband fields via mo_testing_io
``write_broadband_field``) and the cross-checks of ``tests/verification.py
:26-77``. Returns/writes named fields: lw_flux_{up,dn}[_variant] for
variants default, notlev, 3ang, optang, jaco, subset, vr, inc1scl/inc2str,
2str; sw_flux_{up,dn,dir}[, _vr, _tsi2].

Every variant runs on ``device`` (a required keyword, as in every driver
of the port); the inputs are moved there, the k-distribution must be there.
The LW solves but the Jacobian's ask ``rte_lw`` for broadband fluxes: on
CUDA each is one launch of the transport kernel (K7). The Jacobian and the
SW variants are spectral, reduced to broadband afterwards, as in the JAX
harness (which reduces every solve afterwards).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..fluxes import FluxesBroadband, reduce_broadband
from ..gas_concs import GasConcs
from ..gasoptics.kdist import KDist
from ..gasoptics.lut_gas_optics import (
    compute_optimal_angles,
    gas_optics_lw_lut,
    gas_optics_sw_lut,
)
from ..optical_props import increment, zeros_1scl, zeros_2str
from ..rte import rte_lw, rte_sw
from ..spectral import SpectralMapping
from ..utils import ncio


def _flip_gc(gc: GasConcs) -> GasConcs:
    return GasConcs({k: (v.flip(-1) if v.ndim else v) for k, v in gc.concs.items()})


def _on(device, *arrays):
    return [(a if torch.is_tensor(a) else torch.tensor(np.asarray(a))).to(device)
            for a in arrays]


def _gases_on(gas_desc: GasConcs, device, dtype) -> GasConcs:
    return GasConcs({k: v.to(device, dtype) for k, v in gas_desc.concs.items()})


def run_lw_variants(kd: KDist, play, plev, tlay, tlev, tsfc, gas_desc, sfc_emis_band,
                    top_at_1: bool = True, *, device) -> dict:
    """All LW solver variants -> {field_name: (ncol, nlev) numpy array}.
    ``kd`` must be on ``device``."""
    out = {}
    play, plev, tlay, tlev, tsfc, sfc_emis_band = _on(device, play, plev, tlay, tlev, tsfc,
                                                      sfc_emis_band)
    gas_desc = _gases_on(gas_desc, device, play.dtype)
    ncol, nlay = play.shape

    def solve(props, sources, emis=sfc_emis_band, top=top_at_1, **kw):
        sol = rte_lw(props, top, sources, emis, broadband=True, **kw)
        return FluxesBroadband(sol.flux_up, sol.flux_dn)

    props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gas_desc, tlev=tlev,
                                       top_at_1=top_at_1)
    fb = solve(props, sources)
    out["lw_flux_up"], out["lw_flux_dn"] = fb.flux_up, fb.flux_dn

    # no-tlev: level temperatures interpolated internally
    props2, sources2 = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gas_desc,
                                         top_at_1=top_at_1)
    fb = solve(props2, sources2)
    out["lw_flux_up_notlev"], out["lw_flux_dn_notlev"] = fb.flux_up, fb.flux_dn

    # 3-angle Gaussian quadrature
    fb = solve(props, sources, n_gauss_angles=3)
    out["lw_flux_up_3ang"], out["lw_flux_dn_3ang"] = fb.flux_up, fb.flux_dn

    # optimal angles
    if kd.optimal_angle_fit is not None:
        lw_ds = compute_optimal_angles(kd, props.tau)
        fb = solve(props, sources, lw_ds=lw_ds)
        out["lw_flux_up_optang"], out["lw_flux_dn_optang"] = fb.flux_up, fb.flux_dn

    # Jacobian
    sol = rte_lw(props, top_at_1, sources, sfc_emis_band, compute_jac=True)
    fbj = reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_up_jac=sol.flux_up_jac)
    out["lw_flux_up_jaco"], out["lw_flux_dn_jaco"] = fbj.flux_up, fbj.flux_dn
    out["lw_jaco_up"] = fbj.flux_up_jac
    # perturbed-surface run for the Jacobian consistency check
    _, sources_p = gas_optics_lw_lut(kd, play, plev, tlay, tsfc + 1.0, gas_desc, tlev=tlev,
                                     top_at_1=top_at_1)
    fb = solve(props, sources_p)
    out["lw_flux_up_stp1"], out["lw_flux_dn_stp1"] = fb.flux_up, fb.flux_dn

    # column subset (first half)
    nsub = ncol // 2
    props_s, sources_s = gas_optics_lw_lut(
        kd, play[:nsub], plev[:nsub], tlay[:nsub], tsfc[:nsub], gas_desc.subset(0, nsub),
        tlev=tlev[:nsub], top_at_1=top_at_1,
    )
    fb = solve(props_s, sources_s, sfc_emis_band[:nsub])
    out["lw_flux_up_subset"], out["lw_flux_dn_subset"] = fb.flux_up, fb.flux_dn

    # vertical reverse
    props_v, sources_v = gas_optics_lw_lut(
        kd, play.flip(1), plev.flip(1), tlay.flip(1), tsfc,
        _flip_gc(gas_desc), tlev=tlev.flip(1), top_at_1=not top_at_1,
    )
    fb = solve(props_v, sources_v, top=not top_at_1)
    out["lw_flux_up_vr"] = fb.flux_up.flip(1)
    out["lw_flux_dn_vr"] = fb.flux_dn.flip(1)

    # increment-with-zero identities
    band_sm = SpectralMapping.bands_only(kd.spectral.band_lims_wvn_array)
    for tag, zero in (
        ("inc1scl", zeros_1scl(ncol, nlay, kd.spectral, play.dtype, device=device)),
        ("inc2str", zeros_2str(ncol, nlay, band_sm, play.dtype, device=device)),
    ):
        fb = solve(increment(props, zero), sources)
        out[f"lw_flux_up_{tag}"], out[f"lw_flux_dn_{tag}"] = fb.flux_up, fb.flux_dn

    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def run_sw_variants(kd: KDist, play, plev, tlay, gas_desc, mu0, sfc_alb_band,
                    top_at_1: bool = True, *, device) -> dict:
    """The SW variants (default, vertical reverse, TSI doubling) ->
    {field_name: (ncol, nlev) numpy array}. ``kd`` must be on ``device``."""
    out = {}
    play, plev, tlay, mu0, sfc_alb_band = _on(device, play, plev, tlay, mu0, sfc_alb_band)
    gas_desc = _gases_on(gas_desc, device, play.dtype)
    props, src = gas_optics_sw_lut(kd, play, plev, tlay, gas_desc)
    alb = kd.spectral.expand(sfc_alb_band)
    sol = rte_sw(props, top_at_1, mu0, src.toa_source, alb, alb)
    fb = reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_dn_dir=sol.flux_dn_dir)
    out["sw_flux_up"], out["sw_flux_dn"] = fb.flux_up, fb.flux_dn
    out["sw_flux_dir"] = fb.flux_dn_dir

    # vertical reverse
    props_v, src_v = gas_optics_sw_lut(
        kd, play.flip(1), plev.flip(1), tlay.flip(1), _flip_gc(gas_desc)
    )
    sol = rte_sw(props_v, not top_at_1, mu0, src_v.toa_source, alb, alb)
    fb = reduce_broadband(sol.flux_up, sol.flux_dn)
    out["sw_flux_up_vr"] = fb.flux_up.flip(1)
    out["sw_flux_dn_vr"] = fb.flux_dn.flip(1)

    # TSI doubling
    _, src2 = gas_optics_sw_lut(kd, play, plev, tlay, gas_desc, tsi=2.0 * float(src.toa_source[0].sum()))
    sol = rte_sw(props, top_at_1, mu0, src2.toa_source, alb, alb)
    fb = reduce_broadband(sol.flux_up, sol.flux_dn)
    out["sw_flux_up_tsi2"], out["sw_flux_dn_tsi2"] = fb.flux_up, fb.flux_dn
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def verify_variants(fields: Mapping[str, np.ndarray], report_tol=1e-10, fail_tol=1e-5) -> dict:
    """The verification.py cross-checks: returns {check: max_rel_diff} and
    raises on failures above fail_tol."""
    checks = {}

    def rel(a, b):
        denom = np.maximum(np.abs(b), 1.0)
        return float(np.max(np.abs(a - b) / denom))

    f = fields
    if "lw_flux_up" in f:
        checks["lw_vr"] = rel(f["lw_flux_up_vr"], f["lw_flux_up"])
        checks["lw_notlev"] = rel(f["lw_flux_up_notlev"], f["lw_flux_up"])
        nsub = f["lw_flux_up_subset"].shape[0]
        checks["lw_subset"] = rel(f["lw_flux_up_subset"], f["lw_flux_up"][:nsub])
        checks["lw_jacobian"] = rel(
            f["lw_flux_up_stp1"], f["lw_flux_up_jaco"] + f["lw_jaco_up"]
        )
        checks["lw_inc1scl"] = rel(f["lw_flux_up_inc1scl"], f["lw_flux_up"])
        checks["lw_inc2str"] = rel(f["lw_flux_up_inc2str"], f["lw_flux_up"])
    if "sw_flux_up" in f:
        checks["sw_vr"] = rel(f["sw_flux_up_vr"], f["sw_flux_up"])
        checks["sw_tsi"] = rel(f["sw_flux_dn_tsi2"], 2.0 * f["sw_flux_dn"])

    loose = {"lw_notlev": 0.05, "lw_jacobian": 5e-3}  # different-inputs checks
    failures = {
        k: v for k, v in checks.items() if v > loose.get(k, fail_tol)
    }
    if failures:
        raise AssertionError(f"regression checks failed: {failures}")
    return checks


def write_fields(path: str, fields: Mapping[str, np.ndarray]) -> None:
    """mo_testing_io write_broadband_field equivalent: all fields into one
    netCDF (dims col, lev)."""
    items = {k: np.asarray(v) for k, v in fields.items()}
    any_full = next(v for v in items.values() if v.ndim == 2)
    dims = {"col": any_full.shape[0], "lev": any_full.shape[1]}
    variables = {}
    for k, v in items.items():
        if v.shape[0] != dims["col"]:
            dims.setdefault("col_sub", v.shape[0])
            variables[k] = (("col_sub", "lev"), v.astype(np.float64))
        else:
            variables[k] = (("col", "lev"), v.astype(np.float64))
    ncio.write_nc(path, dims, variables)
