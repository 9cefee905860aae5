"""LUT gas-optics kernels: interpolation, absorption and Rayleigh optical
depths, Planck sources.

Port of rte_rrtmgp_nn_tpu/ops/gas_optics_lut.py. Reference parity:
``rrtmgp/kernels/mo_gas_optics_kernels.F90`` -- ``interpolation``
(:47-144), ``compute_tau_absorption`` (:150-295) with
``gas_optical_depths_major`` (3-D interpolation per band flavor) and
``gas_optical_depths_minor`` (per-minor density and complement scaling, with
the single-precision ordering of :436-440), ``compute_tau_rayleigh``
(:469-511), ``compute_Planck_source`` (:514-611) and the
``interpolate2D/3D_byflav`` stencils (:1060-1165).

Plain tensor ops on the device of the inputs: the table interpolation is
dense per g-point. The per-g-point flavor indices are static (made once per
KDist), so each of the 8 trilinear corners is one indexed load over (ncol,
nlay, ngpt) elements from the flattened table; the band and minor-gas loops
are Python loops over contiguous g-point ranges; the troposphere split is a
mask, not a layer-range loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..gasoptics.kdist import KDist, MinorGasData
from ..gasoptics.planck import compute_planck_source_nn
from ..utils.timing import span

PA_TO_HPA = 0.01


class InterpCoeffs(NamedTuple):
    """Interpolation state; shapes (ncol, nlay, ...)."""

    jtemp: torch.Tensor  # (ncol, nlay) 0-based lower temperature index
    ftemp: torch.Tensor  # (ncol, nlay)
    jpress: torch.Tensor  # (ncol, nlay) 0-based lower pressure index
    fpress: torch.Tensor  # (ncol, nlay)
    tropo: torch.Tensor  # (ncol, nlay) bool, True = lower atmosphere
    jeta: torch.Tensor  # (ncol, nlay, nflav, 2) 0-based eta index per temperature level
    feta: torch.Tensor  # (ncol, nlay, nflav, 2)
    col_mix: torch.Tensor  # (ncol, nlay, nflav, 2)


def compute_col_gas(kd: KDist, gas_desc, col_dry: torch.Tensor) -> torch.Tensor:
    """col_gas (ncol, nlay, 1+ngas): molecular column amounts; index 0 is
    dry air (reference compute_gas_optics :896-912)."""
    ncol, nlay = col_dry.shape
    return torch.stack([col_dry] + [gas_desc.get_vmr(g, ncol, nlay) * col_dry
                                    for g in kd.gas_names], dim=-1)


def interpolation(kd: KDist, play: torch.Tensor, tlay: torch.Tensor,
                  col_gas: torch.Tensor) -> InterpCoeffs:
    """Reference ``interpolation`` (:47-144), all flavors at once."""
    dtype, dev = play.dtype, play.device
    ntemp, npres, neta = kd.ntemp, kd.npres, kd.neta
    temp_ref = torch.tensor(kd.temp_ref, dtype=dtype, device=dev)
    tmin, dt = kd.temp_ref_min, kd.temp_ref_delta

    jtemp = torch.clamp(((tlay - (tmin - dt)) / dt).to(torch.int64) - 1, 0, ntemp - 2)
    ftemp = (tlay - temp_ref[jtemp]) / dt

    play_log = torch.log(play)
    locpress = (play_log - kd.press_ref_log[0]) / kd.press_ref_log_delta  # 0-based, fractional
    jpress = torch.clamp(locpress.to(torch.int64), 0, npres - 2)
    fpress = locpress - jpress.to(dtype)

    tropo = play_log > kd.press_ref_trop_log
    itropo = torch.where(tropo, 0, 1)

    flav = kd.flavor_index  # (nflav, 2) col_gas indices
    g1 = col_gas[..., flav[:, 0]]  # (ncol, nlay, nflav)
    g2 = col_gas[..., flav[:, 1]]
    vrt = kd.vmr_ref.permute(2, 0, 1)  # (ntemp, 2, 1+ngas)
    tiny = torch.finfo(dtype).tiny
    jetas, fetas, col_mixes = [], [], []
    for dtl in (0, 1):
        v_sel = vrt[jtemp + dtl, itropo]  # (ncol, nlay, 1+ngas)
        ratio_eta_half = v_sel[..., flav[:, 0]] / v_sel[..., flav[:, 1]]
        col_mix = g1 + ratio_eta_half * g2
        ok = col_mix > 2.0 * tiny
        eta = torch.where(ok, g1 / torch.where(ok, col_mix, 1.0), 0.5)
        loceta = eta * (neta - 1)
        je = torch.clamp(loceta.to(torch.int64), 0, neta - 2)
        jetas.append(je)
        fetas.append(loceta - je.to(dtype))
        col_mixes.append(col_mix)
    return InterpCoeffs(jtemp, ftemp, jpress, fpress, tropo, torch.stack(jetas, dim=-1),
                        torch.stack(fetas, dim=-1), torch.stack(col_mixes, dim=-1))


def _per_gpt_flavor(kd: KDist, ic: InterpCoeffs) -> torch.Tensor:
    """(ncol, nlay, ngpt) flavor index: the static per-g-point flavors, the
    lower or the upper atmosphere's by the troposphere mask."""
    gf = kd.gpoint_flavor_index
    return torch.where(ic.tropo[..., None], gf[:, 0], gf[:, 1])


def _select_flavored(arr: torch.Tensor, iflav: torch.Tensor) -> torch.Tensor:
    """Per-flavor (ncol, nlay, nflav, 2) -> per-g-point (ncol, nlay, ngpt,
    2) by the (ncol, nlay, ngpt) flavor index."""
    return torch.gather(arr, 2, iflav[..., None].expand(*iflav.shape, arr.shape[-1]))


def _interp3d(kd: KDist, ic: InterpCoeffs, table: torch.Tensor, scaled: bool) -> torch.Tensor:
    """Trilinear (temperature, pressure, eta) interpolation of a (ntemp,
    npres+1, neta, ngpt) table per g-point (interpolate3D_byflav), weighted
    by col_mix when ``scaled``. Returns (ncol, nlay, ngpt)."""
    ngpt, neta, npres = kd.ngpt, kd.neta, kd.npres
    iflav = _per_gpt_flavor(kd, ic)
    jeta_g = _select_flavored(ic.jeta, iflav)  # (ncol, nlay, ngpt, 2)
    feta_g = _select_flavored(ic.feta, iflav)
    colmix_g = _select_flavored(ic.col_mix, iflav) if scaled else None
    ftemp_term = (1.0 - ic.ftemp, ic.ftemp)
    fpress_term = (1.0 - ic.fpress, ic.fpress)
    itropo0 = torch.where(ic.tropo, 0, 1)  # the lower atmosphere's pressure plane offset is 0
    kflat = table.reshape(-1, ngpt)  # (ntemp*(npres+1)*neta, ngpt)
    gidx = torch.arange(ngpt, device=table.device)
    out = torch.zeros(iflav.shape, dtype=ic.ftemp.dtype, device=table.device)
    for dtl in (0, 1):
        jt = ic.jtemp + dtl
        for dp in (0, 1):
            base = (jt * (npres + 1) + ic.jpress + itropo0 + dp) * neta  # (ncol, nlay)
            for de in (0, 1):
                kval = kflat[base[..., None] + jeta_g[..., dtl] + de, gidx]
                w_eta = feta_g[..., dtl] if de else 1.0 - feta_g[..., dtl]
                if scaled:
                    w = colmix_g[..., dtl] * ftemp_term[dtl][..., None] \
                        * fpress_term[dp][..., None] * w_eta
                else:
                    w = ftemp_term[dtl][..., None] * fpress_term[dp][..., None] * w_eta
                out = out + w * kval
    return out


def tau_major(kd: KDist, ic: InterpCoeffs) -> torch.Tensor:
    """Major-species optical depth (gas_optical_depths_major), (ncol, nlay,
    ngpt)."""
    return _interp3d(kd, ic, kd.kmajor, scaled=True)


def tau_minor_one_atmos(kd: KDist, minor: MinorGasData, atmos_is_lower: bool, ic: InterpCoeffs,
                        play: torch.Tensor, tlay: torch.Tensor, col_gas: torch.Tensor,
                        idx_h2o: int, tau: torch.Tensor) -> torch.Tensor:
    """``tau`` plus the minor-gas optical depths of one atmosphere (lower
    or upper); reference gas_optical_depths_minor (:360-462). The
    layer-range loop is a troposphere mask. ``tau`` is not modified."""
    if minor.n_minor == 0:
        return tau
    tau = tau.clone()
    mask = ic.tropo if atmos_is_lower else ~ic.tropo
    neta = kd.neta
    kflat = minor.kminor.reshape(-1, minor.kminor.shape[-1])  # (ntemp*neta, ncontrib)
    vmr_fact = 1.0 / col_gas[..., 0]
    dry_fact = 1.0 / (1.0 + col_gas[..., idx_h2o] * vmr_fact)
    dens = PA_TO_HPA * play / tlay
    ftemp_term = (1.0 - ic.ftemp, ic.ftemp)
    for im in range(minor.n_minor):
        gpt_s, gpt_e = minor.limits_gpt[im]
        scaling = col_gas[..., minor.idx_minor[im]]
        if minor.scales_with_density[im]:
            scaling = scaling * dens
            iscl = minor.idx_minor_scaling[im]
            if iscl > 0:
                frac = col_gas[..., iscl] * vmr_fact * dry_fact
                # the small factor is formed first (reference :436-440)
                scaling = scaling * ((1.0 - frac) if minor.scale_by_complement[im] else frac)
        # the flavor of this minor's g-point range (constant over the range)
        iflav = kd.gpoint_flavor[gpt_s][0 if atmos_is_lower else 1]
        je, fe = ic.jeta[:, :, iflav, :], ic.feta[:, :, iflav, :]  # (ncol, nlay, 2)
        ks = minor.kminor_start[im]
        ksub = kflat[:, ks:ks + gpt_e - gpt_s]  # only this minor's columns ride the row loads
        contrib = 0.0
        for dtl in (0, 1):
            jt = ic.jtemp + dtl
            for de in (0, 1):
                kval = ksub[jt * neta + je[..., dtl] + de]  # (ncol, nlay, nb_g)
                w_eta = fe[..., dtl] if de else 1.0 - fe[..., dtl]
                contrib = contrib + (w_eta * ftemp_term[dtl])[..., None] * kval
        tau[..., gpt_s:gpt_e] += torch.where(mask[..., None], scaling[..., None] * contrib, 0.0)
    return tau


def compute_tau_absorption(kd: KDist, ic: InterpCoeffs, play: torch.Tensor, tlay: torch.Tensor,
                           col_gas: torch.Tensor) -> torch.Tensor:
    """Major + minor-lower + minor-upper absorption optical depth
    (reference compute_tau_absorption :150-295), in the spans
    ``rte.lut.major`` and ``rte.lut.minor``."""
    idx_h2o = 1 + kd.gas_names.index("h2o")
    with span("rte.lut.major"):
        tau = tau_major(kd, ic)
    with span("rte.lut.minor"):
        tau = tau_minor_one_atmos(kd, kd.minor_lower, True, ic, play, tlay, col_gas, idx_h2o,
                                  tau)
        return tau_minor_one_atmos(kd, kd.minor_upper, False, ic, play, tlay, col_gas, idx_h2o,
                                   tau)


def compute_tau_rayleigh(kd: KDist, ic: InterpCoeffs, col_gas: torch.Tensor,
                         col_dry: torch.Tensor) -> torch.Tensor:
    """Rayleigh-scattering optical depth (reference compute_tau_rayleigh
    :469-511): 2-D (eta, temperature) interpolation of krayl per g-point,
    scaled by the moist column amount."""
    idx_h2o = 1 + kd.gas_names.index("h2o")
    ngpt, neta = kd.ngpt, kd.neta
    iflav = _per_gpt_flavor(kd, ic)
    jeta_g = _select_flavored(ic.jeta, iflav)  # (ncol, nlay, ngpt, 2)
    feta_g = _select_flavored(ic.feta, iflav)
    itropo0 = torch.where(ic.tropo, 0, 1)[..., None]
    kflat = kd.krayl.reshape(-1, ngpt)  # (2*ntemp*neta, ngpt)
    gidx = torch.arange(ngpt, device=kflat.device)
    k = torch.zeros(iflav.shape, dtype=col_dry.dtype, device=kflat.device)
    for dtl in (0, 1):
        ftt = (ic.ftemp if dtl else 1.0 - ic.ftemp)[..., None]
        base = (itropo0 * kd.ntemp + (ic.jtemp + dtl)[..., None]) * neta
        for de in (0, 1):
            kval = kflat[base + jeta_g[..., dtl] + de, gidx]
            w_eta = feta_g[..., dtl] if de else 1.0 - feta_g[..., dtl]
            k = k + ftt * w_eta * kval
    return k * (col_gas[..., idx_h2o] + col_dry)[..., None]


def compute_planck_source(kd: KDist, ic: InterpCoeffs, tlay: torch.Tensor, tlev: torch.Tensor,
                          tsfc: torch.Tensor, top_at_1: bool, save_pfrac: bool = False):
    """Planck sources from the Planck-fraction table (reference
    compute_Planck_source :514-611): the fraction is the unscaled 3-D
    interpolation of pfracin. Returns (lay_source, lev_source, sfc_source,
    sfc_source_jac[, pfrac])."""
    pfrac = _interp3d(kd, ic, kd.pfracin, scaled=False)
    out = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, kd.spectral, kd.planck,
                                   top_at_1=top_at_1)
    return out + (pfrac,) if save_pfrac else out
