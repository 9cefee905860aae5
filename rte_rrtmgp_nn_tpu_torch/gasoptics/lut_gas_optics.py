"""LUT gas-optics front ends: the interpolation path of gas_optics_int/ext.

Port of rte_rrtmgp_nn_tpu/gasoptics/lut_gas_optics.py. Reference parity:
``mo_gas_optics_rrtmgp.F90`` ``gas_optics_int`` LUT branch (:417-421 ->
compute_gas_optics :803-1042) and ``gas_optics_ext`` (:433-602):
interpolation -> tau_absorption -> [tau_rayleigh -> combine] -> Planck
source (LW) or solar source broadcast (SW). Everything runs on the device
of the inputs, which must be the k-distribution's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..gas_concs import GasConcs
from ..ops.gas_optics_lut import (
    compute_col_gas,
    compute_planck_source,
    compute_tau_absorption,
    compute_tau_rayleigh,
    interpolation,
)
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..sources import SourceFuncLW, SourceFuncSW
from .kdist import KDist
from .nn_gas_optics import get_col_dry, interp_tlev


def gas_optics_lw_lut(kd: KDist, play, plev, tlay, tsfc, gas_desc: GasConcs,
                      col_dry: Optional[torch.Tensor] = None,
                      tlev: Optional[torch.Tensor] = None, top_at_1: bool = True,
                      save_pfrac: bool = False):
    """LW LUT gas optics -> (OpticalProps1scl, SourceFuncLW)."""
    ncol, nlay = play.shape
    if tlev is None:
        tlev = interp_tlev(tlay, play, plev)
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)
    col_gas = compute_col_gas(kd, gas_desc, col_dry)
    ic = interpolation(kd, play, tlay, col_gas)
    tau = compute_tau_absorption(kd, ic, play, tlay, col_gas)
    lay, lev, sfc, sfc_jac, *pfrac = compute_planck_source(kd, ic, tlay, tlev, tsfc, top_at_1,
                                                           save_pfrac=save_pfrac)
    sources = SourceFuncLW(lay_source=lay, lev_source=lev, sfc_source=sfc,
                           sfc_source_jac=sfc_jac, spectral=kd.spectral,
                           planck_frac=pfrac[0] if pfrac else None)
    return OpticalProps1scl(tau, kd.spectral), sources


def gas_optics_sw_lut(kd: KDist, play, plev, tlay, gas_desc: GasConcs,
                      col_dry: Optional[torch.Tensor] = None, tsi: Optional[float] = None):
    """SW LUT gas optics -> (OpticalProps2str, SourceFuncSW): tau =
    absorption + Rayleigh, ssa = Rayleigh / total, g = 0 (reference
    combine_2str, mo_gas_optics_kernels.F90:1170-1272)."""
    ncol, nlay = play.shape
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)
    col_gas = compute_col_gas(kd, gas_desc, col_dry)
    ic = interpolation(kd, play, tlay, col_gas)
    tau_abs = compute_tau_absorption(kd, ic, play, tlay, col_gas)
    tau_ray = compute_tau_rayleigh(kd, ic, col_gas, col_dry)
    tau_tot = tau_abs + tau_ray
    pos = tau_tot > 0
    ssa = torch.where(pos, tau_ray / torch.where(pos, tau_tot, 1.0), 0.0)
    props = OpticalProps2str(tau_tot, ssa, torch.zeros_like(tau_tot), kd.spectral)
    toa_src = kd.solar_source(tsi=tsi)[None, :].expand(ncol, kd.ngpt)
    return props, SourceFuncSW(toa_source=toa_src, spectral=kd.spectral)


def compute_optimal_angles(kd: KDist, tau: torch.Tensor) -> torch.Tensor:
    """Per-(column, g-point) optimal LW transport secants from a linear fit
    to the column transmittance (reference compute_optimal_angles,
    mo_gas_optics_rrtmgp.F90:1712-1758)."""
    trans_total = torch.exp(-tau.sum(1))  # (ncol, ngpt)
    fit = torch.tensor(kd.optimal_angle_fit, dtype=tau.dtype, device=tau.device)  # (nband, 2)
    fit = kd.spectral.expand(fit.T)  # (2, ngpt)
    return fit[0][None, :] * trans_total + fit[1][None, :]
