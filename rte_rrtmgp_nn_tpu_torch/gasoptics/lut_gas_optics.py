"""LUT gas-optics front ends: the interpolation path of gas_optics_int/ext.

Port of rte_rrtmgp_nn_tpu/gasoptics/lut_gas_optics.py. Reference parity:
``mo_gas_optics_rrtmgp.F90`` ``gas_optics_int`` LUT branch (:417-421 ->
compute_gas_optics :803-1042) and ``gas_optics_ext`` (:433-602):
interpolation -> tau_absorption -> [tau_rayleigh -> combine] -> Planck
source (LW) or solar source broadcast (SW). Everything runs on the device
of the inputs, which must be the k-distribution's. The stages carry
``utils/timing.span`` ranges: ``rte.lut.interp`` (column amounts),
``rte.lut.optics`` (the interpolation, the absorbers and the Planck fraction
or Rayleigh: one launch of K10 off the CPU, ``ops/cuda/lut_gas_optics.py``,
and on the CPU its twin, in which ``rte.lut.major``, ``rte.lut.minor`` and
``rte.lut.rayleigh`` nest) and ``rte.lut.planck`` (LW sources).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..gas_concs import GasConcs
from ..ops.cuda.lut_gas_optics import lut_optics_lw, lut_optics_sw
from ..ops.gas_optics_lut import compute_col_gas
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..sources import SourceFuncLW, SourceFuncSW
from ..utils.timing import span
from .kdist import KDist
from .nn_gas_optics import get_col_dry, interp_tlev
from .planck import compute_planck_source_nn


def _col_gas(kd: KDist, play, plev, gas_desc: GasConcs, col_dry):
    """The column amounts, dry air first (from the h2o VMR where
    ``col_dry`` is None)."""
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", *play.shape), plev)
    return compute_col_gas(kd, gas_desc, col_dry)


def gas_optics_lw_lut(kd: KDist, play, plev, tlay, tsfc, gas_desc: GasConcs,
                      col_dry: Optional[torch.Tensor] = None,
                      tlev: Optional[torch.Tensor] = None, top_at_1: bool = True,
                      save_pfrac: bool = False):
    """LW LUT gas optics -> (OpticalProps1scl, SourceFuncLW)."""
    with span("rte.lut.interp"):
        if tlev is None:
            tlev = interp_tlev(tlay, play, plev)
        col_gas = _col_gas(kd, play, plev, gas_desc, col_dry)
    with span("rte.lut.optics"):
        tau, pfrac = lut_optics_lw(kd, play, tlay, col_gas)
    with span("rte.lut.planck"):
        lay, lev, sfc, sfc_jac = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, kd.spectral,
                                                          kd.planck, top_at_1=top_at_1)
    sources = SourceFuncLW(lay_source=lay, lev_source=lev, sfc_source=sfc,
                           sfc_source_jac=sfc_jac, spectral=kd.spectral,
                           planck_frac=pfrac if save_pfrac else None)
    return OpticalProps1scl(tau, kd.spectral), sources


def gas_optics_sw_lut(kd: KDist, play, plev, tlay, gas_desc: GasConcs,
                      col_dry: Optional[torch.Tensor] = None, tsi: Optional[float] = None):
    """SW LUT gas optics -> (OpticalProps2str, SourceFuncSW): tau =
    absorption + Rayleigh, ssa = Rayleigh / total, g = 0 (reference
    combine_2str, mo_gas_optics_kernels.F90:1170-1272)."""
    ncol = play.shape[0]
    with span("rte.lut.interp"):
        col_gas = _col_gas(kd, play, plev, gas_desc, col_dry)
    with span("rte.lut.optics"):
        tau, ssa = lut_optics_sw(kd, play, tlay, col_gas)
    props = OpticalProps2str(tau, ssa, torch.zeros_like(tau), kd.spectral)
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
