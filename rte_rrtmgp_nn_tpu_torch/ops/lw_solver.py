"""Longwave no-scattering broadband solver, layer-major, single angle.

Port of the "presrc" path of rte_rrtmgp_nn_tpu/ops/lw_solver.py
(``lw_solver_noscat_lay_major``). Reference parity:
rte/kernels/mo_rte_solver_kernels.F90 ``lw_solver_noscat`` (:119-330) and
``lw_source_noscat`` (:742-776; Clough 1992 Eq 13 with the series
expansion below tau_thresh, or the Pade form under use_Pade_source).

Canonical top-at-0 orientation; fields are (nlay, ncol, ngpt) and the
returned broadband fluxes (ncol, nlay+1). The layer recurrences are Python
loops over layers with the spectral sum taken at each level.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import config, tau_thresh_for
from .expfast import exp_maybe_fast

# Diffusivity secant and weight of the single-angle solve (Clough et al.
# 1992 Table 2; reference rte/mo_rte_lw.F90:113-125).
LW_DIFFUSIVITY = 1.66
LW_WEIGHT = 0.5


class LWSolution(NamedTuple):
    """Broadband fluxes (ncol, nlay+1) [W/m2], level 0 = top of domain."""

    flux_up: torch.Tensor
    flux_dn: torch.Tensor


def source_fact(tl: torch.Tensor, trans: torch.Tensor, tau_thresh: float) -> torch.Tensor:
    """The linear-in-tau source factor: (1-T)/tau - T above the threshold,
    the 2nd-order Taylor form below it (mo_rte_solver_kernels.F90:
    174-186)."""
    big = tl > tau_thresh
    return torch.where(
        big,
        (1.0 - trans) / torch.where(big, tl, 1.0) - trans,
        tl * (0.5 - (1.0 / 3.0) * tl),
    )


def noscat_sources(tl, trans, lay, lev_t, lev_b, tau_thresh):
    """(src_dn, src_up) for the no-scattering transport: the linear-in-tau
    form, or the Pade form when config.use_pade_source."""
    one_m_t = 1.0 - trans
    if config.use_pade_source:
        coeff = 0.2 * tl
        denom = 1.0 + coeff
        return (one_m_t * (lay + coeff * lev_b) / denom,
                one_m_t * (lay + coeff * lev_t) / denom)
    two_fact = 2.0 * source_fact(tl, trans, tau_thresh)
    return (one_m_t * lev_b + two_fact * (lay - lev_b),
            one_m_t * lev_t + two_fact * (lay - lev_t))


def lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source,
                        weight=LW_WEIGHT) -> LWSolution:
    """The two broadband layer sweeps from precomputed (nlay, ncol, ngpt)
    transmittance and sources, with zero incident flux: down, then surface
    reflection + emission, then up; the spectral sum is taken at every
    level (reference transport loops, mo_rte_solver_kernels.F90:264-330)."""
    nlay = trans.shape[0]
    two_pi_w = 2.0 * np.pi * weight
    rad = torch.zeros_like(trans[0])
    dn = [rad.sum(-1)]
    for l in range(nlay):
        rad = trans[l] * rad + src_dn[l]
        dn.append(rad.sum(-1))
    rad = rad * (1.0 - sfc_emis) + sfc_emis * sfc_source
    up = [rad.sum(-1)]
    for l in range(nlay - 1, -1, -1):
        rad = trans[l] * rad + src_up[l]
        up.append(rad.sum(-1))
    flux_dn = torch.stack(dn, dim=1) * two_pi_w
    flux_up = torch.stack(up[::-1], dim=1) * two_pi_w
    return LWSolution(flux_up, flux_dn)


def lw_solver_noscat_lay_major(
    tau: torch.Tensor,
    lay_source: torch.Tensor,
    lev_source: torch.Tensor,
    sfc_emis: torch.Tensor,
    sfc_source: torch.Tensor,
) -> LWSolution:
    """Layer-major broadband no-scattering solve (single angle, zero
    incident flux, canonical top-at-0): tau/lay_source (nlay, ncol, ngpt),
    lev_source (nlay+1, ncol, ngpt), surface arrays (ncol, ngpt). The
    transmittance and both sources are computed once over the whole field,
    then the two sweeps run. Returns broadband (ncol, nlay+1) fluxes."""
    tau_thresh = tau_thresh_for(tau.dtype)
    tl = tau * LW_DIFFUSIVITY
    trans = exp_maybe_fast(-tl)
    src_dn, src_up = noscat_sources(
        tl, trans, lay_source, lev_source[:-1], lev_source[1:], tau_thresh)
    return lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source)
