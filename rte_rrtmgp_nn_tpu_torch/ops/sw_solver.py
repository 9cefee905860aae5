"""Shortwave two-stream broadband solver, layer-major.

Port of the layer-major broadband path of rte_rrtmgp_nn_tpu/ops/
sw_solver.py. Reference parity: rte/kernels/mo_rte_solver_kernels.F90
``sw_solver_2stream`` (:541-692) built on ``sw_two_stream_source``
(:1364-1480: PIFM/Zdunkowski gammas, the ecRAD single-precision-safe forms
with the Rdir/Tdir clamps of :1467-1469 and the k_min floor of :76-82) and
the adding method (:1526-1637).

The direct beam is exp(-cumsum(tau/mu0)), the closed form of the layer
recurrence. Canonical top-at-0; fields (nlay, ncol, ngpt).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import config
from .expfast import exp_fast


class SWSolution(NamedTuple):
    """Broadband fluxes (ncol, nlay+1) [W/m2]. flux_dn is the TOTAL
    downward flux (diffuse + direct); flux_dn_dir the direct beam alone."""

    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_dn_dir: torch.Tensor


def direct_beam_lay_major(tau, mu0, inc_flux_dir, *, fast_exp: bool):
    """Direct-beam flux at every level: tau (nlay, ncol, ngpt), mu0 (ncol,),
    inc_flux_dir (ncol, ngpt) already times mu0 -> (nlay+1, ncol, ngpt).
    ``fast_exp`` takes the Pade exponential (config.fast_exponential)."""
    mu0_inv = (1.0 / mu0)[None, :, None]
    if fast_exp:
        # per-layer Pade transmittances multiplied down the column: the
        # reference's FAST_EXPONENTIAL recurrence (:520-526)
        atten = torch.cumprod(exp_fast(-tau * mu0_inv), dim=0)
    else:
        atten = torch.exp(-torch.cumsum(tau * mu0_inv, dim=0))
    top = inc_flux_dir[None]
    return torch.cat([top, top * atten], dim=0)


def sw_two_stream_coeffs(tau_l, ssa_l, g_l, mu0b, *, fast_exp: bool):
    """PIFM two-stream coefficients (rdif, tdif, rdir, tdir, tnoscat),
    elementwise; mu0b broadcasts against tau_l. ``fast_exp`` takes the Pade
    exponential (config.fast_exponential)."""
    exp = exp_fast if fast_exp else torch.exp
    eps = torch.finfo(tau_l.dtype).eps
    mu0_inv = 1.0 / mu0b
    # Zdunkowski Practical Improved Flux Method coefficients.
    gamma1 = (8.0 - ssa_l * (5.0 + 3.0 * g_l)) * 0.25
    gamma2 = 3.0 * (ssa_l * (1.0 - g_l)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0b * g_l) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3  # MW Eq 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4  # MW Eq 17
    k = torch.sqrt(torch.clamp_min((gamma1 - gamma2) * (gamma1 + gamma2), config.k_min))
    tnoscat = exp(-tau_l * mu0_inv)
    e1 = exp(-tau_l * k)
    e2 = e1 * e1
    k2e = 2.0 * k * e1
    # arranged to avoid rounding error when k and gamma1 differ in magnitude
    rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt_term * gamma2 * (1.0 - e2)  # MW Eq 25
    tdif = rt_term * k2e  # MW Eq 26
    k_mu = k * mu0b
    k_mu2 = k_mu * k_mu
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    # divide by (1 - k_mu^2) guarded by eps (the resonance k*mu0 == 1)
    one_m = 1.0 - k_mu2
    denom = torch.where(torch.abs(one_m) >= eps, one_m, eps)
    rt2 = ssa_l * rt_term / denom
    # MW Eq 14 (reflectance to direct beam), ecRAD arrangement
    rdir = rt2 * (
        (1.0 - k_mu) * (alpha2 + k_g3)
        - (1.0 + k_mu) * (alpha2 - k_g3) * e2
        - k2e * (gamma3 - alpha2 * mu0b) * tnoscat
    )
    # MW Eq 15 (diffuse transmittance of direct beam), direct part omitted
    tdir = rt2 * (
        k2e * (gamma4 + alpha1 * mu0b)
        - tnoscat * ((1.0 + k_mu) * (alpha1 + k_g4) - (1.0 - k_mu) * (alpha1 - k_g4) * e2)
    )
    # energy-safety clamps (reference :1467-1469)
    rdir = torch.minimum(torch.clamp_min(rdir, 0.0), 1.0 - tnoscat)
    tdir = torch.minimum(torch.clamp_min(tdir, 0.0), 1.0 - tnoscat - rdir)
    return rdif, tdif, rdir, tdir, tnoscat


def sw_2stream_broadband(tau, ssa, g, mu0, inc_flux_dir, sfc_alb_dir,
                         sfc_alb_dif, inc_flux_dif):
    """Broadband SW two-stream + adding, layer-major (canonical top-at-0).

    tau/ssa/g (nlay, ncol, ngpt); mu0 (ncol,); inc_flux_dir (ncol, ngpt)
    already times mu0; albedos and inc_flux_dif (ncol, ngpt). Returns
    (bb_up, bb_dn_total, bb_dir), each (ncol, nlay+1)."""
    fast = config.fast_exponential
    rdif, tdif, rdir, tdir, _ = sw_two_stream_coeffs(tau, ssa, g, mu0[:, None], fast_exp=fast)
    return sw_adding_broadband(rdif, tdif, rdir, tdir, tau, mu0, inc_flux_dir,
                               sfc_alb_dir, sfc_alb_dif, inc_flux_dif, fast_exp=fast)


def sw_adding_broadband(rdif, tdif, rdir, tdir, tau, mu0, inc_flux_dir,
                        sfc_alb_dir, sfc_alb_dif, inc_flux_dif, *, fast_exp: bool):
    """The direct beam and the two adding sweeps from precomputed two-stream
    coefficients (nlay, ncol, ngpt); other arguments as
    sw_2stream_broadband, ``fast_exp`` as direct_beam_lay_major."""
    nlay = tau.shape[0]
    dir_levels = direct_beam_lay_major(tau, mu0, inc_flux_dir, fast_exp=fast_exp)
    bb_dir = dir_levels.sum(-1).T
    src_up = rdir * dir_levels[:-1]
    src_dn = tdir * dir_levels[:-1]

    # surface-to-top sweep: cumulative albedo and upwelling source; keep
    # the carry BELOW each layer for the downward sweep
    alb = sfc_alb_dif
    src = dir_levels[-1] * sfc_alb_dir
    alb_below = [None] * nlay
    src_below = [None] * nlay
    for l in range(nlay - 1, -1, -1):
        alb_below[l], src_below[l] = alb, src
        d = 1.0 / (1.0 - rdif[l] * alb)
        alb, src = (rdif[l] + tdif[l] * tdif[l] * alb * d,
                    src_up[l] + tdif[l] * d * (src + alb * src_dn[l]))
    alb_top, src_top = alb, src

    # top-to-surface flux sweep with the spectral sums at each level
    fdn = inc_flux_dif
    dn = [inc_flux_dif.sum(-1) + bb_dir[:, 0]]
    up = [(inc_flux_dif * alb_top + src_top).sum(-1)]
    for l in range(nlay):
        d = 1.0 / (1.0 - rdif[l] * alb_below[l])
        fdn = (tdif[l] * fdn + rdif[l] * src_below[l] + src_dn[l]) * d
        fup = fdn * alb_below[l] + src_below[l]
        dn.append(fdn.sum(-1) + dir_levels[l + 1].sum(-1))
        up.append(fup.sum(-1))
    return torch.stack(up, dim=1), torch.stack(dn, dim=1), bb_dir


def sw_solver_2stream_lay_major(tau, ssa, g, mu0, inc_flux, sfc_alb_dir,
                                sfc_alb_dif, inc_flux_dif=None) -> SWSolution:
    """Layer-major broadband SW two-stream + adding (canonical top-at-0):
    tau/ssa/g (nlay, ncol, ngpt), inc_flux (ncol, ngpt) TOA flux before the
    mu0 weighting, surface arrays (ncol, ngpt). Returns broadband
    (ncol, nlay+1) fluxes (up, dn_total, dn_dir)."""
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux)
    return SWSolution(*sw_2stream_broadband(
        tau, ssa, g, mu0, inc_flux * mu0[:, None], sfc_alb_dir, sfc_alb_dif,
        inc_flux_dif))
