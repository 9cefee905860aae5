"""Shortwave solvers: the direct beam and two-stream + adding.

Port of rte_rrtmgp_nn_tpu/ops/sw_solver.py: the column-major general
solvers ``sw_solver_noscat`` and ``sw_solver_2stream`` (spectral or
broadband, both orientations) and the layer-major broadband path of the
staged RFMIP core. Reference parity: rte/kernels/mo_rte_solver_kernels.F90
``sw_solver_noscat`` (:496-532), ``sw_solver_2stream`` (:541-692) built on
``sw_two_stream_source`` (:1364-1480: PIFM/Zdunkowski gammas, the ecRAD
single-precision-safe forms with the Rdir/Tdir clamps of :1467-1469 and
the k_min floor of :76-82) and the adding method (:1526-1637).

The direct beam is exp(-cumsum(tau/mu0)), the closed form of the layer
recurrence. Canonical top-at-0 inside; layer-major fields are (nlay, ncol,
ngpt), column-major ones (ncol, nlay, ngpt).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import config
from .adding import adding
from .expfast import exp_fast


# elements of a float32 field whose float64 two-stream coefficients are
# computed in one piece (pifm_coefficients): the RFMIP problem, 1800 x 60 x
# 112, is one; a GCM block, 57,600 x 60 x 112, is taken two layers at a time
COEFF_CHUNK = 1 << 24


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


def direct_beam(tau, mu0, inc_flux_dir, *, fast_exp: bool):
    """direct_beam_lay_major for column-major tau (ncol, nlay, ngpt):
    returns (ncol, nlay+1, ngpt)."""
    return direct_beam_lay_major(tau.transpose(0, 1), mu0, inc_flux_dir,
                                 fast_exp=fast_exp).transpose(0, 1)


def sw_solver_noscat(tau, mu0, inc_flux, top_at_1=True) -> torch.Tensor:
    """Direct beam only (reference sw_solver_noscat, :496-532): tau (ncol,
    nlay, ngpt), mu0 (ncol,), inc_flux (ncol, ngpt) TOA flux before the mu0
    weighting. Returns the spectral direct flux (ncol, nlay+1, ngpt)."""
    if not top_at_1:
        tau = tau.flip(1)
    flux_dir = direct_beam(tau, mu0, inc_flux * mu0[:, None], fast_exp=config.fast_exponential)
    return flux_dir if top_at_1 else flux_dir.flip(1)


def sw_two_stream_source(tau, ssa, g, mu0, sfc_alb_dir, flux_dn_dir):
    """PIFM two-stream coefficients and direct-beam sources, column-major
    and canonical top-at-0 (reference sw_two_stream_source, :1364-1480):
    flux_dn_dir (ncol, nlay+1, ngpt) the direct beam. Returns (rdif, tdif,
    source_up, source_dn, source_sfc)."""
    rdif, tdif, rdir, tdir = pifm_coefficients(
        tau, ssa, g, mu0[:, None, None], fast_exp=config.fast_exponential, dim=1)
    dir_inc = flux_dn_dir[:, :-1]
    return rdif, tdif, rdir * dir_inc, tdir * dir_inc, flux_dn_dir[:, -1] * sfc_alb_dir


def pifm_eigenvalue(ssa, g):
    """(gamma1, gamma2, k): the Zdunkowski PIFM gammas and the two-stream
    eigenvalue k = sqrt((gamma1 - gamma2) * (gamma1 + gamma2)), floored at
    config.k_min. The rdir / tdir of sw_two_stream_coeffs are 0/0 forms at
    k * mu0 = 1."""
    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    k = torch.sqrt(torch.clamp_min((gamma1 - gamma2) * (gamma1 + gamma2), config.k_min))
    return gamma1, gamma2, k


def pifm_coefficients(tau, ssa, g, mu0b, *, fast_exp: bool, dim: int = 0):
    """(rdif, tdif, rdir, tdir) of every SW route, as the fused SW kernel
    computes them: tau, ssa, g and mu0b cast to float64,
    sw_two_stream_coeffs there (float64's eps guards the k * mu0 = 1
    resonance, config.k_min floors k), each coefficient rounded once to
    tau's dtype. In float32 the 0/0 forms of rdir and tdir lose accuracy
    as 1 / |k * mu0 - 1| near the resonance, W/m2 in the fluxes (ROADMAP
    Queue 3 F1). mu0b and the others broadcast against tau. A field of
    more than COEFF_CHUNK elements is taken in chunks along ``dim`` (the
    layers), so that the float64 temporaries stay smaller than the float32
    ones of the whole field would be. Float64 inputs are computed as they
    are. ``fast_exp`` as sw_two_stream_coeffs."""
    if tau.dtype == torch.float64:
        return sw_two_stream_coeffs(tau, ssa, g, mu0b, fast_exp=fast_exp)[:4]
    fields = torch.broadcast_tensors(tau, ssa, g, mu0b)
    out = [torch.empty(fields[0].shape, dtype=tau.dtype, device=tau.device) for _ in range(4)]
    n = out[0].shape[dim]
    step = max(1, COEFF_CHUNK * n // max(out[0].numel(), 1))
    f64 = torch.float64
    for start in range(0, n, step):
        size = min(step, n - start)
        part = [a.narrow(dim, start, size).to(f64) for a in fields]
        coeffs = sw_two_stream_coeffs(*part, fast_exp=fast_exp)
        for o, c in zip(out, coeffs[:4]):
            o.narrow(dim, start, size).copy_(c)
    return tuple(out)


def sw_two_stream_coeffs(tau_l, ssa_l, g_l, mu0b, *, fast_exp: bool):
    """PIFM two-stream coefficients (rdif, tdif, rdir, tdir, tnoscat),
    elementwise in the inputs' precision, with that precision's eps as the
    resonance guard; mu0b broadcasts against tau_l. ``fast_exp`` takes the
    Pade exponential (config.fast_exponential). The SW routes call it
    through pifm_coefficients."""
    exp = exp_fast if fast_exp else torch.exp
    eps = torch.finfo(tau_l.dtype).eps
    mu0_inv = 1.0 / mu0b
    # Zdunkowski Practical Improved Flux Method coefficients.
    gamma1, gamma2, k = pifm_eigenvalue(ssa_l, g_l)
    gamma3 = (2.0 - 3.0 * mu0b * g_l) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3  # MW Eq 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4  # MW Eq 17
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
    rdif, tdif, rdir, tdir = pifm_coefficients(tau, ssa, g, mu0[:, None], fast_exp=fast)
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


def sw_solver_2stream(tau, ssa, g, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dif=None, top_at_1=True, scan_mode="sequential",
                      broadband=False) -> SWSolution:
    """Two-stream + adding (reference sw_solver_2stream), column-major:
    tau/ssa/g (ncol, nlay, ngpt), mu0 (ncol,), inc_flux (ncol, ngpt) TOA
    direct flux before the mu0 weighting, per-g-point surface albedos
    (ncol, ngpt). Spectral (ncol, nlay+1, ngpt) fluxes, or broadband
    (ncol, nlay+1) with ``broadband=True``: off the CPU one launch of K11
    (``ops/cuda/sw_2stream.py``), except under ``config.fast_exponential``."""
    if scan_mode not in ("sequential", "parallel"):
        raise ValueError(f"unknown scan mode {scan_mode!r}")
    if broadband and tau.device.type != "cpu" and not config.fast_exponential:
        from .cuda.sw_2stream import sw_2stream_broadband_kernel

        return SWSolution(*sw_2stream_broadband_kernel(
            tau, ssa, g, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif, inc_flux_dif,
            top_at_1=top_at_1))
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux)
    if not top_at_1:
        tau, ssa, g = tau.flip(1), ssa.flip(1), g.flip(1)
    inc_dir = inc_flux * mu0[:, None]
    if broadband:
        t = lambda a: a.transpose(0, 1)
        up, dn, dn_dir = sw_2stream_broadband(t(tau), t(ssa), t(g), mu0, inc_dir,
                                              sfc_alb_dir, sfc_alb_dif, inc_flux_dif)
    else:
        dn_dir = direct_beam(tau, mu0, inc_dir, fast_exp=config.fast_exponential)
        rdif, tdif, src_up, src_dn, src_sfc = sw_two_stream_source(
            tau, ssa, g, mu0, sfc_alb_dir, dn_dir)
        up, dn = adding(sfc_alb_dif, rdif, tdif, src_dn, src_up, src_sfc, inc_flux_dif,
                        mode=scan_mode)
        dn = dn + dn_dir  # adding gives the diffuse flux; total = diffuse + direct
    if not top_at_1:
        up, dn, dn_dir = up.flip(1), dn.flip(1), dn_dir.flip(1)
    return SWSolution(up, dn, dn_dir)
