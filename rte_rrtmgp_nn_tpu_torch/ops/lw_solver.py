"""Longwave solvers.

Port of rte_rrtmgp_nn_tpu/ops/lw_solver.py: the column-major general
solver ``lw_solver_noscat`` (1-4 Gauss angles or per-g-point secants,
incident flux, surface-temperature Jacobian, Tang-2018 rescaling for
scattering optical properties, both orientations, spectral or broadband
output), which every staged LW driver call takes; the layer-major
single-angle broadband solver (``lw_solver_noscat_lay_major``, the
"presrc" variant of the CPU all-sky core; K7 on CUDA); the two-stream
solver with scattering (``lw_solver_2stream``); and the broadband solve
straight from the Planck fraction (``lw_noscat_broadband_from_pfrac``).
Reference parity:
rte/kernels/mo_rte_solver_kernels.F90 ``lw_solver_noscat`` (:119-330),
``lw_solver_noscat_GaussQuad`` (:332-415), ``lw_solver_2stream``
(:426-486), ``lw_source_noscat`` (:742-776; Clough 1992 Eq 13 with the
series expansion below tau_thresh, or the Pade form under
use_Pade_source), ``lw_two_stream`` (:1018-1069), ``lw_source_2str``
(:1112-1162), the rescaled transport ``lw_transport_1rescl`` (:1729-1795
with Cn = 0.4*wb/scaleTau, :211-233); the Gauss quadrature of
rte/mo_rte_lw.F90:113-125.

Orientation is canonicalized to top-at-0 by flipping. The layer
recurrences are Python loops over layers; on CUDA the broadband transport
of all the angles of a call is one kernel launch (ops/cuda/lw_solver.py,
K7), except under ``fast_exponential``, the Pade source or the Jacobian,
which the kernel does not take (the JAX package's conditions), and the
rescaled solve, which is spectral.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import config, cuda_dtype_refusal, tau_thresh_for
from .adding import adding
from .expfast import exp_fast, exp_maybe_fast, exp_rational_f64
from .scan import affine_scan, affine_scan_reverse

# Gauss quadrature secants and weights, Clough et al. 1992 Table 2
# (reference rte/mo_rte_lw.F90:113-125). Row n-1 holds the n-angle set.
GAUSS_DS = np.array([
    [1.66, 0.0, 0.0, 0.0],  # diffusivity angle
    [1.18350343, 2.81649655, 0.0, 0.0],
    [1.09719858, 1.69338507, 4.70941630, 0.0],
    [1.06056257, 1.38282560, 2.40148179, 7.15513024],
])
GAUSS_WTS = np.array([
    [0.5, 0.0, 0.0, 0.0],
    [0.3180413817, 0.1819586183, 0.0, 0.0],
    [0.2009319137, 0.2292411064, 0.0698269799, 0.0],
    [0.1355069134, 0.2034645680, 0.1298475476, 0.0311809710],
])
# The single-angle solve (diffusivity secant and its weight).
LW_DIFFUSIVITY = float(GAUSS_DS[0, 0])
LW_WEIGHT = float(GAUSS_WTS[0, 0])


class LWSolution(NamedTuple):
    """Fluxes [W/m2], level 0 = top of domain: spectral (ncol, nlay+1,
    ngpt) or broadband (ncol, nlay+1). flux_up_jac is the
    surface-temperature Jacobian of the upward flux, when requested;
    flux_dn_jac is then exactly zero (the no-scattering down flux never
    sees the surface)."""

    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_up_jac: Optional[torch.Tensor] = None
    flux_dn_jac: Optional[torch.Tensor] = None


def transmittance(tl: torch.Tensor) -> torch.Tensor:
    """exp(-tl) taken in float64 and rounded once to tl's dtype, as the
    transport kernels take it (K1, K6, K7): CUDA's float32 exp is high by
    ~0.1 ulp on average, a bias that the g-point sums and the sweeps
    accumulate (ROADMAP Queue 3 F7). A float64 tl on the CPU takes the
    exponential as the JAX package's float64 chain rounds it there
    (``exp_rational_f64``): the source factor's cancellation makes one ulp
    of it ~1e-8 of the down flux near the top of the atmosphere. On the
    card a float64 twin is a reference, and the card's exp serves."""
    if tl.dtype == torch.float64 and tl.device.type == "cpu":
        return exp_rational_f64(-tl)
    return torch.exp(-tl.double()).to(tl.dtype)


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


def noscat_sources(tl, trans, lay, lev_t, lev_b, tau_thresh, pade: Optional[bool] = None):
    """(src_dn, src_up) for the no-scattering transport: the linear-in-tau
    form, or the Pade form when ``pade`` (None: config.use_pade_source)."""
    one_m_t = 1.0 - trans
    if config.use_pade_source if pade is None else pade:
        coeff = 0.2 * tl
        denom = 1.0 + coeff
        return (one_m_t * (lay + coeff * lev_b) / denom,
                one_m_t * (lay + coeff * lev_t) / denom)
    two_fact = 2.0 * source_fact(tl, trans, tau_thresh)
    return (one_m_t * lev_b + two_fact * (lay - lev_b),
            one_m_t * lev_t + two_fact * (lay - lev_t))


def pfrac_sources(tl, trans, pfrac, planck_lay_band, planck_lev_band, gpt_band,
                  pade: Optional[bool] = None):
    """noscat_sources straight from the Planck fraction, layer-major and
    canonical top-at-0: pfrac (nlay, ncol, ngpt), band Planck values (nlay,
    ncol, nband) and (nlay+1, ncol, nband), ``gpt_band`` (ngpt,) the band
    index of each g-point. The source at a layer's lower level takes the
    fraction of the layer below; the bottom layer takes its own."""
    b_lev = planck_lev_band[..., gpt_band]
    return noscat_sources(
        tl, trans, pfrac * planck_lay_band[..., gpt_band], pfrac * b_lev[:-1],
        torch.cat([pfrac[1:], pfrac[-1:]], dim=0) * b_lev[1:], tau_thresh_for(tl.dtype),
        pade=pade)


def lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux=None,
                        weight=LW_WEIGHT, sfc_source_jac=None) -> LWSolution:
    """The two broadband layer sweeps from precomputed (nlay, ncol, ngpt)
    transmittance and sources (any strides): down from the incident flux
    ``inc_flux`` (ncol, ngpt; None = 0), which starts the sweep as the
    radiance inc_flux / (2 pi weight), surface reflection and emission, then
    up; the spectral sum is taken at every level (reference transport loops,
    mo_rte_solver_kernels.F90:264-330). With ``sfc_source_jac`` the Jacobian
    rides the up sweep's transmittances. Returns broadband (ncol, nlay+1)
    fluxes. The JAX package's signature and meaning."""
    inc_rad = None if inc_flux is None else inc_flux / (2.0 * np.pi * weight)
    return _sweeps_from_radiance(trans, src_dn, src_up, sfc_emis, sfc_source, weight, inc_rad,
                                 sfc_source_jac)


def _sweeps_from_radiance(trans, src_dn, src_up, sfc_emis, sfc_source, weight, inc_rad,
                          sfc_source_jac) -> LWSolution:
    """lw_broadband_sweeps from the incident radiance ``inc_rad`` (ncol,
    ngpt; None = 0), for the callers that hold a radiance."""
    nlay = trans.shape[0]
    two_pi_w = 2.0 * np.pi * weight
    rad = torch.zeros_like(trans[0]) if inc_rad is None else inc_rad
    dn = [rad.sum(-1)]
    for l in range(nlay):
        rad = trans[l] * rad + src_dn[l]
        dn.append(rad.sum(-1))
    rad = rad * (1.0 - sfc_emis) + sfc_emis * sfc_source
    up = [rad.sum(-1)]
    jac = None if sfc_source_jac is None else sfc_emis * sfc_source_jac
    jacs = None if jac is None else [jac.sum(-1)]
    for l in range(nlay - 1, -1, -1):
        rad = trans[l] * rad + src_up[l]
        up.append(rad.sum(-1))
        if jac is not None:
            jac = trans[l] * jac
            jacs.append(jac.sum(-1))
    flux_dn = torch.stack(dn, dim=1) * two_pi_w
    flux_up = torch.stack(up[::-1], dim=1) * two_pi_w
    flux_up_jac = None if jacs is None else torch.stack(jacs[::-1], dim=1) * two_pi_w
    return LWSolution(flux_up, flux_dn, flux_up_jac)


def lw_solver_noscat_lay_major(
    tau: torch.Tensor,
    lay_source: torch.Tensor,
    lev_source: torch.Tensor,
    sfc_emis: torch.Tensor,
    sfc_source: torch.Tensor,
    inc_flux: Optional[torch.Tensor] = None,
    lw_ds: Optional[torch.Tensor] = None,
    sfc_source_jac: Optional[torch.Tensor] = None,
) -> LWSolution:
    """Layer-major broadband no-scattering solve (single angle, canonical
    top-at-0): tau/lay_source (nlay, ncol, ngpt), lev_source (nlay+1, ncol,
    ngpt), surface arrays (ncol, ngpt), the incident flux ``inc_flux``
    (ncol, ngpt; None = 0), per-(column, g-point) secants ``lw_ds`` (ncol,
    ngpt; None = the diffusivity secant 1.66) and the surface source's
    temperature derivative ``sfc_source_jac`` (ncol, ngpt), which adds
    flux_up_jac. Returns broadband (ncol, nlay+1) fluxes.

    CPU tensors take the PyTorch path (``lw_solver_noscat_lay_major_plain``).
    On CUDA a float32 solve under the transport kernel's conditions (exact
    exponential, linear-in-tau source, no Jacobian) is one launch of K7's
    angles mode, which reads the layer-major fields through their strides;
    with the Jacobian, ``fast_exponential`` or the Pade source it takes the
    PyTorch path, as ``rte_lw`` does. Any other dtype on CUDA raises."""
    refusal = cuda_dtype_refusal(tau.device, tau.dtype)
    if refusal:
        raise NotImplementedError(f"lw_solver_noscat_lay_major: {refusal}")
    if (tau.device.type == "cpu" or sfc_source_jac is not None or config.fast_exponential
            or config.use_pade_source):
        return lw_solver_noscat_lay_major_plain(tau, lay_source, lev_source, sfc_emis,
                                                sfc_source, inc_flux, lw_ds, sfc_source_jac)
    from .cuda.lw_solver import lw_noscat_broadband_angles

    col_major = lambda a: a.transpose(0, 1)
    contig = lambda a: None if a is None else a.contiguous()
    secants = [LW_DIFFUSIVITY] if lw_ds is None else contig(lw_ds.to(tau.dtype))
    flux_up, flux_dn = lw_noscat_broadband_angles(
        col_major(tau), col_major(lay_source), col_major(lev_source), contig(sfc_emis),
        contig(sfc_source), secants, [LW_WEIGHT], contig(inc_flux))
    return LWSolution(flux_up, flux_dn)


def lw_solver_noscat_lay_major_plain(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                     inc_flux=None, lw_ds=None,
                                     sfc_source_jac=None) -> LWSolution:
    """lw_solver_noscat_lay_major in PyTorch operations on any device, with
    the configured numerics (JAX ops/lw_solver.py ``_lw_noscat_broadband_presrc``):
    the transmittance and both sources computed once over the whole field,
    then the two sweeps."""
    tl = tau * (LW_DIFFUSIVITY if lw_ds is None else lw_ds.to(tau.dtype)[None])
    trans = exp_maybe_fast(-tl)
    src_dn, src_up = noscat_sources(
        tl, trans, lay_source, lev_source[:-1], lev_source[1:], tau_thresh_for(tau.dtype))
    return lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux,
                               LW_WEIGHT, sfc_source_jac)


def lw_source_noscat(tau_loc, trans, lay_source, lev_source):
    """Layer sources (canonical top-at-0) from the optical path and its
    transmittance, column-major (ncol, nlay, ngpt): (source_dn exiting the
    layer bottom, source_up exiting its top)."""
    return noscat_sources(tau_loc, trans, lay_source, lev_source[:, :-1],
                          lev_source[:, 1:], tau_thresh_for(tau_loc.dtype))


def noscat_broadband_1angle(tau, lay_source, lev_source, sfc_emis, sfc_source, D, weight,
                            inc_rad=None, sfc_source_jac=None, *, fast_exp: bool,
                            pade: bool) -> LWSolution:
    """Broadband no-scattering solve of one angle, column-major and
    canonical top-at-0: tau/lay_source (ncol, nlay, ngpt), lev_source
    (ncol, nlay+1, ngpt), secants D (ncol, ngpt), incident radiance
    ``inc_rad`` (ncol, ngpt). ``fast_exp`` and ``pade`` select the
    exponential and the source form. Returns broadband (ncol, nlay+1)
    fluxes."""
    tl = tau * D[:, None, :]
    trans = exp_fast(-tl) if fast_exp else transmittance(tl)
    src_dn, src_up = noscat_sources(tl, trans, lay_source, lev_source[:, :-1],
                                    lev_source[:, 1:], tau_thresh_for(tau.dtype), pade=pade)
    lay_major = lambda a: a.transpose(0, 1)
    return _sweeps_from_radiance(lay_major(trans), lay_major(src_dn), lay_major(src_up),
                                 sfc_emis, sfc_source, weight, inc_rad, sfc_source_jac)


def _lw_noscat_broadband_fused(tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
                               D, weight, sfc_source_jac=None) -> LWSolution:
    """The broadband solve of one angle where the transport kernel does not
    apply (fast_exponential or the Jacobian): the JAX package's own
    non-kernel path, with the configured numerics."""
    return noscat_broadband_1angle(
        tau, lay_source, lev_source, sfc_emis, sfc_source, D, weight,
        inc_flux / (2.0 * np.pi * weight), sfc_source_jac,
        fast_exp=config.fast_exponential, pade=config.use_pade_source)


def _lw_solver_noscat_1angle(tau, lay_source, lev_source, sfc_emis, sfc_source, inc_flux,
                             D, weight, sfc_source_jac=None, ssa=None, g=None,
                             do_rescaling=False, scan_mode="sequential",
                             broadband=False) -> LWSolution:
    """Single-angle no-scattering solve, canonical top-at-0: tau (ncol,
    nlay, ngpt), D (ncol, ngpt) secants, weight a scalar. Spectral fluxes,
    or broadband with ``broadband=True`` (not with rescaling). With
    ``do_rescaling`` the optical path is scaled by the scattering (ssa, g)
    and the up and down radiances adjust each other (Tang et al. 2018)."""
    two_pi_w = 2.0 * np.pi * weight
    if broadband and not do_rescaling and not config.use_pade_source:
        return _lw_noscat_broadband_fused(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                          inc_flux, D, weight, sfc_source_jac)

    if do_rescaling:
        # reference mo_rte_solver_kernels.F90:211-233
        wb = ssa * (1.0 - g) * 0.5
        scale_tau = 1.0 - ssa + wb
        cn = 0.4 * wb / scale_tau
        tau_loc = tau * D[:, None, :] * scale_tau
        trans = torch.exp(-tau_loc)
        an = 1.0 - trans * trans
    else:
        tau_loc = tau * D[:, None, :]
        trans = exp_maybe_fast(-tau_loc)
    source_dn, source_up = lw_source_noscat(tau_loc, trans, lay_source, lev_source)
    rad_top = inc_flux / two_pi_w
    if broadband and not do_rescaling:
        return lw_broadband_sweeps(trans.transpose(0, 1), source_dn.transpose(0, 1),
                                   source_up.transpose(0, 1), sfc_emis, sfc_source, inc_flux,
                                   weight, sfc_source_jac)

    rad_dn = affine_scan(trans, source_dn, rad_top, axis=1, mode=scan_mode)
    rad_sfc = rad_dn[:, -1] * (1.0 - sfc_emis) + sfc_emis * sfc_source  # reference :269
    if do_rescaling:
        # up with the adjustment from the down radiances, then a second
        # down pass adjusted from the up radiances (lw_transport_1rescl)
        adj_up = cn * (an * rad_dn[:, :-1] - trans * source_dn - source_up)
        rad_up = affine_scan_reverse(trans, source_up + adj_up, rad_sfc, axis=1, mode=scan_mode)
        adj_dn = cn * (an * rad_up[:, :-1] - trans * source_up - source_dn)
        rad_dn = affine_scan(trans, source_dn + adj_dn, rad_top, axis=1, mode=scan_mode)
    else:
        rad_up = affine_scan_reverse(trans, source_up, rad_sfc, axis=1, mode=scan_mode)
    flux_up_jac = None
    if sfc_source_jac is not None:
        # the Jacobian propagates with transmission only: the product of
        # trans from the surface upward
        jac_sfc = sfc_emis * sfc_source_jac
        if config.fast_exponential and not do_rescaling:
            # exp_fast(a)*exp_fast(b) != exp_fast(a+b): ride the same
            # per-layer Pade transmittances as the fluxes
            prod_up = trans.flip(1).cumprod(1).flip(1)
        else:
            prod_up = torch.exp(-tau_loc.flip(1).cumsum(1).flip(1))
        flux_up_jac = torch.cat([prod_up * jac_sfc[:, None], jac_sfc[:, None]], dim=1) * two_pi_w
    return LWSolution(rad_up * two_pi_w, rad_dn * two_pi_w, flux_up_jac)


def lw_solver_noscat(
    tau,
    lay_source,
    lev_source,
    sfc_emis,
    sfc_source,
    inc_flux=None,
    top_at_1=True,
    n_gauss_angles=1,
    lw_ds=None,
    sfc_source_jac=None,
    ssa=None,
    g=None,
    do_rescaling=False,
    scan_mode="sequential",
    broadband=False,
) -> LWSolution:
    """No-scattering LW solve with first-order Gaussian quadrature
    (reference lw_solver_noscat_GaussQuad, mo_rte_solver_kernels.F90:
    332-415): column-major tau/lay_source (ncol, nlay, ngpt), lev_source
    (ncol, nlay+1, ngpt), surface arrays (ncol, ngpt). ``lw_ds`` (ncol,
    ngpt) gives per-g-point secants for a single angle (the optimal-angle
    path, mo_rte_lw.F90:329-341). The fluxes of several angles are the sum
    of the per-angle fluxes, each weighted by its Gauss weight. With
    ``do_rescaling`` (ssa, g given) each angle is the Tang-rescaled solve,
    which is spectral: ``broadband`` is then not honored."""
    ncol, _, ngpt = tau.shape
    dtype, dev = tau.dtype, tau.device
    broadband = broadband and not do_rescaling
    if lw_ds is None and not 1 <= n_gauss_angles <= 4:
        raise ValueError("n_gauss_angles must be in 1..4")
    if not top_at_1:
        tau, lay_source, lev_source = tau.flip(1), lay_source.flip(1), lev_source.flip(1)
        if ssa is not None:
            ssa, g = ssa.flip(1), g.flip(1)
    n = n_gauss_angles
    weights = [LW_WEIGHT] if lw_ds is not None else [float(w) for w in GAUSS_WTS[n - 1, :n]]

    if (broadband and not config.use_pade_source and not config.fast_exponential
            and sfc_source_jac is None):
        # the transport kernel's conditions, as in the JAX package: exact
        # exponential, linear-in-tau source, no Jacobian. One call takes every
        # angle; its wrapper launches the kernel once for CUDA tensors
        # (float32, or it raises) and runs its twin for CPU ones.
        from .cuda.lw_solver import lw_noscat_broadband_angles

        secants = (lw_ds.to(dtype) if lw_ds is not None
                   else [float(d) for d in GAUSS_DS[n - 1, :n]])
        flux_up, flux_dn = lw_noscat_broadband_angles(
            tau, lay_source, lev_source, sfc_emis, sfc_source, secants, weights, inc_flux)
        if not top_at_1:
            flux_up, flux_dn = flux_up.flip(1), flux_dn.flip(1)
        return LWSolution(flux_up, flux_dn)

    if inc_flux is None:
        inc_flux = torch.zeros((ncol, ngpt), dtype=dtype, device=dev)
    if lw_ds is not None:
        angles = [(lw_ds.to(dtype), LW_WEIGHT)]
    else:
        angles = [(torch.full((ncol, ngpt), float(GAUSS_DS[n - 1, i]), dtype=dtype, device=dev),
                   weights[i]) for i in range(n)]
    sols = [_lw_solver_noscat_1angle(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                     inc_flux, D, w, sfc_source_jac, ssa, g, do_rescaling,
                                     scan_mode, broadband)
            for D, w in angles]
    flux_up = sum(s.flux_up for s in sols)
    flux_dn = sum(s.flux_dn for s in sols)
    jac = None if sfc_source_jac is None else sum(s.flux_up_jac for s in sols)
    if not top_at_1:
        flux_up, flux_dn = flux_up.flip(1), flux_dn.flip(1)
        jac = None if jac is None else jac.flip(1)
    return LWSolution(flux_up, flux_dn, jac)


def lw_noscat_broadband_from_pfrac(tau, pfrac, planck_lay, planck_lev, planck_sfc,
                                   planck_sfc_jac, gpt2band, sfc_emis, inc_flux=None, D=None,
                                   weight=LW_WEIGHT, top_at_1=True,
                                   compute_jac=False) -> LWSolution:
    """Broadband no-scattering solve straight from the Planck fraction:
    tau, pfrac (ncol, nlay, ngpt); band Planck values planck_lay (ncol,
    nlay, nband), planck_lev (ncol, nlay+1, nband), planck_sfc[_jac] (ncol,
    nband); ``gpt2band`` (ngpt,) the band of each g-point (the JAX
    function's one-hot product is an index here); sfc_emis (ncol, ngpt).
    Level l takes the fraction of layer min(l, nlay-1) in the canonical
    orientation; the g-point sources are formed layer-major and go straight
    into the sweeps (compute_Planck_source_nn + lw_solver_noscat of the
    reference in one function)."""
    if not top_at_1:
        tau, pfrac = tau.flip(1), pfrac.flip(1)
        planck_lay, planck_lev = planck_lay.flip(1), planck_lev.flip(1)
    idx = gpt2band.long()
    lay_major = lambda a: a.transpose(0, 1)
    if D is None:
        D = torch.full_like(tau[:, 0], LW_DIFFUSIVITY)
    tl = lay_major(tau * D[:, None, :])
    trans = exp_maybe_fast(-tl)
    src_dn, src_up = pfrac_sources(tl, trans, lay_major(pfrac), lay_major(planck_lay),
                                   lay_major(planck_lev), idx)
    pf_sfc = pfrac[:, -1]
    sfc_source = pf_sfc * planck_sfc[..., idx]
    jac = pf_sfc * (planck_sfc_jac - planck_sfc)[..., idx] if compute_jac else None
    out = lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux, weight, jac)
    if not top_at_1:
        out = LWSolution(out.flux_up.flip(1), out.flux_dn.flip(1),
                         None if out.flux_up_jac is None else out.flux_up_jac.flip(1))
    return out


def lw_two_stream(tau, ssa, g):
    """Meador-Weaver diffuse reflectance and transmittance with the LW
    diffusivity secant 1.66 (reference lw_two_stream, :1018-1069). Returns
    (gamma1, gamma2, rdif, tdif)."""
    gamma1 = LW_DIFFUSIVITY * (1.0 - 0.5 * ssa * (1.0 + g))  # Fu et al. Eq 2.9
    gamma2 = LW_DIFFUSIVITY * 0.5 * ssa * (1.0 - g)  # Fu et al. Eq 2.10
    k = torch.sqrt(torch.clamp_min((gamma1 - gamma2) * (gamma1 + gamma2), config.k_min))
    e1 = exp_maybe_fast(-tau * k)
    e2 = e1 * e1
    rt_term = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt_term * gamma2 * (1.0 - e2)  # MW Eq 25
    tdif = rt_term * 2.0 * k * e1  # MW Eq 26
    return gamma1, gamma2, rdif, tdif


def lw_source_2str(sfc_emis, sfc_source, lay_source, lev_source, gamma1, gamma2, rdif, tdif,
                   tau):
    """Toon et al. 1989 two-stream sources (canonical top-at-0; reference
    lw_source_2str, :1112-1162). The factor pi converts radiance to flux.
    ``lay_source`` is not read, as in the reference. Returns (source_dn,
    source_up, source_sfc)."""
    lev_top, lev_bot = lev_source[:, :-1], lev_source[:, 1:]
    big = tau > 1.0e-8
    z = torch.where(big, (lev_bot - lev_top) / torch.where(big, tau * (gamma1 + gamma2), 1.0),
                    0.0)
    zup_top, zup_bot = z + lev_top, z + lev_bot
    zdn_top, zdn_bot = -z + lev_top, -z + lev_bot
    source_up = torch.where(big, np.pi * (zup_top - rdif * zdn_top - tdif * zup_bot), 0.0)
    source_dn = torch.where(big, np.pi * (zdn_bot - rdif * zup_bot - tdif * zdn_top), 0.0)
    return source_dn, source_up, np.pi * sfc_emis * sfc_source


def lw_solver_2stream(tau, ssa, g, lay_source, lev_source, sfc_emis, sfc_source,
                      inc_flux=None, top_at_1=True, scan_mode="sequential") -> LWSolution:
    """Two-stream LW with scattering (reference lw_solver_2stream,
    :426-486): column-major (ncol, nlay, ngpt) optical properties, spectral
    fluxes."""
    if inc_flux is None:
        inc_flux = torch.zeros_like(tau[:, 0])
    if not top_at_1:
        tau, ssa, g = tau.flip(1), ssa.flip(1), g.flip(1)
        lay_source, lev_source = lay_source.flip(1), lev_source.flip(1)
    gamma1, gamma2, rdif, tdif = lw_two_stream(tau, ssa, g)
    source_dn, source_up, source_sfc = lw_source_2str(
        sfc_emis, sfc_source, lay_source, lev_source, gamma1, gamma2, rdif, tdif, tau)
    flux_up, flux_dn = adding(1.0 - sfc_emis, rdif, tdif, source_dn, source_up, source_sfc,
                              inc_flux, mode=scan_mode)
    if not top_at_1:
        flux_up, flux_dn = flux_up.flip(1), flux_dn.flip(1)
    return LWSolution(flux_up, flux_dn)
