"""Adding method for diffuse transport (Shonk & Hogan 2008).

Port of rte_rrtmgp_nn_tpu/ops/adding.py (reference ``adding``,
rte/kernels/mo_rte_solver_kernels.F90:1526-1637, shared by the LW and SW
two-stream solvers). Canonical orientation: layer 0 at the top, the surface
below layer nlay-1. ``sequential`` mirrors the reference's two sweeps;
``parallel`` evaluates the surface-to-top sweep as a log-depth suffix
combination of slab operators and the downward flux sweep as a parallel
affine scan.
"""
from __future__ import annotations

import torch

from .scan import affine_scan, associative_scan


def _albedo_src(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc):
    """Surface-to-top sweep (SH08 Eqs 9-11): cumulative albedo and
    upwelling source at every level, (ncol, nlay+1, ngpt) each."""
    nlay = rdif.shape[1]
    alb, src = [albedo_sfc], [src_sfc]
    for l in range(nlay - 1, -1, -1):
        a_b, s_b = alb[-1], src[-1]
        r, t = rdif[:, l], tdif[:, l]
        denom = 1.0 / (1.0 - r * a_b)  # Eq 10
        alb.append(r + t * t * a_b * denom)  # Eq 9
        src.append(src_up[:, l] + t * denom * (s_b + a_b * src_dn[:, l]))  # Eq 11
    return torch.stack(alb[::-1], dim=1), torch.stack(src[::-1], dim=1)


def _combine_slabs(below, above):
    """Slab ``above`` on top of the stack ``below``, each (Rt, Rb, T, Su,
    Sd): reflectance to illumination from above and from below,
    transmittance, and the source leaving the top and the bottom."""
    rtb, rbb, tb, sub, sdb = below
    rta, rba, ta, sua, sda = above
    d = 1.0 / (1.0 - rba * rtb)
    rt = rta + ta * ta * rtb * d
    rb = rbb + tb * tb * rba * d
    t = ta * tb * d
    su = sua + ta * d * (sub + rtb * sda)
    sd = sdb + tb * d * (sda + rba * sub)
    return rt, rb, t, su, sd


def _albedo_src_parallel(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc):
    """_albedo_src as a log-depth suffix combination of slab operators. A
    single two-stream layer is symmetric (Rt = Rb = rdif), a combined stack
    is not, so both reflectances are carried for the rule to stay
    associative. The suffix stack from layer l to the surface gives (Rt,
    Su) = (albedo, src) at level l; the surface is a slab with Rt =
    albedo_sfc, T = 0, Su = src_sfc."""
    zeros = torch.zeros_like(albedo_sfc)[:, None]
    cat = lambda lay, sfc: torch.cat([lay, sfc], dim=1)
    slabs = (cat(rdif, albedo_sfc[:, None]), cat(rdif, zeros), cat(tdif, zeros),
             cat(src_up, src_sfc[:, None]), cat(src_dn, zeros))
    rt, _, _, su, _ = associative_scan(_combine_slabs, slabs, axis=1, reverse=True)
    return rt, su


def adding(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc, flux_dn_top,
           mode: str = "sequential", broadband: bool = False):
    """Diffuse flux_up / flux_dn at all levels. albedo_sfc, src_sfc,
    flux_dn_top (ncol, ngpt); rdif, tdif, src_dn, src_up (ncol, nlay,
    ngpt). Returns (flux_up, flux_dn), each (ncol, nlay+1, ngpt), or their
    spectral sums (ncol, nlay+1) with ``broadband=True`` (there the
    downward sweep is sequential in both modes, as in the JAX package)."""
    if mode == "parallel":
        albedo, src = _albedo_src_parallel(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc)
    elif mode == "sequential":
        albedo, src = _albedo_src(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc)
    else:
        raise ValueError(f"unknown scan mode {mode!r}")
    # denom (beta in SH08, Eq 10) uses the albedo below each layer
    denom = 1.0 / (1.0 - rdif * albedo[:, 1:])
    # SH08 Eq 13: flux_dn[l+1] = (tdif flux_dn[l] + rdif src[l+1] + src_dn) * denom
    flux_dn = affine_scan(tdif * denom, (rdif * src[:, 1:] + src_dn) * denom, flux_dn_top,
                          axis=1, mode="sequential" if broadband else mode)
    flux_up = flux_dn * albedo + src  # SH08 Eq 12
    if broadband:
        return flux_up.sum(-1), flux_dn.sum(-1)
    return flux_up, flux_dn
