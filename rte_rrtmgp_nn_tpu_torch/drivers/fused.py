"""The fused kernels' front: what K1 (``lw_clearsky_mega4``) and K2
(``sw_clearsky_megakernel``) are handed, clear sky or cloudy, for every
driver that takes them.

The kernels read their fields layer-major, top at index 0 and contiguous:
a driver's (ncol, nlay[+1]) field becomes (nlay[+1], ncol), flipped when
the driver's index 0 is the surface. ``lay_major_host`` lays out host
arrays so, ``lay_major`` tensors on the device.

``lw_args`` / ``sw_args`` build a kernel's positional arguments and its
cloud keywords from such inputs: (args, cloud keywords). ``lw_core`` /
``sw_core`` build them under the span ``rte.prep``, launch the kernel
under ``rte.kernel.lw`` / ``rte.kernel.sw`` and return the fluxes in the
caller's orientation. ``clouds`` picks the kernel's mode: None the clear
mode (no cloud keywords), else ``(cloud optics, (lwp, iwp, rel, rei))``
with the four fields layer-major. Lookup-table cloud optics go in as the
four fields and the packed tables (the kernel interpolates, delta-scales
for SW and expands band -> g-point itself); Pade cloud optics as band
properties computed here. On CPU tensors the kernels run their plain
twins.
"""
from __future__ import annotations

import numpy as np
import torch

from ..extensions.cloud_optics import cloud_optics
from ..fluxes import FluxesBroadband
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import (
    compute_nn_inputs_split,
    get_col_dry_lay_major,
    split_first_layer,
)
from ..ops.cuda.lw_megakernel import lw_clearsky_mega4
from ..ops.cuda.sw_megakernel import sw_clearsky_megakernel
from ..optical_props import delta_scale
from ..utils.timing import span


def lay_major_host(a, top_at_1: bool, dtype=np.float32) -> np.ndarray:
    """A host (ncol, nlay[+1]) array as the kernels read it: a contiguous
    (nlay[+1], ncol) top-at-0 numpy array in ``dtype``."""
    a = np.asarray(a, dtype)
    if not top_at_1:
        a = a[:, ::-1]
    return np.ascontiguousarray(a.T)


def lay_major(a: torch.Tensor, top_at_1: bool) -> torch.Tensor:
    """``lay_major_host`` of an (ncol, nlay[+1]) tensor, on its device."""
    return (a if top_at_1 else a.flip(1)).T.contiguous()


def fluxes(top_at_1: bool, up, dn, dn_dir) -> FluxesBroadband:
    """Top-at-0 (ncol, nlay+1) fluxes in the caller's orientation, with
    the net flux; ``dn_dir`` None for LW."""
    if not top_at_1:
        up, dn = up.flip(1), dn.flip(1)
        dn_dir = None if dn_dir is None else dn_dir.flip(1)
    return FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=dn_dir)


def gas_columns(play_t, plev_t, concs_t):
    """(the gases of the layer-major gas dict ``concs_t``, the dry-air
    column amounts (nlay, ncol))."""
    gas_desc = GasConcs(concs_t)
    nlay, ncol = play_t.shape
    return gas_desc, get_col_dry_lay_major(gas_desc.get_vmr("h2o", nlay, ncol), plev_t)


def _net_inputs(model, play_t, plev_t, tlay_t, concs_t):
    """What K1 and K2 both take of the atmosphere: (the dry-air column
    amounts, the scaled lanes stacked to one (nlay, ncol, n2d) tensor, the
    const block, the lane permutation (compute_nn_inputs_split))."""
    gas_desc, col_dry = gas_columns(play_t, plev_t, concs_t)
    lanes, const_feats, perm = compute_nn_inputs_split(play_t, tlay_t, gas_desc, model)
    return col_dry, torch.stack(lanes, dim=-1), const_feats, perm


def lw_tail(planck_table, spectral, tlev_t, tsfc, emis_band) -> tuple:
    """The arguments K1 ends on, in its stacked and its raw-lane mode:
    (tlev_t, tsfc, the Planck table, the band of each g-point, the surface
    emissivity per g-point)."""
    return (tlev_t, tsfc, planck_table, spectral.gpt2band_tensor(tlev_t.device),
            spectral.expand(emis_band).contiguous())


def lw_args(models, planck_table, spectral, play_t, plev_t, tlay_t, tlev_t, tsfc, emis_band,
            concs_t, clouds=None):
    """K1's (positional arguments, cloud keywords) from layer-major
    top-at-0 inputs; Pade clouds go in as their band absorption tau."""
    col_dry, x2d, const_feats, perm = _net_inputs(models[0], play_t, plev_t, tlay_t, concs_t)
    w1a, w1c = split_first_layer(models[0], perm, x2d.shape[-1])
    cloud_kw = {}
    if clouds is not None:
        co, fields = clouds
        if co.is_lut:
            cloud_kw = dict(cld_fields=tuple(fields), cld_lut=co.lut_pack)
        else:
            cloud_kw = dict(cld_tau_band=cloud_optics(co, *fields, as_2str=False).tau.contiguous())
    return ((models[0], x2d, const_feats, w1a, w1c, col_dry, tlay_t,
             *lw_tail(planck_table, spectral, tlev_t, tsfc, emis_band)), cloud_kw)


def lw_core(models, planck_table, spectral, play_t, plev_t, tlay_t, tlev_t, tsfc, emis_band,
            concs_t, clouds=None, *, top_at_1: bool) -> FluxesBroadband:
    """LW fluxes through K1 on ``lw_args``' inputs; ``top_at_1`` only
    orients the output."""
    with span("rte.prep"):
        args, cloud_kw = lw_args(models, planck_table, spectral, play_t, plev_t, tlay_t, tlev_t,
                                 tsfc, emis_band, concs_t, clouds)
    with span("rte.kernel.lw"):
        up, dn = lw_clearsky_mega4(*args, **cloud_kw)
    # the kernel's inputs are freed before its outputs are flipped and combined
    del args, cloud_kw
    return fluxes(top_at_1, up, dn, None)


def sw_boundary(spectral, solar, alb_dir, alb_dif) -> tuple:
    """``sw_args``' (toa, alb_dir, alb_dif) from one solar source per
    g-point and surface albedos per band (ncol, nband), as the all-sky
    drivers pose them, under the span ``rte.prep``."""
    with span("rte.prep"):
        toa = solar[None, :].expand(alb_dir.shape[0], spectral.ngpt)
        return toa, spectral.expand(alb_dir).contiguous(), spectral.expand(alb_dif).contiguous()


def sw_args(models, spectral, play_t, plev_t, tlay_t, mu0, toa, alb_dir, alb_dif, concs_t,
            clouds=None):
    """K2's (positional arguments, cloud keywords) from layer-major
    top-at-0 inputs: ``models`` the absorption and Rayleigh nets, ``mu0``
    (ncol,), ``toa`` the TOA source and ``alb_dir`` / ``alb_dif`` the
    surface albedos per g-point (ncol, ngpt). ``spectral`` is read only for
    clouds (their band -> g-point index). Pade clouds go in as the three
    delta-scaled band products."""
    col_dry, x2d, const_feats, perm = _net_inputs(models[0], play_t, plev_t, tlay_t, concs_t)
    cloud_kw = {}
    if clouds is not None:
        co, fields = clouds
        cloud_kw = dict(gpt2band=spectral.gpt2band_tensor(play_t.device))
        if co.is_lut:
            cloud_kw.update(cld_fields=tuple(fields), cld_lut=co.lut_pack)
        else:
            cld = delta_scale(cloud_optics(co, *fields, as_2str=True))
            tauscat = cld.tau * cld.ssa
            cloud_kw.update(cld_bands=(cld.tau.contiguous(), tauscat.contiguous(),
                                       (tauscat * cld.g).contiguous()))
    return ((models[0], models[1], x2d, const_feats, perm, col_dry, mu0,
             (toa * mu0[:, None]).contiguous(), alb_dir, alb_dif), cloud_kw)


def sw_core(models, spectral, play_t, plev_t, tlay_t, mu0, toa, alb_dir, alb_dif, concs_t,
            clouds=None, *, top_at_1: bool) -> FluxesBroadband:
    """SW fluxes through K2 on ``sw_args``' inputs; ``top_at_1`` only
    orients the output."""
    with span("rte.prep"):
        args, cloud_kw = sw_args(models, spectral, play_t, plev_t, tlay_t, mu0, toa, alb_dir,
                                 alb_dif, concs_t, clouds)
    with span("rte.kernel.sw"):
        up, dn, dn_dir = sw_clearsky_megakernel(*args, **cloud_kw)
    # the kernel's inputs are freed before its outputs are flipped and combined
    del args, cloud_kw
    return fluxes(top_at_1, up, dn, dn_dir)
