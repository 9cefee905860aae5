"""All-sky (clouds + gases) example driver.

Port of rte_rrtmgp_nn_tpu/drivers/allsky.py (reference
examples/all-sky/rrtmgp_allsky.F90: a Garand atmosphere replicated to ncol
columns; idealized cloud placement, clouds in 2/3 of the columns between
100 and 900 hPa, liquid where T > 263 K and ice where T < 273 K, lwp = iwp
= 10 g/m2, effective radii at the middle of the valid range, :329-350;
cloud optics -> (SW) delta-scale -> increment into the gas optical props ->
solver; SW albedo 0.06, mu0 = 0.86, LW emissivity 0.98, :280-304). Gas
optics is the NN path.

The route is taken once per call by ``config.driver_route``:
  - "megakernel" (one angle, float32, nets the fused kernels take):
    ``fused.lw_core`` / ``fused.sw_core`` (``drivers/fused.py``) in a
    cloud mode, on canonical layer-major inputs. With lookup-table cloud
    optics the cloud fields (lwp, iwp, rel, rei) go into the fused kernel,
    which does the table interpolation, the delta scaling, the band ->
    g-point expansion and the increment itself; with Pade cloud optics the
    band-resolved cloud properties are computed by the front and go in as
    band lanes. On CUDA tensors
    that is one launch of K1 or K2 in a cloud mode; on CPU tensors their
    plain twins;
  - "staged" LW: on CUDA, and for more than one angle or a parallel-scan
    request anywhere, ``_allsky_lw_core`` (NN gas optics through the MLP
    kernel, ``increment`` by band, then ``rte_lw``: the transport kernel
    once for all its angles, or spectral log-depth scans for
    ``scan_mode="parallel"``); on the
    CPU with one angle ``_allsky_lw_core_lay_major``, whose sweeps are
    PyTorch ops (the oracle of the fused core, not a CUDA route);
  - "staged" SW: ``_allsky_sw_core_lay_major`` (the MLP kernel, then the
    two-stream coefficients and the adding sweeps in PyTorch), or for
    ``scan_mode="parallel"`` ``_allsky_sw_core`` (the general path with the
    log-depth adding);
  - "refuse": NotImplementedError with the reason (float64 on CUDA, a net
    the MLP kernel does not take).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import driver_route
from ..extensions.cloud_optics import CloudOptics, cloud_optics, load_cloud_optics
from ..fluxes import FluxesBroadband, reduce_broadband
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import (
    compute_nn_inputs,
    gas_optics_lw_nn,
    gas_optics_sw_nn,
    get_col_dry_lay_major,
    predict_nn_lw,
    predict_nn_sw,
)
from ..gasoptics.planck import (
    PlanckTable,
    compute_planck_source_nn,
    lw_spectral_g128,
    spectral_for,
    sw_spectral_g112,
)
from ..models.network import NNModel
from ..ops.lw_solver import lw_solver_noscat_lay_major
from ..ops.sw_solver import sw_solver_2stream_lay_major
from ..optical_props import OpticalProps1scl, OpticalProps2str, delta_scale, increment
from ..rte import rte_lw, rte_sw
from ..spectral import SpectralMapping
from . import fused
from .allsky_io import GarandAtmosphere  # noqa: F401 (re-export)
from .allsky_io import read_garand
from .rfmip import _check_sw_scaling, _to_lay_major, solar_source_on
from .rfmip import resolve_solar_source  # noqa: F401 (re-export)

# Idealized cloud-placement thresholds (reference rrtmgp_allsky.F90:329-350).
CLOUD_P_MIN = 100.0 * 100.0   # Pa
CLOUD_P_MAX = 900.0 * 100.0   # Pa
CLOUD_T_LIQ = 263.0           # K: liquid where tlay > this
CLOUD_T_ICE = 273.0           # K: ice where tlay < this


def make_clouds(play, tlay, co: CloudOptics, cloud_col=None):
    """Idealized cloud fields (reference rrtmgp_allsky.F90:329-350) from
    play/tlay (ncol, nlay), numpy arrays or tensors: (lwp, iwp, rel, rei).
    ``cloud_col`` optionally gives the per-column "may hold cloud" mask
    (default: two columns of every three, by 1-based column index)."""
    is_t = torch.is_tensor(play)
    ncol, nlay = play.shape
    if cloud_col is None:
        icol = (torch.arange(ncol, device=play.device) if is_t else np.arange(ncol))[:, None] + 1
        cloud_col = (icol % 3) != 0
    else:
        cloud_col = cloud_col > 0.5
        if cloud_col.ndim == 1:
            cloud_col = cloud_col[:, None]
    cloud_mask = (play > CLOUD_P_MIN) & (play < CLOUD_P_MAX) & cloud_col
    rel_val = 0.5 * (co.min_radius_liq + co.max_radius_liq)
    rei_val = 0.5 * (co.min_radius_ice + co.max_radius_ice)
    where = (lambda c, v: c.to(play.dtype) * v) if is_t else (lambda c, v: np.where(c, v, 0.0))
    lwp = where(cloud_mask & (tlay > CLOUD_T_LIQ), 10.0)
    iwp = where(cloud_mask & (tlay < CLOUD_T_ICE), 10.0)
    rel = where(lwp > 0.0, rel_val)
    rei = where(iwp > 0.0, rei_val)
    return lwp, iwp, rel, rei


def cloud_fields_lay_major(play, tlay, co: CloudOptics, top_at_1: bool, device,
                           dtype=torch.float32):
    """make_clouds on host arrays play/tlay (ncol, nlay), as the fused
    cores take the fields: four contiguous (nlay, ncol) top-at-0 tensors on
    ``device``."""
    return tuple(torch.as_tensor(fused.lay_major_host(a, top_at_1), dtype=dtype, device=device)
                 for a in make_clouds(np.asarray(play), np.asarray(tlay), co))


def _allsky_lw_core(
    models, table, spectral, cloud_co,
    play, plev, tlay, tlev, tsfc, emis_band, lwp, iwp, rel, rei, concs,
    top_at_1, n_gauss_angles, scan_mode="sequential",
):
    """General all-sky LW core, column-major: NN gas optics, cloud
    absorption added by band (``increment``), then rte_lw with
    ``n_gauss_angles`` Gauss angles. Sequential requests solve broadband
    (the transport kernel on CUDA); a parallel-scan request solves
    spectrally with log-depth scans and reduces afterwards, as the JAX core
    does (the broadband solve does not read ``scan_mode``)."""
    tau, sources = gas_optics_lw_nn(
        models, play, plev, tlay, tsfc, GasConcs(concs), spectral, table,
        tlev=tlev, top_at_1=top_at_1)
    clouds = cloud_optics(cloud_co, lwp, iwp, rel, rei, as_2str=False)
    atmos = increment(OpticalProps1scl(tau, spectral), clouds)
    if scan_mode == "sequential":
        sol = rte_lw(atmos, top_at_1, sources, emis_band, n_gauss_angles=n_gauss_angles,
                     broadband=True)
        return FluxesBroadband(flux_up=sol.flux_up, flux_dn=sol.flux_dn,
                               flux_net=sol.flux_dn - sol.flux_up)
    sol = rte_lw(atmos, top_at_1, sources, emis_band, n_gauss_angles=n_gauss_angles,
                 scan_mode=scan_mode)
    return reduce_broadband(sol.flux_up, sol.flux_dn)


def _allsky_sw_core(
    models, spectral, solar, cloud_co,
    play, plev, tlay, mu0, sfc_alb_dir, sfc_alb_dif, lwp, iwp, rel, rei, concs,
    top_at_1, scan_mode="sequential",
):
    """General all-sky SW core, column-major: NN gas optics (g = 0), cloud
    optics delta-scaled and incremented by band, then rte_sw. allsky_sw
    takes it for parallel-scan requests, which solve spectrally with the
    log-depth adding and reduce afterwards, as the JAX core does; a
    sequential call solves broadband."""
    tau, ssa, toa_src = gas_optics_sw_nn(models, play, plev, tlay, GasConcs(concs),
                                         spectral, solar)
    atmos = OpticalProps2str(tau, ssa, torch.zeros_like(tau), spectral)
    clouds = delta_scale(cloud_optics(cloud_co, lwp, iwp, rel, rei, as_2str=True))
    atmos = increment(atmos, clouds)
    alb_dir, alb_dif = spectral.expand(sfc_alb_dir), spectral.expand(sfc_alb_dif)
    if scan_mode == "sequential":
        sol = rte_sw(atmos, top_at_1, mu0, toa_src, alb_dir, alb_dif, broadband=True)
        return FluxesBroadband(flux_up=sol.flux_up, flux_dn=sol.flux_dn,
                               flux_net=sol.flux_dn - sol.flux_up,
                               flux_dn_dir=sol.flux_dn_dir)
    sol = rte_sw(atmos, top_at_1, mu0, toa_src, alb_dir, alb_dif, scan_mode=scan_mode)
    return reduce_broadband(sol.flux_up, sol.flux_dn, gpt_flux_dn_dir=sol.flux_dn_dir)


def _flip_all(top_at_1, *arrs):
    return arrs if top_at_1 else tuple(a.flip(1) for a in arrs)


def _allsky_lw_core_lay_major(
    models, table, spectral, cloud_co,
    play, plev, tlay, tlev, tsfc, emis_band, lwp, iwp, rel, rei, concs,
    top_at_1,
):
    """Layer-major all-sky LW core: the cloud absorption tau is expanded
    band -> g-point and added to the gas tau before the broadband solve,
    whose sweeps are PyTorch ops. Same numbers as _allsky_lw_core."""
    ncol, nlay = play.shape
    play, plev, tlay, tlev, lwp, iwp, rel, rei = _flip_all(
        top_at_1, play, plev, tlay, tlev, lwp, iwp, rel, rei)
    gd_t = _to_lay_major(GasConcs(concs), ncol, nlay, top_at_1)
    col_dry_t = get_col_dry_lay_major(gd_t.get_raw("h2o"), plev.T)
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, pfrac = predict_nn_lw(models, x, col_dry_t)
    lay_src, lev_src, sfc_src, _ = compute_planck_source_nn(
        pfrac, tlay.T, tlev.T, tsfc, spectral, table, top_at_1=True, lay_axis=0)
    cld = cloud_optics(cloud_co, lwp.T, iwp.T, rel.T, rei.T, as_2str=False)
    tau = tau + spectral.expand(cld.tau)
    sol = lw_solver_noscat_lay_major(tau, lay_src, lev_src, spectral.expand(emis_band), sfc_src)
    return fused.fluxes(top_at_1, sol.flux_up, sol.flux_dn, None)


def _allsky_sw_core_lay_major(
    models, spectral, solar, cloud_co,
    play, plev, tlay, mu0, sfc_alb_dir, sfc_alb_dif, lwp, iwp, rel, rei, concs,
    top_at_1,
):
    """Layer-major all-sky SW core: the delta-scaled cloud two-stream
    properties are combined with the (g = 0) gas ones in the g-point domain
    (inc_2stream_by_2stream_bybnd, mo_optical_props_kernels.F90:269-305,
    without the zero gas-asymmetry terms) before the broadband solve. Same
    numbers as _allsky_sw_core. Honors fast_exponential."""
    ncol, nlay = play.shape
    play, plev, tlay, lwp, iwp, rel, rei = _flip_all(
        top_at_1, play, plev, tlay, lwp, iwp, rel, rei)
    gd_t = _to_lay_major(GasConcs(concs), ncol, nlay, top_at_1)
    col_dry_t = get_col_dry_lay_major(gd_t.get_raw("h2o"), plev.T)
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, ssa = predict_nn_sw(models, x, col_dry_t)  # gas: g = 0

    cld = delta_scale(cloud_optics(cloud_co, lwp.T, iwp.T, rel.T, rei.T, as_2str=True))
    eps = torch.finfo(tau.dtype).eps
    tau_c = spectral.expand(cld.tau)
    ssa_c = spectral.expand(cld.ssa)
    g_c = spectral.expand(cld.g)
    tau12 = tau + tau_c
    tauscat12 = tau * ssa + tau_c * ssa_c
    g12 = (tau_c * ssa_c * g_c) / torch.clamp_min(tauscat12, eps)
    ssa12 = tauscat12 / torch.clamp_min(tau12, eps)

    toa_src = solar[None, :].expand(ncol, spectral.ngpt)
    sol = sw_solver_2stream_lay_major(
        tau12, ssa12, g12, mu0, toa_src, spectral.expand(sfc_alb_dir),
        spectral.expand(sfc_alb_dif))
    return fused.fluxes(top_at_1, sol.flux_up, sol.flux_dn, sol.flux_dn_dir)


def canonicalize_allsky_inputs(
    play, plev, tlay, tlev, lwp, iwp, rel, rei, gas_concs, top_at_1,
    dtype=np.float32,
):
    """Host-side layout canonicalization for the fused-kernel cores: every
    (ncol, nlay[+1]) field becomes a contiguous (nlay[+1], ncol) top-at-0
    numpy array, and every gas VMR is materialized to layer-major 2-D.
    Returns ((play_t, plev_t, tlay_t, tlev_t, lwp_t, iwp_t, rel_t, rei_t),
    concs_t)."""
    canon = lambda a: fused.lay_major_host(a, top_at_1, dtype)
    ncol, nlay = np.asarray(play).shape
    fields = tuple(canon(a) for a in (play, plev, tlay, tlev, lwp, iwp, rel, rei))
    concs_t = {name: canon(gas_concs.get_vmr(name, ncol, nlay).cpu().numpy())
               for name in gas_concs.concs}
    return fields, concs_t


def _canonical_tensors(atm, clouds, top_at_1, device, dtype):
    """canonicalize_allsky_inputs moved to ``device``: (the eight fields,
    concs_t)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    fields, concs_t = canonicalize_allsky_inputs(
        atm.play, atm.plev, atm.tlay, atm.tlev, *clouds, atm.gas_concs, top_at_1)
    return tuple(t(a) for a in fields), {k: t(v) for k, v in concs_t.items()}


def _staged_tensors(atm, clouds, device, dtype):
    """The staged cores' inputs on ``device``, in the file's orientation:
    (play, plev, tlay, tlev, the four cloud fields, concs)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    fields = tuple(t(a) for a in (atm.play, atm.plev, atm.tlay, atm.tlev, *clouds))
    return fields, {k: v.to(device=device, dtype=dtype)
                    for k, v in atm.gas_concs.concs.items()}


def allsky_lw(
    garand_path: str,
    cloud_optics_path: str,
    models: Sequence[NNModel],
    ncol: int = 128,
    spectral: Optional[SpectralMapping] = None,
    n_gauss_angles: int = 1,
    scan_mode: str = "sequential",
    dtype=torch.float32,
    *,
    device,
) -> FluxesBroadband:
    """Full all-sky LW run on ``device`` (reference rrtmgp_allsky LW
    branch); ``models`` must be on ``device``. ``spectral`` defaults to
    the g-128 mapping; nets that do not fit it, or the mapping passed,
    raise ValueError (planck.spectral_for). The mapping's Planck table is
    kept per band limits, device and dtype (``PlanckTable.kept``).
    Returns (ncol, nlay+1) fluxes on ``device``."""
    spectral = spectral_for("lw", models, entry="allsky_lw", accepts=(lw_spectral_g128,),
                            spectral=spectral)
    device = torch.device(device)
    route = driver_route("allsky_lw", lw=True, models=models, device=device, dtype=dtype,
                         n_gauss_angles=n_gauss_angles, scan_mode=scan_mode)
    atm = read_garand(garand_path, ncol)
    co = load_cloud_optics_checked(cloud_optics_path, device=device, dtype=dtype)
    table = PlanckTable.kept(spectral.band_lims_wvn_array, device=device, dtype=dtype)
    clouds = make_clouds(atm.play, atm.tlay, co)

    top_at_1 = bool(atm.play[0, 0] < atm.play[0, -1])
    tsfc = torch.as_tensor(atm.tlev[:, -1 if top_at_1 else 0], dtype=dtype, device=device)
    emis = torch.full((ncol, spectral.nband), 0.98, dtype=dtype, device=device)

    if route == "megakernel":
        (play_t, plev_t, tlay_t, tlev_t, *cld_t), concs_t = _canonical_tensors(
            atm, clouds, top_at_1, device, dtype)
        return fused.lw_core(models, table, spectral, play_t, plev_t, tlay_t, tlev_t, tsfc,
                             emis, concs_t, (co, cld_t), top_at_1=top_at_1)
    (play, plev, tlay, tlev, *cld), concs = _staged_tensors(atm, clouds, device, dtype)
    if n_gauss_angles == 1 and scan_mode == "sequential" and device.type == "cpu":
        return _allsky_lw_core_lay_major(models, table, spectral, co, play, plev, tlay, tlev,
                                         tsfc, emis, *cld, concs, top_at_1=top_at_1)
    return _allsky_lw_core(models, table, spectral, co, play, plev, tlay, tlev, tsfc, emis,
                           *cld, concs, top_at_1=top_at_1, n_gauss_angles=n_gauss_angles,
                           scan_mode=scan_mode)


def allsky_sw(
    garand_path: str,
    cloud_optics_path: str,
    models: Sequence[NNModel],
    ncol: int = 128,
    spectral: Optional[SpectralMapping] = None,
    kdist=None,
    solar_source: Optional[np.ndarray] = None,
    scan_mode: str = "sequential",
    dtype=torch.float32,
    *,
    device,
) -> FluxesBroadband:
    """Full all-sky SW run on ``device`` (reference rrtmgp_allsky SW
    branch); ``models`` = [absorption, rayleigh], on ``device``.
    ``spectral`` defaults to the g-112 mapping; nets that do not fit it,
    or the mapping passed, raise ValueError (planck.spectral_for). The
    solar source is ``solar_source`` when given, else the ``kdist``'s,
    both made at every call, else the mapping's default source kept per
    mapping, device and dtype (``rfmip.solar_source_on``)."""
    spectral = spectral_for("sw", models, entry="allsky_sw", accepts=(sw_spectral_g112,),
                            spectral=spectral)
    device = torch.device(device)
    route = driver_route("allsky_sw", models=models, device=device, dtype=dtype,
                         scan_mode=scan_mode)
    atm = read_garand(garand_path, ncol)
    co = load_cloud_optics_checked(cloud_optics_path, device=device, dtype=dtype)
    solar = solar_source_on(spectral, kdist, solar_source, device, dtype)
    clouds = make_clouds(atm.play, atm.tlay, co)

    top_at_1 = bool(atm.play[0, 0] < atm.play[0, -1])
    mu0 = torch.full((ncol,), 0.86, dtype=dtype, device=device)
    alb = torch.full((ncol, spectral.nband), 0.06, dtype=dtype, device=device)

    if route == "megakernel":
        _check_sw_scaling(models)
        (play_t, plev_t, tlay_t, _, *cld_t), concs_t = _canonical_tensors(
            atm, clouds, top_at_1, device, dtype)
        return fused.sw_core(models, spectral, play_t, plev_t, tlay_t, mu0,
                             *fused.sw_boundary(spectral, solar, alb, alb), concs_t, (co, cld_t),
                             top_at_1=top_at_1)
    (play, plev, tlay, _, *cld), concs = _staged_tensors(atm, clouds, device, dtype)
    if scan_mode == "sequential":
        return _allsky_sw_core_lay_major(models, spectral, solar, co, play, plev, tlay, mu0,
                                         alb, alb, *cld, concs, top_at_1=top_at_1)
    return _allsky_sw_core(models, spectral, solar, co, play, plev, tlay, mu0, alb, alb,
                           *cld, concs, top_at_1=top_at_1, scan_mode=scan_mode)


def load_cloud_optics_checked(path: str, *, device, dtype=torch.float32) -> CloudOptics:
    return load_cloud_optics(path, dtype=dtype, device=device)
