"""RFMIP clear-sky drivers: the end-to-end LW and SW paths.

Port of rte_rrtmgp_nn_tpu/drivers/rfmip.py (reference
examples/rfmip-clear-sky/rrtmgp_rfmip_lw.F90 and rrtmgp_rfmip_sw.F90: NN
gas optics then the RTE solver; SW renormalizes the TOA source to the TSI
(:407-427), masks night columns by sza >= 90 deg and zeroes their fluxes
after the solve (:455-459)).

Two cores per direction, chosen by ``config.resolve_use_megakernel``:
  - the fused-kernel cores (``_lw_core_mega4_canon``,
    ``_sw_core_mega_canon``) on canonical layer-major inputs, which launch
    the CUDA kernels for CUDA tensors (and run their plain twins for CPU
    tensors);
  - the staged plain cores (``_lw_core_lay_major``, ``_sw_core_lay_major``),
    CPU only.
On CUDA the drivers run the kernels or raise NotImplementedError naming
the kernel or module still to be ported; they never run plain code there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_use_megakernel
from ..fluxes import FluxesBroadband
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import (
    compute_nn_inputs,
    compute_nn_inputs_split,
    get_col_dry_lay_major,
    predict_nn_lw,
    predict_nn_sw,
    split_first_layer,
)
from ..gasoptics.planck import (
    PlanckTable,
    compute_planck_source_nn,
    gpt_weights_for,
    lw_spectral_g128,
    solar_band_fractions,
    sw_spectral_g112,
)
from ..models.network import NNModel
from ..ops.cuda.lw_megakernel import lw_clearsky_mega4
from ..ops.cuda.sw_megakernel import sw_clearsky_megakernel
from ..ops.lw_solver import lw_solver_noscat_lay_major
from ..ops.sw_solver import sw_solver_2stream_lay_major
from ..spectral import SpectralMapping
from .rfmip_io import RFMIPData


def default_solar_source(spectral: SpectralMapping, tsi: float = 1360.85) -> np.ndarray:
    """Per-g-point TOA solar flux [W/m2] summing to ``tsi``: band fractions
    of the brightness-temperature solar spectrum (calibrated for the 14
    standard SW bands), split within bands by the g-point quadrature
    weights."""
    frac = solar_band_fractions(spectral.band_lims_wvn_array)
    w = gpt_weights_for(spectral)
    out = np.zeros(spectral.ngpt)
    for ib, (s, e) in enumerate(spectral.band_lims_gpt):
        out[s:e] = tsi * frac[ib] * w[s:e]
    return out


def resolve_solar_source(spectral: SpectralMapping, kdist=None,
                         tsi: Optional[float] = None) -> np.ndarray:
    """Per-g-point TOA solar flux. Only the tier without a k-distribution
    is ported (``default_solar_source``)."""
    if kdist is not None:
        raise NotImplementedError(
            "solar source from a k-distribution: needs the LUT gas optics "
            "(ROADMAP Queue 1 item 8)")
    return default_solar_source(spectral, tsi=tsi or 1360.85)


def canonicalize_rfmip_inputs(data: RFMIPData, dtype=np.float32):
    """Host-side layer-major canonicalization for the fused-kernel cores:
    (ncol, nlay[+1]) fields become contiguous (nlay[+1], ncol) top-at-0
    numpy arrays, and per-layer (1-D) gas profiles are materialized to 2-D
    (scalars stay scalar). Returns (play_t, plev_t, tlay_t, tlev_t,
    concs_t)."""
    def canon(a):
        a = np.asarray(a, dtype)
        if not data.top_at_1:
            a = a[:, ::-1]
        return np.ascontiguousarray(a.T)

    concs_t = {}
    for name, raw in data.gas_concs.concs.items():
        r = np.asarray(raw, dtype)
        if r.ndim == 0:
            concs_t[name] = r
        elif r.ndim == 1:  # per-layer profile
            concs_t[name] = canon(np.broadcast_to(r[None, :], (data.ncol, r.shape[0])))
        else:
            concs_t[name] = canon(r)
    return (canon(data.play), canon(data.plev), canon(data.tlay),
            canon(data.tlev), concs_t)


def _stack_lanes(play_t, tlay_t, gas_desc, model):
    """Scaled lanes stacked to one (nlay, ncol, n2d) tensor, the const
    block and the lane permutation (compute_nn_inputs_split)."""
    lanes, const_feats, perm = compute_nn_inputs_split(play_t, tlay_t, gas_desc, model)
    return torch.stack(lanes, dim=-1), const_feats, perm


def lw_mega_args(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play_t, plev_t, tlay_t, tlev_t, tsfc, sfc_emis_band, concs_t,
):
    """The fused LW kernel's arguments (lw_clearsky_mega4) from canonical
    layer-major top-at-0 inputs (canonicalize_rfmip_inputs)."""
    gas_desc = GasConcs(concs_t)
    nlay, ncol = play_t.shape
    col_dry = get_col_dry_lay_major(gas_desc.get_vmr("h2o", nlay, ncol), plev_t)
    x2d, const_feats, perm = _stack_lanes(play_t, tlay_t, gas_desc, models[0])
    w1a, w1c = split_first_layer(models[0], perm, x2d.shape[-1])
    return (models[0], x2d, const_feats, w1a, w1c, col_dry, tlay_t, tlev_t, tsfc,
            planck_table, spectral.gpt2band_tensor(play_t.device),
            spectral.expand(sfc_emis_band).contiguous())


def _lw_core_mega4_canon(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play_t, plev_t, tlay_t, tlev_t, tsfc, sfc_emis_band, concs_t,
    top_at_1: bool,
):
    """LW core through the fused kernel, on canonical layer-major top-at-0
    inputs (canonicalize_rfmip_inputs); top_at_1 only flips the output."""
    up, dn = lw_clearsky_mega4(*lw_mega_args(
        models, planck_table, spectral, play_t, plev_t, tlay_t, tlev_t, tsfc,
        sfc_emis_band, concs_t))
    if not top_at_1:
        up, dn = up.flip(1), dn.flip(1)
    return FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up)


def _to_lay_major(gas_desc: GasConcs, ncol: int, nlay: int, top_at_1: bool) -> GasConcs:
    """Every gas broadcast to (ncol, nlay), flipped to top-at-0 and
    transposed to (nlay, ncol)."""
    out = {}
    for name in gas_desc.concs:
        full = gas_desc.get_vmr(name, ncol, nlay)
        if not top_at_1:
            full = full.flip(1)
        out[name] = full.T
    return GasConcs(out)


def _lw_core_lay_major(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
):
    """Staged layer-major LW core: NN inputs packed (nlay, ncol) so tau,
    pfrac and the Planck sources come out in the solver's layout. Single
    angle, broadband output. Honors fast_exponential and use_pade_source."""
    gas_desc = GasConcs(concs_dict)
    ncol, nlay = play.shape
    if not top_at_1:
        play, tlay, plev, tlev = play.flip(1), tlay.flip(1), plev.flip(1), tlev.flip(1)
    gd_t = _to_lay_major(gas_desc, ncol, nlay, top_at_1)
    col_dry_t = get_col_dry_lay_major(gd_t.get_raw("h2o"), plev.T)
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])  # (nlay, ncol, nf)
    tau, pfrac = predict_nn_lw(models, x, col_dry_t)
    lay_src, lev_src, sfc_src, _ = compute_planck_source_nn(
        pfrac, tlay.T, tlev.T, tsfc, spectral, planck_table, top_at_1=True)
    emis = spectral.expand(sfc_emis_band)
    sol = lw_solver_noscat_lay_major(tau, lay_src, lev_src, emis, sfc_src)
    up, dn = sol.flux_up, sol.flux_dn
    if not top_at_1:
        up, dn = up.flip(1), dn.flip(1)
    return FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up)


def _sw_masked(up, dn, dn_dir, usecol, top_at_1):
    """Flip to the caller's orientation and zero the night columns."""
    if not top_at_1:
        up, dn, dn_dir = up.flip(1), dn.flip(1), dn_dir.flip(1)
    mask = usecol[:, None]
    return FluxesBroadband(
        flux_up=torch.where(mask, up, 0.0),
        flux_dn=torch.where(mask, dn, 0.0),
        flux_net=torch.where(mask, dn - up, 0.0),
        flux_dn_dir=torch.where(mask, dn_dir, 0.0),
    )


def _sw_boundary(solar_source, tsi, sfc_alb, mu0, usecol):
    """(toa_src, alb_gpt, mu0_safe): the per-column TOA source renormalized
    to each column's TSI (reference rrtmgp_rfmip_sw.F90:407-427), the
    surface albedo per g-point, and mu0 with night columns set to 1."""
    ncol = tsi.shape[0]
    toa_src = solar_source[None, :].expand(ncol, solar_source.shape[0])
    toa_src = toa_src * (tsi / toa_src.sum(-1))[:, None]
    alb_gpt = sfc_alb[:, None] * torch.ones_like(toa_src)
    return toa_src, alb_gpt, torch.where(usecol, mu0, 1.0)


def sw_mega_args(
    models: Sequence[NNModel],
    solar_source,
    play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t,
):
    """The fused SW kernel's arguments (sw_clearsky_megakernel) from
    canonical layer-major top-at-0 inputs. Night columns get mu0 = 1."""
    gas_desc = GasConcs(concs_t)
    nlay, ncol = play_t.shape
    col_dry_t = get_col_dry_lay_major(gas_desc.get_vmr("h2o", nlay, ncol), plev_t)
    x2d, const_feats, perm = _stack_lanes(play_t, tlay_t, gas_desc, models[0])
    toa_src, alb_gpt, mu0_safe = _sw_boundary(solar_source, tsi, sfc_alb, mu0, usecol)
    return (models[0], models[1], x2d, const_feats, perm, col_dry_t, mu0_safe,
            toa_src * mu0_safe[:, None], alb_gpt, alb_gpt)


def _sw_core_mega_canon(
    models: Sequence[NNModel],
    solar_source,
    play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t,
    top_at_1: bool,
):
    """SW core through the fused kernel, on canonical layer-major top-at-0
    inputs. Night columns enter the kernel with mu0 = 1 and leave with
    zeroed fluxes."""
    up, dn, dn_dir = sw_clearsky_megakernel(*sw_mega_args(
        models, solar_source, play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi,
        concs_t))
    return _sw_masked(up, dn, dn_dir, usecol, top_at_1)


def _sw_core_lay_major(
    models: Sequence[NNModel],
    solar_source,
    play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs_dict,
    top_at_1: bool,
):
    """Staged layer-major SW core. Honors fast_exponential."""
    gas_desc = GasConcs(concs_dict)
    ncol, nlay = play.shape
    if not top_at_1:
        play, tlay, plev = play.flip(1), tlay.flip(1), plev.flip(1)
    gd_t = _to_lay_major(gas_desc, ncol, nlay, top_at_1)
    col_dry_t = get_col_dry_lay_major(gd_t.get_raw("h2o"), plev.T)
    x = compute_nn_inputs(play.T, tlay.T, gd_t, models[0])
    tau, ssa = predict_nn_sw(models, x, col_dry_t)  # (nlay, ncol, ngpt)
    toa_src, alb_gpt, mu0_safe = _sw_boundary(solar_source, tsi, sfc_alb, mu0, usecol)
    sol = sw_solver_2stream_lay_major(tau, ssa, torch.zeros_like(tau), mu0_safe,
                                      toa_src, alb_gpt, alb_gpt)
    return _sw_masked(sol.flux_up, sol.flux_dn, sol.flux_dn_dir, usecol, top_at_1)


def _emis_band(data: RFMIPData, spectral: SpectralMapping, device, dtype):
    return torch.as_tensor(np.asarray(data.sfc_emis), dtype=dtype, device=device)[:, None].expand(
        data.ncol, spectral.nband)


def _sun(data: RFMIPData, device, dtype):
    """(mu0, usecol): cos(sza) and the day-column mask (sza < 90 deg)."""
    mu0 = np.cos(np.deg2rad(data.sza))
    usecol = data.sza < 90.0 - 0.5 * np.finfo(np.float32).eps
    return (torch.as_tensor(mu0, dtype=dtype, device=device),
            torch.as_tensor(usecol, device=device))


def lw_canonical_inputs(data: RFMIPData, spectral: SpectralMapping, device,
                        dtype=torch.float32):
    """The fused LW core's inputs on ``device``: (play_t, plev_t, tlay_t,
    tlev_t, tsfc, sfc_emis_band, concs_t)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    play_t, plev_t, tlay_t, tlev_t, concs_t = canonicalize_rfmip_inputs(data)
    return (t(play_t), t(plev_t), t(tlay_t), t(tlev_t), t(data.tsfc),
            _emis_band(data, spectral, device, dtype),
            {k: t(v) for k, v in concs_t.items()})


def sw_canonical_inputs(data: RFMIPData, device, dtype=torch.float32):
    """The fused SW core's inputs on ``device``: (play_t, plev_t, tlay_t,
    sfc_alb, mu0, usecol, tsi, concs_t)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    play_t, plev_t, tlay_t, _, concs_t = canonicalize_rfmip_inputs(data)
    mu0, usecol = _sun(data, device, dtype)
    return (t(play_t), t(plev_t), t(tlay_t), t(data.sfc_alb), mu0, usecol,
            t(data.tsi), {k: t(v) for k, v in concs_t.items()})


def _check_sw_scaling(models):
    a, r = models
    if not (torch.equal(a.input_min, r.input_min) and torch.equal(a.input_max, r.input_max)):
        # the features are scaled once, with the absorption net's coefficients
        raise ValueError("SW megakernel requires matching abs/ray input scaling "
                         "(input_min/input_max differ)")


def rfmip_clear_sky_lw(
    data: RFMIPData,
    models: Sequence[NNModel],
    spectral: Optional[SpectralMapping] = None,
    planck_table: Optional[PlanckTable] = None,
    n_gauss_angles: int = 1,
    scan_mode: str = "sequential",
    dtype=torch.float32,
    *,
    device,
) -> FluxesBroadband:
    """End-to-end LW clear-sky fluxes with NN gas optics on ``device``
    (reference rrtmgp_rfmip_lw.F90 main loop). ``models`` must be on
    ``device``. Returns (ncol, nlay+1) fluxes on ``device``."""
    device = torch.device(device)
    if n_gauss_angles != 1 or scan_mode != "sequential":
        raise NotImplementedError(
            "multi-angle and parallel-scan LW solves are still to be ported "
            "(ROADMAP Queue 1 item 6)")
    use_kernel, why = resolve_use_megakernel(lw=True, models=models, device=device, dtype=dtype)
    if device.type == "cuda" and not use_kernel:
        raise NotImplementedError(f"rfmip_clear_sky_lw on CUDA: {why}")
    spectral = spectral or lw_spectral_g128()
    if planck_table is None:
        planck_table = PlanckTable.compute(spectral.band_lims_wvn_array,
                                           device=device, dtype=dtype)
    else:
        planck_table = planck_table.to(device)
    if use_kernel:
        return _lw_core_mega4_canon(
            models, planck_table, spectral,
            *lw_canonical_inputs(data, spectral, device, dtype), top_at_1=data.top_at_1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return _lw_core_lay_major(
        models, planck_table, spectral, t(data.play), t(data.plev), t(data.tlay),
        t(data.tlev), t(data.tsfc), _emis_band(data, spectral, device, dtype),
        {k: t(v) for k, v in data.gas_concs.concs.items()}, top_at_1=data.top_at_1)


def rfmip_clear_sky_sw(
    data: RFMIPData,
    models: Sequence[NNModel],
    spectral: Optional[SpectralMapping] = None,
    solar_source: Optional[np.ndarray] = None,
    kdist=None,
    scan_mode: str = "sequential",
    dtype=torch.float32,
    *,
    device,
) -> FluxesBroadband:
    """End-to-end SW clear-sky fluxes with NN gas optics on ``device``
    (reference rrtmgp_rfmip_sw.F90); ``models`` = [absorption, rayleigh],
    on ``device``. Night columns (sza >= 90 deg) come back zero."""
    device = torch.device(device)
    if scan_mode != "sequential":
        raise NotImplementedError(
            "parallel-scan SW solves are still to be ported (ROADMAP Queue 1 item 6)")
    use_kernel, why = resolve_use_megakernel(models=models, device=device, dtype=dtype)
    if device.type == "cuda" and not use_kernel:
        raise NotImplementedError(f"rfmip_clear_sky_sw on CUDA: {why}")
    spectral = spectral or sw_spectral_g112()
    if solar_source is None:
        solar_source = resolve_solar_source(spectral, kdist)
    if use_kernel:
        _check_sw_scaling(models)
        return _sw_core_mega_canon(
            models, torch.as_tensor(solar_source, dtype=dtype, device=device),
            *sw_canonical_inputs(data, device, dtype), top_at_1=data.top_at_1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    mu0, usecol = _sun(data, device, dtype)
    return _sw_core_lay_major(
        models, t(solar_source), t(data.play), t(data.plev), t(data.tlay),
        t(data.sfc_alb), mu0, usecol, t(data.tsi),
        {k: t(v) for k, v in data.gas_concs.concs.items()}, top_at_1=data.top_at_1)
