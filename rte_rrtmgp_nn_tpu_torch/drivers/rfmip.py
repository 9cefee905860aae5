"""RFMIP clear-sky drivers: the end-to-end LW and SW paths.

Port of rte_rrtmgp_nn_tpu/drivers/rfmip.py (reference
examples/rfmip-clear-sky/rrtmgp_rfmip_lw.F90 and rrtmgp_rfmip_sw.F90: NN
gas optics then the RTE solver; SW renormalizes the TOA source to the TSI
(:407-427), masks night columns by sza >= 90 deg and zeroes their fluxes
after the solve (:455-459)).

Handed a k-distribution (``gasoptics.kdist.KDist``) in place of the nets,
both drivers take the upstream driver's lookup-table route
(rrtmgp_rfmip_lw.F90 without the NN files: ``gas_optics_int`` with no
``neural_nets``) on the k-distribution's own mapping: ``gas_optics_lw_lut``
-> ``rte_lw`` (its own Planck data; K7 on CUDA), ``gas_optics_sw_lut`` ->
``rte_sw`` (its own solar source, scaled to each column's TSI). The gases
it does not name are not read. ``lut_kdist`` checks such a call.

Otherwise the route is taken once per call by ``config.driver_route``:
  - "megakernel": the fused-kernel cores on canonical layer-major inputs
    (``drivers/fused.py``: ``fused.lw_core``, and ``_sw_core_mega_canon``,
    RFMIP's SW boundary and night mask around ``fused.sw_core``), which
    launch the fused CUDA kernels K1/K2 for CUDA tensors (and run their
    plain twins for CPU tensors);
  - "staged": NN gas optics, then the RTE solvers. LW, with any number of
    Gauss angles, takes the general RTE path (``_lw_core``:
    gas_optics_lw_nn -> rte_lw); SW takes the layer-major core
    (``_sw_core_lay_major``), or for ``scan_mode="parallel"`` the general
    one (``_sw_core``: gas_optics_sw_nn -> rte_sw). On CUDA their NN step is the MLP kernel (K3,
    K4 for two-model LW, K5 for SW) and each angle of the LW solve is the
    transport kernel (K7); the solver code around them runs as PyTorch ops
    on the card, never a kernel's plain twin;
  - "refuse": NotImplementedError with the reason (float64 on CUDA, a
    net the MLP kernel does not take).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import cuda_dtype_refusal, driver_route
from ..fluxes import FluxesBroadband
from ..gas_concs import GasConcs
from ..gasoptics.kdist import KDist
from ..gasoptics.lut_gas_optics import gas_optics_lw_lut, gas_optics_sw_lut
from ..gasoptics.nn_gas_optics import (
    compute_nn_inputs,
    compute_nn_inputs_split,
    gas_optics_lw_nn,
    gas_optics_sw_nn,
    get_col_dry_lay_major,
    predict_nn_sw,
    split_first_layer,
)
from ..gasoptics.planck import (
    KeptTables,
    PlanckTable,
    gpt_weights_for,
    lw_spectral_g128,
    placed,
    solar_band_fractions,
    spectral_for,
    sw_spectral_g112,
)
from ..models.network import NNModel
from ..ops.cuda.lw_megakernel import lw_clearsky_mega5
from ..ops.cuda.lw_prep import lw_prep
from ..ops.cuda.lw_solver import lw_broadband_sweeps_kernel
from ..ops.sw_solver import sw_solver_2stream_lay_major
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..rte import rte_lw, rte_sw
from ..spectral import SpectralMapping
from ..utils.timing import span
from . import fused
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


# kept_solar_source's tensors
SOLAR_SOURCES = KeptTables("rte.solar")


def kept_solar_source(spectral: SpectralMapping, *, device, dtype=torch.float32) -> torch.Tensor:
    """``default_solar_source(spectral)`` on ``device`` in ``dtype``, kept in
    ``SOLAR_SOURCES`` per mapping, device and dtype: the first call of a key
    makes it under the span ``rte.solar``, every later one returns the same
    tensor. Shared by every caller of the key, so read-only."""
    device = placed(device)
    return SOLAR_SOURCES.get((spectral, device, dtype), lambda: torch.as_tensor(
        default_solar_source(spectral), dtype=dtype, device=device))


def solar_source_on(spectral: SpectralMapping, kdist, solar_source, device,
                    dtype) -> torch.Tensor:
    """The SW drivers' per-g-point solar source on ``device`` in ``dtype``:
    ``solar_source`` when given, else ``resolve_solar_source(spectral,
    kdist)``. With neither a ``solar_source`` nor a ``kdist`` that carries
    NRLSSI2 terms that is the default source, read kept
    (``kept_solar_source``); the others are made at every call (a kdist's
    terms change with its solar variability) under the span ``rte.solar``."""
    if solar_source is None and getattr(kdist, "solar_quiet", None) is None:
        return kept_solar_source(spectral, device=device, dtype=dtype)
    with span("rte.solar"):
        if solar_source is None:
            solar_source = resolve_solar_source(spectral, kdist)
        return torch.as_tensor(solar_source, dtype=dtype, device=device)


def resolve_solar_source(spectral: SpectralMapping, kdist=None, tsi: Optional[float] = None,
                         mg_index: Optional[float] = None,
                         sb_index: Optional[float] = None) -> np.ndarray:
    """Per-g-point TOA solar flux, from the k-distribution's NRLSSI2 terms
    whenever a ``kdist`` that carries them is given (reference
    mo_gas_optics_rrtmgp.F90:594-599; variability :1058-1095). Three tiers:
      1. the kdist's g-points match ``spectral``: ``kdist.solar_source()``;
      2. its bands match but the g-point counts differ (the unreduced g-224
         file with the g-112 NN models): the per-band totals are kept and
         spread within each band by the mapping's quadrature weights
         (gasoptics.planck.gpt_weights_for);
      3. no kdist: brightness-temperature band fractions
         (``default_solar_source``)."""
    if kdist is None or getattr(kdist, "solar_quiet", None) is None:
        return default_solar_source(spectral, tsi=tsi or 1360.85)
    src = kdist.solar_source(mg_index, sb_index, tsi=tsi).detach().cpu().numpy()
    if kdist.ngpt == spectral.ngpt:
        return src
    kb, sb = kdist.spectral.band_lims_wvn_array, spectral.band_lims_wvn_array
    if kdist.nband != spectral.nband or not np.allclose(kb, sb, rtol=5e-2):
        raise ValueError(
            "kdist solar source cannot be remapped: band structure differs from the "
            f"requested spectral mapping ({kdist.nband} vs {spectral.nband} bands)")
    w = gpt_weights_for(spectral)
    out = np.zeros(spectral.ngpt)
    for ib, (s, e) in enumerate(spectral.band_lims_gpt):
        ks, ke = kdist.spectral.band_lims_gpt[ib]
        out[s:e] = float(np.sum(src[ks:ke])) * w[s:e] / np.sum(w[s:e])
    return out


def canonicalize_rfmip_inputs(data: RFMIPData, dtype=np.float32):
    """Host-side layer-major canonicalization for the fused-kernel cores:
    (ncol, nlay[+1]) fields become contiguous (nlay[+1], ncol) top-at-0
    numpy arrays, and per-layer (1-D) gas profiles are materialized to 2-D
    (scalars stay scalar). Returns (play_t, plev_t, tlay_t, tlev_t,
    concs_t). ``lw/sw_canonical_inputs`` lay out the same on the device."""
    canon = lambda a: fused.lay_major_host(a, data.top_at_1, dtype)
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


def _conc_shard_spec(concs_t) -> dict:
    """How each gas of a canonical (layer-major) gas dict is split over
    'col': 2-D profiles on axis 1 (their column axis), scalars replicated
    (None)."""
    return {k: (1 if getattr(v, "ndim", 0) == 2 else None) for k, v in concs_t.items()}


def _sharded_core(mesh, run, col_axes, on_device):
    """``run(placed, *args)`` (a fused core on canonical inputs, ``placed``
    the models and tables on the share's device) on each share of the
    columns. On a process-group mesh a rank passes its own block (the
    canonical inputs of its columns, e.g. of ``data.block(start, n)`` for
    its share under ``column_sharding(mesh, 2).split(ncol)``), nothing
    else: it returns that block's result, or the whole range in rank order
    by ``all_gather`` with ``gather=True``. On a one-process mesh the whole
    inputs are split on their column axes ``col_axes`` (1 for the
    layer-major fields, 0 for the per-column ones, the gas dict last), the
    shares run one per device and are joined on the first, as
    ``shard_ops.columnwise_shard_map``."""
    from ..parallel.sharding import column_sharding, gather_columns, replicated

    placed = replicated(mesh).put(on_device)

    def on(x, dev):
        return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(dev)

    def wrapped(*args, gather: bool = False):
        *fields, concs_t = args
        if mesh.ranks is not None:
            dev = mesh.devices[0]
            out = run(placed[dev], *(on(x, dev) for x in fields),
                      {k: on(v, dev) for k, v in concs_t.items()})
            return out if not gather else tuple(gather_columns(mesh, o) for o in out)
        spec = _conc_shard_spec(concs_t)
        ncol = fields[0].shape[col_axes[0]]
        parts = mesh.shape["col"]
        if -(-ncol // parts) * (parts - 1) >= ncol:  # shares of ceil(ncol / parts): one empty
            raise ValueError(f"{ncol} columns leave a share of a {parts}-way 'col' split empty; "
                             "pad them (parallel.sharding.pad_to_multiple)")

        def take(x, axis, dev, s, n):
            x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            return on(x if axis is None else x.narrow(axis, s, n), dev).contiguous()

        outs = []
        for dev, s, n in column_sharding(mesh, 2).split(ncol):
            local = [take(x, a, dev, s, n) for x, a in zip(fields, col_axes)]
            gases = {k: take(v, spec[k], dev, s, n) for k, v in concs_t.items()}
            outs.append(run(placed[dev], *local, gases))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[i].to(mesh.devices[0]) for o in outs])
                     for i in range(len(outs[0])))

    return wrapped


def lw_mega_core_sharded(mesh, models, planck_table, spectral, top_at_1):
    """``fused.lw_core`` split over the mesh's 'col' axis: each rank
    (or each device of a one-process mesh) runs the fused LW core, one K1
    launch a call, on its own columns; columns are halo-free, so nothing
    crosses ranks on the hot path. The fused kernel's launch plan does not
    depend on the column count, so a rank's columns come out as the same
    columns of the unsharded core.

    Returns ``fn(play_t, plev_t, tlay_t, tlev_t, tsfc, emis, concs_t,
    gather=False) -> (flux_up, flux_dn)`` on canonical layer-major inputs
    (``lw_canonical_inputs``). The JAX function takes global arrays whose
    shards sit on their devices; here, on a process-group mesh, a rank
    passes the inputs of its own columns only (its shard) and gets their
    (ncol_rank, nlay+1) fluxes; with ``gather=True`` it gets the whole
    (ncol, nlay+1) range on every rank, the global array of the JAX
    function's ``out_specs``. On a one-process mesh the inputs are the
    whole range, split as ``_conc_shard_spec`` says for the gases, and the
    result is the whole range on the mesh's first device."""

    def run(on, *args):
        m, table = on
        fb = fused.lw_core(m, table, spectral, *args, top_at_1=top_at_1)
        return fb.flux_up, fb.flux_dn

    return _sharded_core(mesh, run, (1, 1, 1, 1, 0, 0), (list(models), planck_table))


def sw_mega_core_sharded(mesh, models, spectral, solar_source, top_at_1):
    """``_sw_core_mega_canon`` split over 'col' (see lw_mega_core_sharded):
    one K2 launch a call on each rank's columns. Returns ``fn(play_t,
    plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t, gather=False) ->
    (flux_up, flux_dn, flux_dn_dir)``; night columns come back zero.
    ``solar_source`` is per g-point of ``spectral``."""
    solar_source = torch.as_tensor(solar_source)
    if solar_source.shape != (spectral.ngpt,):
        raise ValueError(f"sw_mega_core_sharded: solar_source {tuple(solar_source.shape)} for "
                         f"{spectral.ngpt} g-points")

    def run(on, *args):
        m, solar = on
        fb = _sw_core_mega_canon(m, solar, *args, top_at_1=top_at_1)
        return fb.flux_up, fb.flux_dn, fb.flux_dn_dir

    return _sharded_core(mesh, run, (1, 1, 1, 0, 0, 0, 0), (list(models), solar_source))


def lw_mega5_args(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play_t, plev_t, tlay_t, tlev_t, tsfc, sfc_emis_band, concs_t,
):
    """The raw-lane fused LW kernel's arguments (lw_clearsky_mega5) from
    canonical layer-major top-at-0 inputs: no feature is staged, only
    col_dry and the emissivity expansion precede the kernel, made as
    ``fused.lw_args`` makes them."""
    gas_desc, col_dry = fused.gas_columns(play_t, plev_t, concs_t)
    lanes, const_feats, perm, tf_codes, scale_rows = compute_nn_inputs_split(
        play_t, tlay_t, gas_desc, models[0], raw_lanes=True)
    if models[0].input_names[perm[0]] != "tlay":
        raise ValueError("the raw-lane kernel requires 'tlay' as the first 2-D lane "
                         f"(got {models[0].input_names[perm[0]]!r})")
    w1a, w1c = split_first_layer(models[0], perm, len(lanes))
    return (models[0], [l.contiguous() for l in lanes], tf_codes, scale_rows, const_feats,
            w1a, w1c, col_dry,
            *fused.lw_tail(planck_table, spectral, tlev_t, tsfc, sfc_emis_band))


def _lw_core_mega5_canon(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play_t, plev_t, tlay_t, tlev_t, tsfc, sfc_emis_band, concs_t,
    top_at_1: bool,
):
    """``fused.lw_core`` through the fused kernel's raw-lane mode."""
    up, dn = lw_clearsky_mega5(*lw_mega5_args(
        models, planck_table, spectral, play_t, plev_t, tlay_t, tlev_t, tsfc,
        sfc_emis_band, concs_t))
    return fused.fluxes(top_at_1, up, dn, None)


def _lw_core_mega5(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
):
    """Column-major front of _lw_core_mega5_canon: flips to top-at-0 and
    transposes on the device."""
    ncol, nlay = play.shape
    canon = lambda a: fused.lay_major(a, top_at_1)
    gd_t = _to_lay_major(GasConcs(concs_dict), ncol, nlay, top_at_1)
    concs_t = {k: v.contiguous() for k, v in gd_t.concs.items()}
    return _lw_core_mega5_canon(
        models, planck_table, spectral, canon(play), canon(plev), canon(tlay), canon(tlev),
        tsfc, sfc_emis_band, concs_t, top_at_1=top_at_1)


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


def _lw_core(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
    n_gauss_angles: int,
    scan_mode: str = "sequential",
):
    """General LW core: column-major gas optics, NN or from a KDist in
    ``models`` (which carries its own Planck data: ``planck_table`` unused),
    then rte_lw with ``n_gauss_angles`` Gauss angles and broadband output.
    As in the JAX package the broadband solve reduces inside its layer
    sweeps and does not read ``scan_mode``."""
    gases = GasConcs(concs_dict)
    if isinstance(models, KDist):
        optics, sources = gas_optics_lw_lut(models, play, plev, tlay, tsfc, gases, tlev=tlev,
                                            top_at_1=top_at_1)
    else:
        tau, sources = gas_optics_lw_nn(models, play, plev, tlay, tsfc, gases, spectral,
                                        planck_table, tlev=tlev, top_at_1=top_at_1)
        optics = OpticalProps1scl(tau, spectral)
    sol = rte_lw(optics, top_at_1, sources, sfc_emis_band, n_gauss_angles=n_gauss_angles,
                 scan_mode=scan_mode, broadband=True)
    return FluxesBroadband(flux_up=sol.flux_up, flux_dn=sol.flux_dn,
                           flux_net=sol.flux_dn - sol.flux_up)


def _lw_core_prep(
    models: Sequence[NNModel],
    planck_table: PlanckTable,
    spectral: SpectralMapping,
    play, plev, tlay, tlev, tsfc, sfc_emis_band, concs_dict,
    top_at_1: bool,
):
    """Prep LW core: the front-end kernel (ops/cuda/lw_prep.lw_prep, K6)
    makes exactly the three layer-major fields the broadband sweeps read
    and the surface source, from band Planck values interpolated here; the
    sweeps are the transport kernel's fields mode on CUDA
    (ops/cuda/lw_solver.lw_broadband_sweeps_kernel, K7) and tensor ops on
    the CPU (lw_broadband_sweeps). Column-major inputs in the caller's
    orientation. No driver routes to it, in the JAX package neither: tests
    and benchmarks call it."""
    ncol, nlay = play.shape
    canon = lambda a: fused.lay_major(a, top_at_1)
    play_t, plev_t, tlay_t, tlev_t = canon(play), canon(plev), canon(tlay), canon(tlev)
    gd_t = _to_lay_major(GasConcs(concs_dict), ncol, nlay, top_at_1)
    col_dry = get_col_dry_lay_major(gd_t.get_raw("h2o"), plev_t).contiguous()
    x = compute_nn_inputs(play_t, tlay_t, gd_t, models[0]).contiguous()  # (nlay, ncol, nf)
    trans, src_dn, src_up, sfc_src = lw_prep(
        models[0], x, col_dry,
        planck_table.interpolate(tlay_t), planck_table.interpolate(tlev_t),
        planck_table.interpolate(tsfc), spectral.gpt2band_tensor(play.device))
    sol = lw_broadband_sweeps_kernel(trans, src_dn, src_up,
                                     spectral.expand(sfc_emis_band).contiguous(), sfc_src)
    return fused.fluxes(top_at_1, sol.flux_up, sol.flux_dn, None)


def _sw_masked(fb: FluxesBroadband, usecol) -> FluxesBroadband:
    """``fb`` with the night columns zeroed."""
    mask = usecol[:, None]
    return FluxesBroadband(
        flux_up=torch.where(mask, fb.flux_up, 0.0),
        flux_dn=torch.where(mask, fb.flux_dn, 0.0),
        flux_net=torch.where(mask, fb.flux_net, 0.0),
        flux_dn_dir=torch.where(mask, fb.flux_dn_dir, 0.0),
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


def sw_fused_inputs(solar_source, play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t):
    """``fused.sw_args``' inputs after its spectral mapping from the fused
    SW core's (``sw_canonical_inputs``), with RFMIP's boundary
    (``_sw_boundary``): (play_t, plev_t, tlay_t, mu0 with night columns at
    1, the TOA source renormalized to each column's TSI, the albedo per
    g-point twice, concs_t)."""
    toa_src, alb_gpt, mu0_safe = _sw_boundary(solar_source, tsi, sfc_alb, mu0, usecol)
    return play_t, plev_t, tlay_t, mu0_safe, toa_src, alb_gpt, alb_gpt, concs_t


def _sw_core_mega_canon(
    models: Sequence[NNModel],
    solar_source,
    play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t,
    top_at_1: bool,
):
    """SW core through the fused kernel (``fused.sw_core``), on canonical
    layer-major top-at-0 inputs. Night columns enter the kernel with mu0 =
    1 and leave with zeroed fluxes."""
    with span("rte.prep"):
        inputs = sw_fused_inputs(solar_source, play_t, plev_t, tlay_t, sfc_alb, mu0, usecol,
                                 tsi, concs_t)
    return _sw_masked(fused.sw_core(models, None, *inputs, top_at_1=top_at_1), usecol)


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
    return _sw_masked(fused.fluxes(top_at_1, sol.flux_up, sol.flux_dn, sol.flux_dn_dir), usecol)


def _sw_core(
    models: Sequence[NNModel],
    spectral: SpectralMapping,
    solar_source,
    play, plev, tlay, sfc_alb, mu0, usecol, tsi, concs_dict,
    top_at_1: bool,
    scan_mode: str = "sequential",
):
    """General SW core: column-major gas optics, NN or from a KDist in
    ``models``, then rte_sw with two-stream optical properties (g = 0) and
    broadband output. rfmip_clear_sky_sw takes it for parallel-scan
    requests, as the JAX one does, and for a k-distribution; the broadband
    two-stream solve sweeps sequentially in either mode."""
    gases = GasConcs(concs_dict)
    if isinstance(models, KDist):
        optics, _ = gas_optics_sw_lut(models, play, plev, tlay, gases)
    else:
        tau, ssa, _ = gas_optics_sw_nn(models, play, plev, tlay, gases, spectral, solar_source)
        optics = OpticalProps2str(tau, ssa, torch.zeros_like(tau), spectral)
    toa_src, alb_gpt, mu0_safe = _sw_boundary(solar_source, tsi, sfc_alb, mu0, usecol)
    sol = rte_sw(optics, top_at_1, mu0_safe, toa_src, alb_gpt, alb_gpt, scan_mode=scan_mode,
                 broadband=True)
    # rte_sw returns the caller's orientation: nothing to flip
    return _sw_masked(fused.fluxes(True, sol.flux_up, sol.flux_dn, sol.flux_dn_dir), usecol)


def _emis_band(data: RFMIPData, spectral: SpectralMapping, device, dtype):
    return torch.as_tensor(np.asarray(data.sfc_emis), dtype=dtype, device=device)[:, None].expand(
        data.ncol, spectral.nband)


def _sun(data: RFMIPData, device, dtype):
    """(mu0, usecol): cos(sza) and the day-column mask (sza < 90 deg)."""
    mu0 = np.cos(np.deg2rad(data.sza))
    usecol = data.sza < 90.0 - 0.5 * np.finfo(np.float32).eps
    return (torch.as_tensor(mu0, dtype=dtype, device=device),
            torch.as_tensor(usecol, device=device))


def _lay_out(data: RFMIPData, fields, concs):
    """``canonicalize_rfmip_inputs``' layout of ``data``'s (ncol, nlay[+1])
    ``fields`` and gas dict ``concs``, copied as they are, done on their
    device with ``fused.lay_major``: the same bits. A per-layer (1-D) gas
    is broadcast over the columns first; a scalar stays a scalar. Returns
    (the fields, the gas dict)."""
    lay = lambda a: fused.lay_major(a, data.top_at_1)
    gas = lambda v: v if v.ndim == 0 else lay(v.expand(data.ncol, -1) if v.ndim == 1 else v)
    return [lay(a) for a in fields], {k: gas(v) for k, v in concs.items()}


def lw_canonical_inputs(data: RFMIPData, spectral: SpectralMapping, device,
                        dtype=torch.float32):
    """The fused LW core's inputs on ``device``: (play_t, plev_t, tlay_t,
    tlev_t, tsfc, sfc_emis_band, concs_t). Each host array is copied as it
    is (``rte.h2d``) and laid out on ``device`` (``rte.canon``)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    with span("rte.h2d"):
        fields = [t(a) for a in (data.play, data.plev, data.tlay, data.tlev)]
        tsfc, emis = t(data.tsfc), _emis_band(data, spectral, device, dtype)
        concs = {k: t(v) for k, v in data.gas_concs.concs.items()}
    with span("rte.canon"):
        (play_t, plev_t, tlay_t, tlev_t), concs_t = _lay_out(data, fields, concs)
    return play_t, plev_t, tlay_t, tlev_t, tsfc, emis, concs_t


def sw_canonical_inputs(data: RFMIPData, device, dtype=torch.float32):
    """The fused SW core's inputs on ``device``: (play_t, plev_t, tlay_t,
    sfc_alb, mu0, usecol, tsi, concs_t), copied and laid out as
    ``lw_canonical_inputs``'."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    with span("rte.h2d"):
        fields = [t(a) for a in (data.play, data.plev, data.tlay)]
        sfc_alb, tsi = t(data.sfc_alb), t(data.tsi)
        concs = {k: t(v) for k, v in data.gas_concs.concs.items()}
    with span("rte.canon"):
        (play_t, plev_t, tlay_t), concs_t = _lay_out(data, fields, concs)
        mu0, usecol = _sun(data, device, dtype)
    return play_t, plev_t, tlay_t, sfc_alb, mu0, usecol, tsi, concs_t


def _check_sw_scaling(models):
    a, r = models
    if a is r:  # one net standing in for both
        return
    if not (torch.equal(a.input_min, r.input_min) and torch.equal(a.input_max, r.input_max)):
        # the features are scaled once, with the absorption net's coefficients
        raise ValueError("SW megakernel requires matching abs/ray input scaling "
                         "(input_min/input_max differ)")


def lw_staged_inputs(data: RFMIPData, spectral: SpectralMapping, device,
                     dtype=torch.float32):
    """The staged and general LW cores' inputs on ``device``, in the
    caller's orientation: (play, plev, tlay, tlev, tsfc, sfc_emis_band,
    concs)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    with span("rte.h2d"):
        return (t(data.play), t(data.plev), t(data.tlay), t(data.tlev), t(data.tsfc),
                _emis_band(data, spectral, device, dtype),
                {k: t(v) for k, v in data.gas_concs.concs.items()})


def sw_staged_inputs(data: RFMIPData, device, dtype=torch.float32):
    """The staged and general SW cores' inputs on ``device``, in the
    caller's orientation: (play, plev, tlay, sfc_alb, mu0, usecol, tsi,
    concs)."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    with span("rte.canon"):
        mu0, usecol = _sun(data, device, dtype)
    with span("rte.h2d"):
        return (t(data.play), t(data.plev), t(data.tlay), t(data.sfc_alb), mu0, usecol,
                t(data.tsi), {k: t(v) for k, v in data.gas_concs.concs.items()})


def lut_kdist(entry: str, band: str, models, data: RFMIPData, device, dtype,
              **unused) -> Optional[KDist]:
    """The k-distribution that ``models`` is, or None for nets. Refuses in
    words a k-distribution beside nets, one of the other band, float64 on
    CUDA, tables on another device or in another dtype than the call's, a
    gas it names that ``data`` lacks, and any of ``unused`` given (the
    driver's arguments the route does not read, by name, None where not
    given). Reads host values and tensor metadata only."""
    if not isinstance(models, KDist):
        if any(isinstance(m, KDist) for m in models):
            raise ValueError(f"{entry}: takes nets or a k-distribution, not both")
        return None
    kd = models
    if kd.is_internal_source != (band == "lw"):
        other = "LW" if kd.is_internal_source else "SW"
        raise ValueError(f"{entry}: an {other} k-distribution ({kd.ngpt} g-points) handed to "
                         f"the {band.upper()} driver")
    refusal = cuda_dtype_refusal(device, dtype)
    if refusal:
        raise NotImplementedError(f"{entry}: {refusal}")
    if kd.kmajor.device != device or kd.kmajor.dtype != dtype:
        raise ValueError(f"{entry}: the k-distribution's tables are {kd.kmajor.dtype} on "
                         f"{kd.kmajor.device}, the call {dtype} on {device}")
    missing = [g for g in kd.gas_names if g not in data.gas_concs.concs]
    if missing:
        raise ValueError(f"{entry}: the k-distribution's gases {missing} are not in the data")
    given = [name for name, v in unused.items() if v is not None]
    if given:
        raise ValueError(f"{entry}: a k-distribution brings its own spectral mapping and "
                         f"sources; {', '.join(given)} cannot be given with it")
    return kd


def _lut_data(data: RFMIPData, kd: KDist) -> RFMIPData:
    """``data`` with only the gases ``kd`` reads."""
    return dataclasses.replace(data, gas_concs=GasConcs(
        {g: v for g, v in data.gas_concs.concs.items() if g in kd.gas_names}))


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
    (reference rrtmgp_rfmip_lw.F90 main loop), with ``n_gauss_angles``
    Gauss angles (1-4). ``models`` (one "lw_both" net, or an absorption
    and a Planck-fraction net) must be on ``device``. ``spectral``
    defaults to the g-128 mapping; nets that do not fit it, or the
    mapping passed, raise ValueError (planck.spectral_for). Without a
    ``planck_table`` the call reads the mapping's table kept per band
    limits, device and dtype (``PlanckTable.kept``); a table passed is
    moved to ``device`` and used as it is, never kept. ``models`` may
    instead be an LW KDist on ``device`` in ``dtype`` (the lookup-table
    route; no ``spectral`` or ``planck_table`` then). Returns (ncol,
    nlay+1) fluxes on ``device``."""
    with span("rte.rfmip.lw"):
        with span("rte.check"):
            device = torch.device(device)
            kd = lut_kdist("rfmip_clear_sky_lw", "lw", models, data, device, dtype,
                           spectral=spectral, planck_table=planck_table)
            if kd is None:
                spectral = spectral_for("lw", models, entry="rfmip_clear_sky_lw",
                                        accepts=(lw_spectral_g128,), spectral=spectral)
                route = driver_route("rfmip_clear_sky_lw", lw=True, models=models,
                                     device=device, dtype=dtype,
                                     n_gauss_angles=n_gauss_angles, scan_mode=scan_mode)
        if kd is not None:
            return _lw_core(kd, None, kd.spectral,
                            *lw_staged_inputs(_lut_data(data, kd), kd.spectral, device, dtype),
                            top_at_1=data.top_at_1, n_gauss_angles=n_gauss_angles,
                            scan_mode=scan_mode)
        if planck_table is None:
            planck_table = PlanckTable.kept(spectral.band_lims_wvn_array, device=device,
                                            dtype=dtype)
        else:
            planck_table = planck_table.to(device)
        if route == "megakernel":
            return fused.lw_core(models, planck_table, spectral,
                                 *lw_canonical_inputs(data, spectral, device, dtype),
                                 top_at_1=data.top_at_1)
        return _lw_core(models, planck_table, spectral,
                        *lw_staged_inputs(data, spectral, device, dtype),
                        top_at_1=data.top_at_1, n_gauss_angles=n_gauss_angles,
                        scan_mode=scan_mode)


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
    on ``device``. Night columns (sza >= 90 deg) come back zero.
    ``spectral`` defaults to the g-112 mapping; nets that do not fit it,
    or the mapping passed, raise ValueError (planck.spectral_for). The
    solar source is ``solar_source`` when given, else the ``kdist``'s,
    both made at every call, else the mapping's default source kept per
    mapping, device and dtype (``solar_source_on``). ``models`` may
    instead be an SW KDist on ``device`` in ``dtype`` (the
    lookup-table route, with the k-distribution's solar source; no
    ``spectral``, ``solar_source`` or ``kdist`` then)."""
    with span("rte.rfmip.sw"):
        with span("rte.check"):
            device = torch.device(device)
            kd = lut_kdist("rfmip_clear_sky_sw", "sw", models, data, device, dtype,
                           spectral=spectral, solar_source=solar_source, kdist=kdist)
            if kd is None:
                spectral = spectral_for("sw", models, entry="rfmip_clear_sky_sw",
                                        accepts=(sw_spectral_g112,), spectral=spectral)
                route = driver_route("rfmip_clear_sky_sw", models=models, device=device,
                                     dtype=dtype, scan_mode=scan_mode)
                if route == "megakernel":
                    _check_sw_scaling(models)
        if kd is not None:
            with span("rte.solar"):
                solar = kd.solar_source()
            return _sw_core(kd, kd.spectral, solar,
                            *sw_staged_inputs(_lut_data(data, kd), device, dtype),
                            top_at_1=data.top_at_1, scan_mode=scan_mode)
        solar = solar_source_on(spectral, kdist, solar_source, device, dtype)
        if route == "megakernel":
            return _sw_core_mega_canon(models, solar, *sw_canonical_inputs(data, device, dtype),
                                       top_at_1=data.top_at_1)
        if scan_mode == "sequential":
            return _sw_core_lay_major(models, solar, *sw_staged_inputs(data, device, dtype),
                                      top_at_1=data.top_at_1)
        return _sw_core(models, spectral, solar, *sw_staged_inputs(data, device, dtype),
                        top_at_1=data.top_at_1, scan_mode=scan_mode)
