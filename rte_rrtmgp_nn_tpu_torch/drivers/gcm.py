"""GCM-scale sweep driver: about a million columns, streamed and split over
devices.

Port of rte_rrtmgp_nn_tpu/drivers/gcm.py. A GCM calls the radiation scheme
on every column of its grid at each radiation time step; this driver
sweeps such a column set, held in host memory, through the LW (and SW
all-sky) cores block by block: ``parallel/streaming.py`` overlaps each
block's host -> device copy with the previous block's step, and a mesh
(``parallel/sharding.py``) splits each block's columns over devices. Only
per-column diagnostics come back: [olr, surface LW down] (LW) and
[olr, surface LW down, surface SW down] (all-sky).

Each sweep takes its route once, by ``config.driver_route``:
  - "megakernel": each block is transposed on the device into canonical
    layer-major top-at-0 form and goes through the fused cores
    (``drivers/fused.py``): K1 (``fused.lw_core``, clear or in its cloud
    mode) and K2 (``fused.sw_core`` in its cloud mode), one launch of each
    per block;
  - "staged": the cores the RFMIP and all-sky drivers take: ``_lw_core`` /
    ``_allsky_lw_core`` (on CUDA the MLP kernel K3, then the transport
    kernel K7) and ``_allsky_sw_core_lay_major`` (the MLP kernel K5, then
    the two-stream sweeps in PyTorch);
  - "refuse": NotImplementedError with the reason.

A block crosses the host link as one copy of one staging slot, in which
each host array's rows of the block lie in a region of their own
(``parallel/streaming.py``): with ``precision="f32"`` the fields themselves
in float32 (``_f32_job``), with ``precision="mixed"`` the tolerant fields
as per-lane min-max uint16 codes beside an exact float32 block
(``_mixed_job``), which halves the bytes per column.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..config import driver_route
from ..gasoptics.planck import (
    PlanckTable,
    lw_spectral_g128,
    spectral_for,
    sw_spectral_g112,
    sw_spectral_g224,
)
from ..models.network import NNModel
from ..parallel.sharding import Mesh, column_sharding, replicated
from ..parallel.streaming import iter_blocks, stream_reduce
from ..utils.timing import span
from .allsky import (
    CLOUD_P_MAX,
    CLOUD_P_MIN,
    CLOUD_T_ICE,
    CLOUD_T_LIQ,
    _allsky_lw_core,
    _allsky_sw_core_lay_major,
    make_clouds,
)
from . import fused
from .rfmip import _check_sw_scaling, _lw_core, kept_solar_source
from .rfmip_io import RFMIPData


def synthesize_gcm_columns(base: RFMIPData, ncol_target: int, seed: int = 0) -> dict:
    """Tile and perturb the RFMIP columns up to a GCM-scale column count.
    Returns host arrays (column-leading) for streaming. A gas stored as a
    per-layer profile (nlay,) is shared by every column, like a scalar; the
    JAX function takes only scalars and (ncol, nlay) gases."""
    rng = np.random.default_rng(seed)
    reps = int(np.ceil(ncol_target / base.ncol))
    idx = np.tile(np.arange(base.ncol), reps)[:ncol_target]
    tpert = rng.uniform(-2.0, 2.0, (ncol_target, 1)).astype(np.float32)
    out = {
        "play": base.play[idx],
        "plev": base.plev[idx],
        "tlay": base.tlay[idx] + tpert,
        "tlev": base.tlev[idx] + tpert,
        "tsfc": base.tsfc[idx] + tpert[:, 0],
        "sfc_emis": base.sfc_emis[idx],
        "sfc_alb": base.sfc_alb[idx],
        "sza": base.sza[idx],
        "tsi": base.tsi[idx],
    }
    for g, v in base.gas_concs.concs.items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = np.broadcast_to(v[None, :], (base.ncol, v.shape[0]))
        if v.ndim == 2:
            vi = v[idx]
            # per-column scalars travel as (ncol,): nlay times fewer bytes
            # (most gases are well mixed)
            if np.all(vi == vi[:, :1]):
                vi = vi[:, 0]
            out[f"gas:{g}"] = vi
        else:
            out[f"gas:{g}"] = np.broadcast_to(v, (ncol_target,)).copy()
    return out


def _pack_columns_mixed(specs):
    """Mixed-precision packing: fuse column-leading host arrays into TWO
    blocks, an exact float32 block for the flux-critical lanes and a
    uint16 per-lane min-max quantized block for the tolerant fields
    (temperatures, log-pressures, log-VMRs; all min-max rescaled before the
    nets anyway). Halves the streamed bytes per column.

    specs: list of (array, kind), kind in {'f32', 'lin', 'log'} or a
    tuple (kind, thresholds) for the quantized kinds.
      'lin': q = round((v - mn) / step), step = (max-mn)/65535 per LANE
             (a lane = one layer index of one field, so the range is tight
             across columns; temperature lanes quantize to ~0.002 K).
      'log': the same on ln(v) (strictly positive fields with dynamic
             range: pressures, VMRs); the error is RELATIVE (~2e-4 for a
             12-decade lane).
      thresholds: physical values whose comparison side must SURVIVE
             quantization (hard branches downstream, such as the cloud
             placement: half a step across 273 K flips a layer from ice to
             liquid, 1.5 W/m2 in one column). Each entry is a value
             (adjudicated with >=, which also keeps any strict-< branch,
             since v < t is not(v >= t)) or a (value, op) pair with op in
             {'>=', '>'}: '>' for a strict-> branch. A code on the wrong
             side is moved one step toward the right one; thresholds must
             be more than one step apart.
    Returns (packed_f, packed_q, qmeta, layout): qmeta is (2, Kq) f32
    [mn; step] rows, layout a tuple of (kind, width) in spec order for
    ``_unpack_columns_mixed``.
    """
    fparts, qparts, mns, steps, layout = [], [], [], [], []
    for a, kind in specs:
        thresholds = ()
        if isinstance(kind, tuple):
            kind, thresholds = kind
        a2 = a[:, None] if a.ndim == 1 else a
        layout.append((kind, a2.shape[1]))
        if kind == "f32":
            fparts.append(a2.astype(np.float32, copy=False))
            continue
        v = a2.astype(np.float64)
        if kind == "log":
            if not np.all(v > 0.0):
                raise ValueError("'log' quantization requires positive values")
            v = np.log(v)
        mn = v.min(axis=0)
        rng = v.max(axis=0) - mn
        step = np.where(rng > 0, rng / 65535.0, 1.0)
        q = np.clip(np.rint((v - mn) / step), 0, 65535)
        if thresholds:
            # sides are decided with the device dequantizer's arithmetic
            # (f32 mn + f32 step * f32 q, _unpack_columns_mixed); 'log' lanes
            # compare in log space, which tracks the device's exp-then-compare
            # to ~1 ulp of exp
            mn32, st32 = mn.astype(np.float32), step.astype(np.float32)
            # the target is the float32 path's side: it streams f32(raw), so
            # a raw value within half an f32 ulp of a threshold sits on the
            # cast's side
            vb = a2.astype(np.float32).astype(np.float64)
            sides = []
            for t in thresholds:
                op = ">="
                if isinstance(t, tuple):
                    t, op = t
                strict = op == ">"
                v_hi = (vb > float(t)) if strict else (vb >= float(t))
                tv = np.float64(np.log(t) if kind == "log" else t)
                sides.append((v_hi, tv, strict))

            def wrong_side(qq, v_hi, tv, strict):
                deq = (mn32 + st32 * qq.astype(np.float32)).astype(
                    np.float64)
                return v_hi != ((deq > tv) if strict else (deq >= tv))

            for v_hi, tv, strict in sides:
                for _ in range(3):  # one bump suffices; re-check twice
                    w = wrong_side(q, v_hi, tv, strict)
                    if not w.any():
                        break
                    q = np.clip(
                        q + np.where(w & v_hi, 1.0, 0.0)
                        - np.where(w & ~v_hi, 1.0, 0.0), 0, 65535)
            if any(wrong_side(q, v_hi, tv, strict).any()
                   for v_hi, tv, strict in sides):
                # the [0, 65535] clip or a sub-ulp step can undo a bump; no
                # code represents the right side then, so the whole field
                # travels exact
                layout[-1] = ("f32", a2.shape[1])
                fparts.append(a2.astype(np.float32, copy=False))
                continue
        qparts.append(q.astype(np.uint16))
        mns.append(mn)
        steps.append(step)
    packed_f = (np.concatenate(fparts, axis=1) if fparts
                else np.zeros((specs[0][0].shape[0], 0), np.float32))
    packed_q = (np.concatenate(qparts, axis=1) if qparts
                else np.zeros((specs[0][0].shape[0], 0), np.uint16))
    qmeta = (np.stack([np.concatenate(mns), np.concatenate(steps)])
             .astype(np.float32) if mns else np.zeros((2, 0), np.float32))
    return packed_f, packed_q, qmeta, tuple(layout)


def _unpack_columns_mixed(blk_f, blk_q, qmeta, layout):
    """Inverse of _pack_columns_mixed on the device: one dequantization
    over the whole code block, then lane slices in spec order. The codes
    may arrive as uint16 or as their int16 bits. mn + step * q is a float32
    multiply and then an add, each rounded, as the packer decided the
    threshold sides: a fused multiply-add (``torch.addcmul`` may be one)
    rounds once and can put a value on the other side."""
    q = (blk_q.to(torch.int32) & 0xFFFF).to(torch.float32)
    deq = qmeta[0] + qmeta[1] * q
    out, of, oq = [], 0, 0
    for kind, w in layout:
        if kind == "f32":
            sl = blk_f[:, of:of + w]
            of += w
        else:
            sl = deq[:, oq:oq + w]
            if kind == "log":
                sl = torch.exp(sl)
            oq += w
        out.append(sl[:, 0] if w == 1 else sl)
    return out


def _unpack_with_levels(blk_f, blk_q, qmeta, layout, dtype) -> list:
    """_unpack_columns_mixed for the sweeps' layouts, whose second and third
    lanes are the top level's pressure and the per-layer differences: the
    fields in ``dtype`` with plev (ncol, nlay+1) summed back in their
    place."""
    play, p0, dplev, *rest = [x.to(dtype) for x in
                              _unpack_columns_mixed(blk_f, blk_q, qmeta, layout)]
    plev = torch.cat([p0[:, None], p0[:, None] + torch.cumsum(dplev, dim=1)], dim=1)
    return [play, plev, *rest]


def _gas_pack_kind(v: np.ndarray) -> str:
    """Quantization kind for a gas lane set: log for strictly positive 2-D
    profiles (the dynamic-range fields), exact f32 for the (ncol,)
    well-mixed scalars (already 1 lane), and linear for zero-containing
    profiles -- UNLESS some lane (one layer across columns) mixes zeros
    with values only a few quantization steps above zero, where the
    absolute step (lane range / 65535) would put >~6% relative error on
    the smallest nonzero VMRs; those travel exact f32."""
    if v.ndim != 2:
        return "f32"
    if np.all(v > 0.0):
        return "log"
    step = (v.max(axis=0) - v.min(axis=0)) / 65535.0
    nz_min = np.where(v > 0.0, v, np.inf).min(axis=0)
    ok = (step == 0.0) | ~np.isfinite(nz_min) | (nz_min >= 8.0 * step)
    return "lin" if bool(np.all(ok)) else "f32"


def _block(a: np.ndarray, start: int, size: int, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[start:start + size])).to(device)


def _synchronize(devices) -> None:
    with span("rte.wait"):
        for d in dict.fromkeys(torch.device(x) for x in devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def _resident_reduce(step_fn, arrays: Sequence[np.ndarray], block_size: int,
                     out_builder, *, device) -> tuple[list, float]:
    """Device-RESIDENT block sweep: every block of every array is staged on
    ``device`` first (and block 0 run once, which builds the kernels at
    first CUDA use), then the timer runs only around the compute and fetch
    loop, so it measures the compute pipeline without the host link.
    Returns (outs, elapsed_s)."""
    ncol = arrays[0].shape[0]
    outs = out_builder(ncol)
    blocks = list(iter_blocks(ncol, block_size))
    dev = [[_block(a, start, size, device) for a in arrays] for start, size in blocks]
    step_fn(*dev[0])
    _synchronize([device])
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    results = [step_fn(*ds) for ds in dev]
    if cuda:  # one synchronize: non-blocking copies into pinned host memory
        fetched = torch.empty(outs[0].shape, dtype=results[0].dtype, pin_memory=True)
        for (start, size), r in zip(blocks, results):
            fetched[start:start + size].copy_(r, non_blocking=True)
        _synchronize([device])
    else:
        fetched = torch.cat(results)
    elapsed = time.perf_counter() - t0
    outs[0][...] = fetched.numpy()
    return outs, elapsed


def _warmup_stream(step_fn, arrays, block_size: int, *, device) -> None:
    """Run the step once on block 0 (which builds the kernels at first CUDA
    use), so that the timed sweep measures steady-state throughput."""
    step_fn(*[_block(a, 0, block_size, device) for a in arrays])
    _synchronize([device])


def _mesh_for(mesh, device) -> Mesh:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        # "cuda" names the current card; its tensors report it by index, and
        # the replicated models and tables are looked up by their device
        device = torch.device("cuda", torch.cuda.current_device())
    if mesh is None:
        return Mesh((device,))
    if mesh.ranks is not None:
        raise ValueError("a process-group mesh: each rank sweeps its own columns "
                         "(parallel.distributed.local_column_slice) with mesh=None")
    if any(d.type != device.type for d in mesh.devices):
        raise ValueError(f"the mesh's devices {list(mesh.devices)} are not all of the "
                         f"sweep's device type {device.type!r}")
    return mesh


def _full_concs(gas_names, gas_vals, ncol: int, nlay: int) -> dict:
    return {g: (v if v.ndim == 2 else v[:, None].expand(ncol, nlay))
            for g, v in zip(gas_names, gas_vals)}


def _run_jobs(jobs, ncol: int, width: int, mesh: Mesh, resident: bool, warmup: bool,
              device) -> tuple[np.ndarray, float, float]:
    """Sweep each job (column index or None for all, step, host arrays,
    block size) and stitch the diagnostics: (ncol, width), the seconds the
    sweeps took and the bytes per column that crossed the host link."""
    if resident and mesh.size > 1:
        # the resident sweep stages its blocks on one device; measuring one
        # device under a mesh would misreport the mesh's throughput
        raise ValueError(
            "resident=True ignores `mesh` (blocks are staged on the "
            "default device); use the streamed path for mesh sweeps")
    builder = lambda n: [np.zeros((n, width), np.float32)]
    out = builder(ncol)[0]
    elapsed, nbytes = 0.0, 0
    for idx, step_fn, arrays, bs in jobs:
        nbytes += sum(a.nbytes for a in arrays)
        if resident:
            sub, el = _resident_reduce(step_fn, arrays, bs, builder, device=device)
        else:
            if warmup:
                for d in dict.fromkeys(mesh.devices):
                    _warmup_stream(step_fn, arrays, bs, device=d)
            t0 = time.perf_counter()
            sub = stream_reduce(step_fn, arrays, bs, builder,
                                sharding=column_sharding(mesh, 2))
            el = time.perf_counter() - t0
        if idx is None:
            out = sub[0]
        else:
            out[idx] = sub[0]
        elapsed += el
    return out, elapsed, nbytes / ncol


# the reason the sweeps' refusals give for fixing the g-128 LW mapping
_LW_BASIS = ("the sweep takes its LW spectral mapping, Planck table and emissivity from the "
             "nets' outputs")


def _f32_job(arrays: Sequence[np.ndarray], body, nfix: int, dtype) -> tuple:
    """A ``precision="f32"`` sweep's (step, host arrays): the fields in
    float32, column-leading, each crossing the host link in its own region
    of a block's staging slot; the step hands a block's fields in ``dtype``
    to ``body``, the first ``nfix`` one by one, then the gases as a list."""
    def step(*fields):
        fields = [x.to(dtype) for x in fields]
        return body(*fields[:nfix], fields[nfix:])

    return step, [a.astype(np.float32, copy=False) for a in arrays]


def _mixed_job(specs, body, nfix: int, mesh: Mesh, dtype) -> tuple:
    """A ``precision="mixed"`` sweep's (step, host arrays): ``specs``
    packed by ``_pack_columns_mixed`` (an exact float32 block and a block
    of uint16 codes), the codes' [mn; step] rows replicated on the mesh;
    the step dequantizes a block on its device (``_unpack_with_levels``)
    and hands the fields to ``body`` as ``_f32_job`` does."""
    packed_f, packed_q, qmeta, layout = _pack_columns_mixed(specs)
    with span("rte.replicate"):
        qm = replicated(mesh).put(torch.from_numpy(qmeta))

    def step(blk_f, blk_q):
        fields = _unpack_with_levels(blk_f, blk_q, qm[blk_f.device], layout, dtype)
        return body(*fields[:nfix], fields[nfix:])

    # the codes travel as their int16 bits (the same two bytes)
    return step, [packed_f, packed_q.view(np.int16)]


def _allsky_body(lw_models, sw_models, cloud_lw, cloud_sw, gas_names, top_at_1: bool,
                 dtype, mesh: Mesh, device):
    """The per-block all-sky step of gcm_sweep_allsky on a block's field
    tensors, with its routes taken (LW and SW each by ``driver_route``);
    returns (ncol, 3) [olr, surface LW down, surface SW down]."""
    with span("rte.check"):
        lw_spec = spectral_for("lw", lw_models, entry="gcm_sweep_allsky",
                               accepts=(lw_spectral_g128,), basis=_LW_BASIS)
        sw_spec = spectral_for("sw", sw_models, entry="gcm_sweep_allsky",
                               accepts=(sw_spectral_g112, sw_spectral_g224),
                               basis="the sweep takes its SW spectral mapping, solar source and "
                                     "albedo from the nets' outputs")
        lw_route = driver_route("gcm_sweep_allsky (LW)", device=device, dtype=dtype, lw=True,
                                models=lw_models)
        sw_route = driver_route("gcm_sweep_allsky (SW)", device=device, dtype=dtype,
                                models=sw_models)
        if sw_route == "megakernel":
            _check_sw_scaling(sw_models)
    first = mesh.devices[0]
    table = PlanckTable.kept(lw_spec.band_lims_wvn_array, device=first, dtype=dtype)
    solar = kept_solar_source(sw_spec, device=first, dtype=dtype)
    with span("rte.replicate"):
        on = replicated(mesh).put((list(lw_models), list(sw_models), table, solar, cloud_lw,
                                   cloud_sw))
    canon = lambda a: fused.lay_major(a, top_at_1)
    # the cores return fluxes in the caller's orientation
    toa, sfc = (0, -1) if top_at_1 else (-1, 0)

    def body(play, plev, tlay, tlev, tsfc, emis, alb, mu0, cloud_col, gas_vals):
        lw_m, sw_m, tab, sol, co_lw, co_sw = on[play.device]
        ncol, nlay = play.shape
        # mu0 arrives signed (cos sza; night <= 0): night columns run with a
        # safe clipped geometry and their SW flux is masked to exact zero
        # (the RFMIP SW driver's night masking, rrtmgp_rfmip_sw.F90:376-380)
        day = (mu0 > 0.0).to(play.dtype)
        mu0 = torch.clamp(mu0, 0.05, 1.0)
        tsfc = tsfc.contiguous()
        # cloud placement on the device from the global-index lane: the four
        # (ncol, nlay) cloud fields never cross the host link
        clouds = make_clouds(play, tlay, co_lw, cloud_col=cloud_col)
        concs = _full_concs(gas_names, gas_vals, ncol, nlay)
        emis_b = emis[:, None].expand(ncol, lw_spec.nband)
        alb_b = alb[:, None].expand(ncol, sw_spec.nband)
        if "megakernel" in (lw_route, sw_route):
            play_t, plev_t, tlay_t, tlev_t, *cld_t = map(canon, (play, plev, tlay, tlev, *clouds))
            concs_t = {g: canon(v) for g, v in concs.items()}
        if lw_route == "megakernel":
            fb_lw = fused.lw_core(lw_m, tab, lw_spec, play_t, plev_t, tlay_t, tlev_t, tsfc,
                                  emis_b, concs_t, (co_lw, cld_t), top_at_1=top_at_1)
        else:
            fb_lw = _allsky_lw_core(lw_m, tab, lw_spec, co_lw, play, plev, tlay, tlev, tsfc,
                                    emis_b, *clouds, concs, top_at_1=top_at_1,
                                    n_gauss_angles=1)
        if sw_route == "megakernel":
            fb_sw = fused.sw_core(sw_m, sw_spec, play_t, plev_t, tlay_t, mu0,
                                  *fused.sw_boundary(sw_spec, sol, alb_b, alb_b), concs_t,
                                  (co_sw, cld_t), top_at_1=top_at_1)
        else:
            fb_sw = _allsky_sw_core_lay_major(sw_m, sw_spec, sol, co_sw, play, plev, tlay, mu0,
                                              alb_b, alb_b, *clouds, concs, top_at_1=top_at_1)
        return torch.stack([fb_lw.flux_up[:, toa], fb_lw.flux_dn[:, sfc],
                            fb_sw.flux_dn[:, sfc] * day], dim=1)

    return body


def _allsky_jobs(host: dict, body, gas_names, block_size: int, precision: str, mesh: Mesh,
                 dtype) -> list:
    """gcm_sweep_allsky's host columns as they cross the host link, with the
    step that runs ``body`` on a block of them: the jobs of ``_run_jobs``.
    Beside the host's fields it makes mu0 and the cloud lane, and with
    ``precision="mixed"`` the quantized block."""
    ncol = host["play"].shape[0]
    # signed mu0 (night <= 0): the body masks night SW to zero
    mu0 = np.cos(np.deg2rad(host["sza"])).astype(np.float32)
    cloud_col = (((np.arange(ncol) + 1) % 3) != 0).astype(np.float32)

    def build_f32(idx):
        sub = (lambda a: a) if idx is None else (lambda a: a[idx])
        return _f32_job([sub(host["play"]), sub(host["plev"]), sub(host["tlay"]),
                         sub(host["tlev"]), sub(host["tsfc"]), sub(host["sfc_emis"]),
                         sub(host["sfc_alb"]), sub(mu0), sub(cloud_col)]
                        + [sub(host[f"gas:{g}"]) for g in gas_names], body, 9, dtype)

    def build_mixed(idx):
        ix = slice(None) if idx is None else idx
        # play and tlay feed make_clouds' placement branches: the sides of
        # play > P_MIN and tlay > T_LIQ (strict), play < P_MAX and
        # tlay < T_ICE (the complements of >=) survive the quantization,
        # so every column keeps the f32 path's cloud regime
        specs = ([(host["play"][ix],
                   ("log", ((CLOUD_P_MIN, ">"), CLOUD_P_MAX))),
                  (host["plev"][ix, :1], "f32"),
                  (np.diff(host["plev"][ix], axis=1), "lin"),
                  (host["tlay"][ix],
                   ("lin", ((CLOUD_T_LIQ, ">"), CLOUD_T_ICE))),
                  (host["tlev"][ix], "lin"),
                  (host["tsfc"][ix], "f32"), (host["sfc_emis"][ix], "f32"),
                  (host["sfc_alb"][ix], "f32"), (mu0[ix], "f32"),
                  (cloud_col[ix], "f32")]
                 + [(host[f"gas:{g}"][ix], _gas_pack_kind(host[f"gas:{g}"]))
                    for g in gas_names])
        return _mixed_job(specs, body, 9, mesh, dtype)

    all_idx = np.arange(ncol)
    if precision == "mixed":
        # grazing-sun day columns (0 < mu0 <= 0.1) take a small exact-f32
        # side sweep: their direct beam's exp(-tau/mu0) amplifies the ~1e-4
        # relative error of a quantized tau to W/m2
        grazing = (mu0 > 0.0) & (mu0 <= 0.1)
        if not grazing.any():
            plan = [(None, build_mixed)]
        else:
            plan = [(all_idx[~grazing], build_mixed)] if (~grazing).any() else []
            plan.append((all_idx[grazing], build_f32))
    elif precision == "f32":
        plan = [(None, build_f32)]
    else:
        raise ValueError(f"precision {precision!r}: 'f32' or 'mixed'")
    jobs = []
    for idx, build in plan:
        n_sub = ncol if idx is None else idx.size
        # a small side job takes a block that fits it
        bs = min(block_size, max(256, -(-n_sub // 256) * 256))
        jobs.append((idx, *build(idx), bs))
    return jobs


def gcm_sweep_allsky(
    host: dict,
    lw_models: Sequence[NNModel],
    sw_models: Sequence[NNModel],
    cloud_lw,
    cloud_sw,
    block_size: int = 65536,
    mesh=None,
    top_at_1: bool = True,
    dtype=torch.float32,
    warmup: bool = False,
    resident: bool = False,
    precision: str = "f32",
    *,
    device,
) -> dict:
    """Full LW+SW ALL-SKY streamed sweep on ``device`` (or over ``mesh``'s
    devices): NN gas optics and the idealized clouds of the all-sky example
    (drivers.allsky.make_clouds, per block on the device), then LW
    no-scattering and SW two-stream, broadband. ``host``: the dict of
    synthesize_gcm_columns. The models and cloud optics live on ``device``:
    LW nets of the g-128 mapping, SW nets of the g-112 or g-224 one (others
    are refused, planck.spectral_for).
    precision='mixed' quantizes the tolerant lanes (see gcm_sweep_lw); the
    grazing day columns (0 < mu0 <= 0.1) then take an exact-f32 side sweep.
    Returns throughput, the host -> device bytes per column and the
    per-column diagnostics (ncol, 3) [olr, surface LW down, surface SW
    down]."""
    with span("rte.gcm.sweep"):
        mesh = _mesh_for(mesh, device)
        gas_names = [k.split(":", 1)[1] for k in host if k.startswith("gas:")]
        body = _allsky_body(lw_models, sw_models, cloud_lw, cloud_sw, gas_names, top_at_1,
                            dtype, mesh, device)
        ncol = host["play"].shape[0]
        with span("rte.pack"):
            jobs = _allsky_jobs(host, body, gas_names, block_size, precision, mesh, dtype)
        diag, elapsed, bytes_per_column = _run_jobs(jobs, ncol, 3, mesh, resident, warmup,
                                                    device)
        olr, lw_sfc_dn, sw_sfc_dn = diag.T
        return {
            "ncol": ncol,
            "elapsed_s": elapsed,
            "columns_per_s": ncol / elapsed,
            "mean_olr": float(olr.mean()),
            "mean_lw_sfc_dn": float(lw_sfc_dn.mean()),
            "mean_sw_sfc_dn": float(sw_sfc_dn.mean()),
            "diagnostics": diag,  # (ncol, 3) per-column [olr, lw_dn, sw_dn]
            "bytes_per_column": bytes_per_column,  # host -> device
        }


def _lw_body(models, gas_names, top_at_1: bool, dtype, mesh: Mesh, device):
    """The per-block step of gcm_sweep_lw on a block's field tensors, with
    its route taken; returns (ncol, 2) [olr, surface LW down]."""
    spectral = spectral_for("lw", models, entry="gcm_sweep_lw", accepts=(lw_spectral_g128,),
                            basis=_LW_BASIS)
    route = driver_route("gcm_sweep_lw", device=device, dtype=dtype, lw=True, models=models)
    table = PlanckTable.kept(spectral.band_lims_wvn_array, device=mesh.devices[0],
                             dtype=dtype)
    on = replicated(mesh).put((list(models), table))
    canon = lambda a: fused.lay_major(a, top_at_1)
    toa, sfc = (0, -1) if top_at_1 else (-1, 0)

    def body(play, plev, tlay, tlev, tsfc, emis, gas_vals):
        ms, tab = on[play.device]
        ncol, nlay = play.shape
        tsfc = tsfc.contiguous()
        concs = _full_concs(gas_names, gas_vals, ncol, nlay)
        emis_b = emis[:, None].expand(ncol, spectral.nband)
        if route == "megakernel":
            fb = fused.lw_core(ms, tab, spectral, canon(play), canon(plev), canon(tlay),
                               canon(tlev), tsfc, emis_b, {g: canon(v) for g, v in concs.items()},
                               top_at_1=top_at_1)
        else:
            fb = _lw_core(ms, tab, spectral, play, plev, tlay, tlev, tsfc, emis_b, concs,
                          top_at_1=top_at_1, n_gauss_angles=1)
        return torch.stack([fb.flux_up[:, toa], fb.flux_dn[:, sfc]], dim=1)

    return body


def gcm_sweep_lw(
    host: dict,
    models: Sequence[NNModel],
    block_size: int = 65536,
    mesh=None,
    top_at_1: bool = True,
    dtype=torch.float32,
    warmup: bool = False,
    resident: bool = False,
    precision: str = "f32",
    *,
    device,
) -> dict:
    """Streamed LW clear-sky sweep on ``device`` (or over ``mesh``'s
    devices); returns throughput, the host -> device bytes per column and
    the per-column diagnostics (ncol, 2) [olr, surface LW down]. The models
    live on ``device``, LW nets of the g-128 mapping (others are refused,
    planck.spectral_for).

    precision='mixed' halves the streamed bytes per column by uint16
    quantizing the tolerant lanes on the host (temperatures to ~0.002 K,
    log-pressure and log-VMR lanes to ~2e-4 relative; plev travels as an
    exact f32 top level plus quantized per-layer deltas, summed again on
    the device so col_dry sees the quantized deltas directly)."""
    mesh = _mesh_for(mesh, device)
    gas_names = [k.split(":", 1)[1] for k in host if k.startswith("gas:")]
    body = _lw_body(models, gas_names, top_at_1, dtype, mesh, device)

    if precision == "mixed":
        specs = ([(host["play"], "log"),
                  (host["plev"][:, :1], "f32"),
                  (np.diff(host["plev"], axis=1), "lin"),
                  (host["tlay"], "lin"), (host["tlev"], "lin"),
                  (host["tsfc"], "f32"), (host["sfc_emis"], "f32")]
                 + [(host[f"gas:{g}"], _gas_pack_kind(host[f"gas:{g}"]))
                    for g in gas_names])
        step, arrays = _mixed_job(specs, body, 6, mesh, dtype)
    elif precision == "f32":
        step, arrays = _f32_job([host["play"], host["plev"], host["tlay"], host["tlev"],
                                 host["tsfc"], host["sfc_emis"]]
                                + [host[f"gas:{g}"] for g in gas_names], body, 6, dtype)
    else:
        raise ValueError(f"precision {precision!r}: 'f32' or 'mixed'")
    ncol = host["play"].shape[0]
    diag, elapsed, bytes_per_column = _run_jobs([(None, step, arrays, block_size)], ncol,
                                                2, mesh, resident, warmup, device)
    olr, sfc_dn = diag.T
    return {
        "ncol": ncol,
        "elapsed_s": elapsed,
        "columns_per_s": ncol / elapsed,
        "mean_olr": float(olr.mean()),
        "mean_sfc_dn": float(sfc_dn.mean()),
        "diagnostics": diag,  # (ncol, 2) per-column [olr, sfc_dn]
        "bytes_per_column": bytes_per_column,  # host -> device
    }
