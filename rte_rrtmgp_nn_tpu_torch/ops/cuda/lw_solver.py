"""LW no-scattering broadband transport in one CUDA kernel
(``csrc/lw_noscat.cu``, K7), and its plain PyTorch twins.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py::
lw_noscat_broadband_pallas (``_down_kernel``, ``_up_kernel``,
``_layer_step``), which the JAX package calls once per angle. What bounds
the kernel on an H100 and how its design answers it is written at the top of
the CUDA source: one block takes one column with every angle of the call,
several threads per g-point each own a run of layers and combine their
affine maps, the fields are read once, and each layer's transmittance and
upward source is computed once and kept in shared memory for the up sweep. Two modes:

- ``lw_noscat_broadband_angles``: tau and the sources, 1-4 Gauss angles (or
  one angle with per-(column, g-point) secants), summed in angle order;
  ``lw_noscat_broadband`` is its one-angle call with an incident radiance;
- ``lw_broadband_sweeps_kernel``: the two sweeps alone on the layer-major
  transmittance and sources that K6 (``lw_prep``) writes.

``lw_noscat_plan`` decides the geometry (threads per g-point, layers per
thread, the tiers kept in shared memory) from the shapes; the launch entry
checks it again. Each wrapper
launches the kernel for CUDA tensors and runs its plain twin for CPU
tensors; it never falls back on CUDA. ``LAUNCHES`` counts kernel launches,
``MODE_LAUNCHES`` by mode.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ...config import refuse_grad, tau_thresh_for
from ..lw_solver import (LW_DIFFUSIVITY, LW_WEIGHT, LWSolution, lw_broadband_sweeps,
                         noscat_broadband_1angle)
from . import build
from .lw_megakernel import MAX_SMEM, _check, _smem_limit

LAUNCHES = 0  # kernel launches, both modes (not plain-path calls)
MODE_LAUNCHES = {"angles": 0, "fields": 0}
MODE_CODES = {"angles": 0, "fields": 1}  # csrc/lw_noscat.cu kModeAngles, kModeFields
MAX_NGPT = 256  # one thread per g-point (csrc/lw_noscat.cu kMaxGpt)
MAX_ANGLES = build.MAX_ANGLES
SEG_LAYERS = (4, 8, 16)  # layers a thread walks, one kernel instance each


def seg_layers_for(nang: int) -> int:
    """The layers a thread walks by default: 8 for one angle; 4 for more, so
    that a thread's src_dn (layers x angles) stays in registers at the 64 a
    thread that 1024 threads an SM leave."""
    return 8 if nang == 1 else 4


class NoscatPlan(NamedTuple):
    """K7's launch geometry (csrc/lw_noscat.cu NoscatPlan): ``segments``
    threads per g-point (``threads`` = segments x ngpt rounded up to a
    warp), each walking ``seg_layers`` layers; the layers go in tiers of
    segments x seg_layers, and the bottom ``kept_tiers`` keep each layer's
    transmittance and upward source in shared memory for the up sweep (the
    tiers above recompute theirs there)."""

    threads: int
    seg_layers: int
    segments: int
    kept_tiers: int
    angles: int
    smem_bytes: int


def max_threads(seg_layers: int) -> int:
    """Threads per block of the instance (csrc noscat_max_threads): threads
    x seg_layers within a register budget of 8192, at most 1024."""
    return min(8192 // seg_layers, 1024)


def tiers(nlay: int, tier: int) -> int:
    return -(-nlay // tier)


def kept_layers(nlay: int, tier: int, kept: int) -> int:
    """Layers whose rows stay in shared memory (csrc noscat_kept_layers)."""
    return max(nlay - (tiers(nlay, tier) - kept) * tier, 0)


def smem_floats(nlay: int, gp: int, nang: int, seg_layers: int, segments: int,
                kept: int) -> int:
    """Shared memory of a plan in floats (csrc noscat_smem_floats): the kept
    rows and a scratch tier, the segments' composite maps, the radiance
    carried between tiers and the per-warp partial sums of a tier's levels."""
    tier = seg_layers * segments
    return ((kept_layers(nlay, tier, kept) + (tier if kept < tiers(nlay, tier) else 0))
            * 2 * nang * gp + segments * nang * 2 * gp + 2 * nang * gp
            + (tier + 1) * nang * (gp // 32))


SM_SMEM = 233472  # shared memory of an SM, 1 KB of it reserved per resident block
SM_THREADS = 2048
RESIDENT_THREADS = 1024  # what the registers hold at 64 a thread


def resident(plan: NoscatPlan) -> tuple[int, int]:
    """(threads, blocks) of a plan an SM keeps resident, by its shared
    memory and threads, at up to 64 registers a thread."""
    blocks = min(SM_SMEM // (plan.smem_bytes + 1024), SM_THREADS // plan.threads,
                 max(RESIDENT_THREADS // plan.threads, 1))
    return plan.threads * blocks, blocks


def lw_noscat_plan(nlay: int, ngpt: int, nang: int = 1, smem_limit: int = MAX_SMEM,
                   seg_layers: int | None = None,
                   segments: int | None = None) -> NoscatPlan:
    """K7's geometry for a column of ``nlay`` layers and ``ngpt`` g-points
    walked at ``nang`` angles (the fields mode is one angle), each thread
    walking ``seg_layers`` layers (None: seg_layers_for(nang)). For each
    number of segments (or only ``segments``, a tuning knob) the most
    bottom tiers whose rows fit ``smem_limit`` are kept; of those plans the
    one that keeps every layer's rows, then keeps the most threads resident
    on an SM, then the most blocks (one column's load overlaps another's
    walk), wins. Raises ValueError in words for a shape the kernel does not
    take."""
    if not 1 <= ngpt <= MAX_NGPT:
        raise ValueError(f"lw_noscat_broadband: ngpt {ngpt} outside 1..{MAX_NGPT}")
    if not 1 <= nang <= MAX_ANGLES:
        raise ValueError(f"lw_noscat_broadband: {nang} angles outside 1..{MAX_ANGLES}")
    if nlay < 1:
        raise ValueError(f"lw_noscat_broadband: {nlay} layers")
    seg_layers = seg_layers or seg_layers_for(nang)
    if seg_layers not in SEG_LAYERS:
        raise ValueError(f"lw_noscat_broadband: seg_layers {seg_layers} not in {SEG_LAYERS}")
    gp = -(-ngpt // 32) * 32
    most = min(-(-nlay // seg_layers), max_threads(seg_layers) // gp)
    best, best_score = None, None
    for nseg in ([min(segments, most)] if segments else range(most, 0, -1)):
        n_tiers = tiers(nlay, seg_layers * nseg)
        for kept in range(n_tiers, -1, -1):
            floats = smem_floats(nlay, gp, nang, seg_layers, nseg, kept)
            if 4 * floats <= smem_limit:
                plan = NoscatPlan(gp * nseg, seg_layers, nseg, kept, nang, 4 * floats)
                score = (kept == n_tiers, *resident(plan))
                if best is None or score > best_score:
                    best, best_score = plan, score
                break
    if best is None:
        raise ValueError(f"lw_noscat_broadband: no geometry of {ngpt} g-points x {nang} "
                         f"angles fits {smem_limit} B")
    return best


def _secants(d_secant, tau):
    ncol, _, ngpt = tau.shape
    if torch.is_tensor(d_secant):
        return d_secant
    return torch.full((ncol, ngpt), float(d_secant), dtype=tau.dtype, device=tau.device)


def lw_noscat_broadband_plain(
    tau: torch.Tensor,         # (ncol, nlay, ngpt)
    lay_source: torch.Tensor,  # (ncol, nlay, ngpt)
    lev_source: torch.Tensor,  # (ncol, nlay+1, ngpt)
    sfc_emis: torch.Tensor,    # (ncol, ngpt)
    sfc_source: torch.Tensor,  # (ncol, ngpt)
    d_secant=LW_DIFFUSIVITY,   # scalar or (ncol, ngpt)
    weight: float = LW_WEIGHT,
    inc_rad=None,              # (ncol, ngpt) incident radiance, flux / (2 pi w)
):
    """The kernel's function at one angle in tensor ops: exact exponential,
    linear-in-tau source, canonical top-at-0. Returns broadband (flux_up,
    flux_dn), each (ncol, nlay+1)."""
    sol = noscat_broadband_1angle(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                  _secants(d_secant, tau), weight, inc_rad,
                                  fast_exp=False, pade=False)
    return sol.flux_up, sol.flux_dn


def lw_noscat_broadband_angles_plain(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                     secants, weights: Sequence[float], inc_flux=None):
    """The angles mode in tensor ops: lw_noscat_broadband_plain per angle,
    each from the incident radiance ``inc_flux`` / (2 pi w), summed in
    angle order (ops/lw_solver.py lw_solver_noscat's sum). ``secants``: a
    sequence of scalars, one per weight, or one (ncol, ngpt) tensor for a
    single weight. Returns broadband (flux_up, flux_dn)."""
    per_angle = [secants] if torch.is_tensor(secants) else list(secants)
    if len(per_angle) != len(weights):
        raise ValueError(f"lw_noscat_broadband_angles: {len(per_angle)} secants, "
                         f"{len(weights)} weights")
    up = dn = 0
    for d, w in zip(per_angle, weights):
        inc = None if inc_flux is None else inc_flux / (2.0 * np.pi * w)
        u, v = lw_noscat_broadband_plain(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                         d, w, inc)
        up, dn = up + u, dn + v
    return up, dn


def lw_noscat_broadband_angles(tau, lay_source, lev_source, sfc_emis, sfc_source, secants,
                               weights: Sequence[float], inc_flux=None):
    """LW no-scattering broadband transport summed over 1-4 angles in one
    launch; arguments as lw_noscat_broadband_angles_plain. tau and the
    sources may have any column and layer strides (g-points contiguous).
    CPU tensors take the plain twin; CUDA float32 tensors launch the kernel;
    anything else raises."""
    if tau.device.type == "cpu":
        return lw_noscat_broadband_angles_plain(tau, lay_source, lev_source, sfc_emis,
                                                sfc_source, secants, weights, inc_flux)
    return _launch(tau, lay_source, lev_source, sfc_emis, sfc_source, secants, weights,
                   inc_flux)


def lw_noscat_broadband(tau, lay_source, lev_source, sfc_emis, sfc_source,
                        d_secant=LW_DIFFUSIVITY, weight=LW_WEIGHT, inc_rad=None):
    """The transport at one angle with an incident radiance; arguments as
    lw_noscat_broadband_plain. CPU tensors take the plain twin; CUDA float32
    tensors launch the kernel's angles mode; anything else raises."""
    if tau.device.type == "cpu":
        return lw_noscat_broadband_plain(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                         d_secant, weight, inc_rad)
    secants = d_secant if torch.is_tensor(d_secant) else [d_secant]
    return _launch(tau, lay_source, lev_source, sfc_emis, sfc_source, secants, [weight],
                   inc_rad, inc_is_radiance=True)


def lw_broadband_sweeps_kernel(trans, src_dn, src_up, sfc_emis, sfc_source) -> LWSolution:
    """The two broadband sweeps (weight 1/2, no incident radiance) on
    layer-major (nlay, ncol, ngpt) transmittance and sources, as K6 writes
    them. CPU tensors take the twin, ops/lw_solver.lw_broadband_sweeps;
    CUDA float32 tensors launch the kernel's fields mode; anything else
    raises."""
    if trans.device.type == "cpu":
        return lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source)
    up, dn = _launch_fields(trans, src_dn, src_up, sfc_emis, sfc_source)
    return LWSolution(up, dn)


def _strided(name, t, shape, lay_dim, dev) -> tuple[int, int]:
    """Check a 3-d field (float32 on ``dev``, ``shape``, g-points
    contiguous) and return its (column, layer) strides in elements."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected torch.float32 on {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1 and shape[-1] > 1:
        raise ValueError(f"{name}: g-points not contiguous (strides {t.stride()})")
    return t.stride(1 - lay_dim), t.stride(lay_dim)


def _run(mode, dev, fields, lay_dim, sfc_emis, sfc_source, nang, fill, extra=()):
    """Check the arguments common to both modes, launch and count; ``fill``
    sets the mode's fields of the NoscatArgs; ``extra``: the mode's other
    tensors, for the gradient refusal. Returns (flux_up, flux_dn)."""
    global LAUNCHES
    refuse_grad(f"lw_noscat_broadband[{mode}]", [t for _, t in fields], sfc_emis, sfc_source,
                extra)
    index, stream = build.launch_target("lw_noscat_broadband", dev)
    f32 = torch.float32
    f0 = fields[0][1]
    nlay, ngpt = f0.shape[lay_dim], f0.shape[-1]
    ncol = f0.shape[1 - lay_dim]
    plan = lw_noscat_plan(nlay, ngpt, nang, _smem_limit(dev))
    args = build.NoscatArgs(ncol=ncol, nlay=nlay, ngpt=ngpt, nang=nang,
                            tau_thresh=tau_thresh_for(f32))
    lev = 1 if mode == "angles" else 0
    for k, (name, t) in enumerate(fields):
        shape = [ncol, ncol, ngpt]
        shape[lay_dim] = nlay + (lev if k == 2 else 0)
        cs, ls = _strided(name, t, shape, lay_dim, dev)
        setattr(args, f"f{k}", t.data_ptr())
        setattr(args, f"col_stride{k}", cs)
        setattr(args, f"lay_stride{k}", ls)
    for name, t in (("sfc_emis", sfc_emis), ("sfc_source", sfc_source)):
        _check(name, t, (ncol, ngpt), f32, dev)
    args.emis, args.sfc = sfc_emis.data_ptr(), sfc_source.data_ptr()
    fill(args, ncol, ngpt)
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    args.up, args.dn = up.data_ptr(), dn.data_ptr()
    err = build.library().lw_noscat_broadband_launch(
        ctypes.byref(args), ctypes.byref(build.NoscatPlan(*plan)), MODE_CODES[mode], index, stream)
    build.check(err, f"lw_noscat_broadband launch ({mode})")
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    return up, dn


def _launch(tau, lay_source, lev_source, sfc_emis, sfc_source, secants, weights, inc=None,
            inc_is_radiance=False):
    """The angles mode: ``inc`` is an incident flux (each angle starts from
    inc / (2 pi w)) or, with ``inc_is_radiance``, the one angle's radiance.
    Returns (flux_up, flux_dn)."""
    dev, f32 = tau.device, torch.float32
    per_g = torch.is_tensor(secants)
    nang = 1 if per_g else len(secants)
    if len(weights) != nang:
        raise ValueError(f"lw_noscat_broadband_angles: {nang} secants, {len(weights)} weights")

    def fill(args, ncol, ngpt):
        two_pi_w = [2.0 * np.pi * float(w) for w in weights]
        for k in range(nang):
            args.two_pi_w[k] = two_pi_w[k]
            args.inc_div[k] = 1.0 if inc_is_radiance else two_pi_w[k]
            if not per_g:
                args.secant[k] = float(secants[k])
        if per_g:
            _check("secants", secants, (ncol, ngpt), f32, dev)
            args.ds = secants.data_ptr()
        if inc is not None:
            _check("inc", inc, (ncol, ngpt), f32, dev)
            args.inc = inc.data_ptr()

    fields = (("tau", tau), ("lay_source", lay_source), ("lev_source", lev_source))
    return _run("angles", dev, fields, 1, sfc_emis, sfc_source, nang, fill,
                (secants if per_g else None, inc))


def _launch_fields(trans, src_dn, src_up, sfc_emis, sfc_source):
    """The fields mode at weight 1/2. Returns (flux_up, flux_dn)."""
    def fill(args, ncol, ngpt):
        args.two_pi_w[0] = 2.0 * np.pi * LW_WEIGHT
        args.inc_div[0] = 1.0

    fields = (("trans", trans), ("src_dn", src_dn), ("src_up", src_up))
    return _run("fields", trans.device, fields, 0, sfc_emis, sfc_source, 1, fill)
