"""Fused LW pipeline: NN gas optics + optional cloud absorption + Planck
sources + the no-scattering broadband transport in one CUDA kernel
(``csrc/lw_megakernel.cu``), and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_clearsky_mega4
(the Pallas ``_mega4_kernel`` with its cloud options) and
::lw_clearsky_mega5 (``_mega5_kernel``: the same pipeline on raw input
lanes; its ``mxu_first`` variant is the same arithmetic, so one raw-lane
mode covers both). What bounds the kernel on an H100 and how its design
answers it is written at the top of the CUDA source: the MLP's load
instructions bound it, so a thread keeps a register tile of rows x output
columns; the per-layer fields stay in shared memory, one block per column,
up to four layer groups of one thread per g-point each. ``launch_plan``
decides that geometry (threads, groups, shared memory) from the shapes; the
launch entry checks it again.

The kernel has four modes: clear-sky; clouds from (lwp, iwp, rel, rei)
through the lookup tables inside the kernel (``cld_fields`` + ``cld_lut``);
clouds as band lanes of absorption tau (``cld_tau_band``); and clear-sky on
raw lanes (``lw_clearsky_mega5``). ``lw_clearsky_mega4`` /
``lw_clearsky_mega5`` launch the kernel for CUDA tensors and run their
``_plain`` twins for CPU tensors; they never fall back on CUDA.
``LAUNCHES`` counts kernel launches, ``MODE_LAUNCHES`` the same launches by
mode.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...config import megakernel_model_ok, refuse_grad, tau_thresh_for
from ...extensions.cloud_optics import lut_lerp
from ...gasoptics.planck import PlanckTable
from ...models.network import NNModel
from ..lw_solver import (LW_DIFFUSIVITY, LW_WEIGHT, lw_broadband_sweeps, source_fact,
                         transmittance)
from . import build

LAUNCHES = 0  # kernel launches by the wrappers here (not plain-path calls)
# the same launches by kernel mode (csrc/common.cuh MegaMode)
MODE_LAUNCHES = {"clear": 0, "cld_lut": 0, "cld_bands": 0, "lanes": 0}
MODE_CODES = {"clear": 0, "cld_lut": 1, "cld_bands": 2, "lanes": 3}
MAX_LANES = build.MAX_LANES
# the kernels' geometry constants (csrc/common.cuh)
GROUP_THREADS = 128   # kGroup: threads of one layer group, one per g-point
MAX_GROUPS = 4        # kMaxGroups
ROWS_PER_PASS = 16    # kMegaRows: layers per MLP pass of a group
ROW_PAD = 4           # kRowPad: kRowStride = kMegaRows + kRowPad floats from one k to the next
GROUP_CHOICES = (4, 2, 1)  # layer groups a plan may take, the most that fit
MAX_SLAB_FLOATS = 6144     # 24 KB: each of the two buffers the LW weights stream through
MIN_SLAB_ROWS = 4          # rows of the widest layer a slab holds at least
MAX_SMEM = 232448     # kMaxSmem: dynamic shared memory a block may use on sm_90


class LaunchPlan(NamedTuple):
    """A fused kernel's launch geometry (csrc/common.cuh MegaPlan): layer
    group i takes layers [i * layers_per_group, (i + 1) * layers_per_group)
    cut at nlay, ``rows_per_pass`` of them per MLP pass; ``slab_floats`` is
    the size of each of the two shared-memory buffers the weights stream
    through (0: the kernel reads them through the cache)."""
    threads: int
    groups: int
    layers_per_group: int
    rows_per_pass: int
    smem_bytes: int
    slab_floats: int = 0


def _align4(n: int) -> int:
    return (n + 3) & ~3


def plan_groups(what: str, nlay: int, ngpt: int, field_floats: int, group_rows: int,
                other_floats: int, smem_limit: int, stream_widths=()) -> LaunchPlan:
    """The plan with the most layer groups (4, 2 or 1, none without a
    layer) whose shared memory fits ``smem_limit``: ``field_floats`` for
    the per-layer fields, ``group_rows`` k-major rows of MLP scratch (the
    features and the hidden layers' widths) per group, and, if the kernel
    streams its weights (``stream_widths``: the layers' output widths), two
    slabs of what is left, up to MAX_SLAB_FLOATS each and at least
    MIN_SLAB_ROWS rows of the widest layer. Raises ValueError saying what
    does not fit."""
    group_floats = (ROWS_PER_PASS + ROW_PAD) * group_rows
    if nlay < 1 or ngpt < 1:
        raise ValueError(f"{what}: nlay {nlay} and ngpt {ngpt} must be positive")
    if ngpt > GROUP_THREADS:
        raise ValueError(f"{what}: ngpt {ngpt} > {GROUP_THREADS}, a layer group has one thread "
                         "per g-point")
    min_slab = MIN_SLAB_ROWS * max(stream_widths, default=0)
    for groups in GROUP_CHOICES:
        if groups > 1 and groups > nlay:
            continue
        smem = 4 * (groups * group_floats + other_floats + field_floats)
        slab = min(MAX_SLAB_FLOATS, (smem_limit - smem) // 8 & ~3) if stream_widths else 0
        if smem <= smem_limit and slab >= min_slab:
            return LaunchPlan(groups * GROUP_THREADS, groups, -(-nlay // groups), ROWS_PER_PASS,
                              smem + 8 * slab, slab)
    fields = 4 * (field_floats + other_floats)
    if fields > smem_limit:
        raise ValueError(
            f"{what}: the per-layer fields of nlay {nlay} x ngpt {ngpt} take {fields} B of "
            f"shared memory, a block may use {smem_limit}: too many layers for the fused "
            "kernel (the staged path takes any nlay)")
    raise ValueError(
        f"{what}: the net is too wide: the MLP scratch of one layer group takes "
        f"{4 * group_floats} B and the weights' two buffers {8 * min_slab} B beside {fields} B "
        f"of per-layer fields (nlay {nlay} x ngpt {ngpt}), a block may use {smem_limit} B of "
        "shared memory")


def launch_plan(nlay: int, n2d: int, h1: int, h2: int, ngpt: int,
                smem_limit: int = MAX_SMEM) -> LaunchPlan:
    """Launch geometry of the LW kernel for ``nlay`` layers, ``n2d``
    layer-varying features, hidden widths ``h1`` and ``h2`` and ``ngpt``
    g-points: three fields of nlay x ngpt floats (one with a row more), the
    column's per-layer scalars, per group the k-major feature rows and two
    hidden layers, and the two buffers the weights stream through. Raises
    ValueError in words when the shape does not fit the shared memory or
    the 128 g-points of a group."""
    return plan_groups("lw_clearsky_mega4", nlay, ngpt, 3 * nlay * ngpt + ngpt,
                       n2d + h1 + h2, _align4(h1) + _align4(7 * nlay + 1), smem_limit,
                       stream_widths=(h1, h2, 2 * ngpt))


def cloud_lut_phases(cld_fields, cld_lut):
    """Both phases' (tau, tau*ssa, tau*ssa*g) at band resolution from the
    (lwp, iwp, rel, rei) fields and a ``CloudOptics.lut_pack``: the kernels'
    lookup, in tensor ops."""
    lwp, iwp, rel, rei = cld_fields
    liq, ice, (liq_off, liq_step, ice_off, ice_step) = cld_lut
    return (lut_lerp(lwp, rel, liq.to(lwp.dtype), liq_off, liq_step),
            lut_lerp(iwp, rei, ice.to(iwp.dtype), ice_off, ice_step))


def _softsign(x):
    return x / (1.0 + torch.abs(x))


def _lw_plain(model, h1_pre, col_dry_d, tau_cld, tlay, tlev, tsfc,
              planck_table, gpt2band, sfc_emis, weight):
    """The pipeline after the first layer's pre-activation ``h1_pre``
    (nlay, ncol, h): ``col_dry_d(y8, tau_cld)`` turns the net's (ystd*y +
    ymean)**8 into the optical depth along the diffusivity angle (the modes
    group that product differently)."""
    ngpt = model.n_outputs // 2
    _, w2, w3 = model.weights
    _, b2, b3 = model.biases
    h = _softsign(h1_pre)
    h = _softsign(h @ w2 + b2)
    y = h @ w3 + b3
    yt = model.output_std[:ngpt] * y[..., :ngpt] + model.output_mean[:ngpt]
    y2 = yt * yt
    y4 = y2 * y2
    tl = col_dry_d(y4 * y4, tau_cld)
    pf = y[..., ngpt:] * y[..., ngpt:]

    trans = transmittance(tl)
    two_fact = 2.0 * source_fact(tl, trans, tau_thresh_for(torch.float32))
    idx = gpt2band.long()
    lay = pf * planck_table.interpolate(tlay)[..., idx]
    b_lev = planck_table.interpolate(tlev)[..., idx]
    lev_t = pf * b_lev[:-1]
    # level below each layer: the next layer's level-top source; the bottom
    # layer takes its own fraction at the bottom level
    lev_b = torch.cat([lev_t[1:], (pf[-1] * b_lev[-1])[None]], dim=0)
    one_m_t = 1.0 - trans
    src_dn = one_m_t * lev_b + two_fact * (lay - lev_b)
    src_up = one_m_t * lev_t + two_fact * (lay - lev_t)
    sfc_source = pf[-1] * planck_table.interpolate(tsfc)[..., idx]
    sol = lw_broadband_sweeps(trans, src_dn, src_up, sfc_emis, sfc_source,
                              weight=weight)
    return sol.flux_up, sol.flux_dn


def lw_clearsky_mega4_plain(
    model: NNModel,
    x2d: torch.Tensor,          # (nlay, ncol, n2d) scaled layer-varying features
    const_feats: torch.Tensor,  # (ncol, nc) scaled per-column constant features
    w1a: torch.Tensor,          # (n2d, h) first-layer rows of the lanes
    w1c: torch.Tensor,          # (nc, h) first-layer rows of the const block
    col_dry: torch.Tensor,      # (nlay, ncol)
    tlay: torch.Tensor,         # (nlay, ncol) [K]
    tlev: torch.Tensor,         # (nlay+1, ncol) [K]
    tsfc: torch.Tensor,         # (ncol,) [K]
    planck_table: PlanckTable,
    gpt2band: torch.Tensor,     # (ngpt,) int band of each g-point
    sfc_emis: torch.Tensor,     # (ncol, ngpt)
    d_secant: float = LW_DIFFUSIVITY,
    weight: float = LW_WEIGHT,
    cld_tau_band=None,          # (nlay, ncol, nband) cloud absorption tau, or None
    cld_fields=None,            # (lwp, iwp, rel, rei), each (nlay, ncol); needs cld_lut
    cld_lut=None,               # CloudOptics.lut_pack, on the fields' device
):
    """The kernel's function in tensor ops. Canonical top-at-0, single
    angle, zero incident flux, exact exponential and linear-in-tau source.
    With clouds the band absorption tau (given, or tau - tau*ssa per phase
    from the lookup tables) is expanded to g-points and added to the gas
    tau before the diffusivity factor. Returns broadband (flux_up,
    flux_dn), each (ncol, nlay+1)."""
    tau_cld = None
    if cld_fields is not None:
        if cld_lut is None:
            raise ValueError("cld_fields requires cld_lut (CloudOptics.lut_pack)")
        (lt, lts, _), (it, its, _) = cloud_lut_phases(cld_fields, cld_lut)
        tau_cld = (lt - lts) + (it - its)
    elif cld_tau_band is not None:
        tau_cld = cld_tau_band
    if tau_cld is None:
        group = lambda y8, _: y8 * col_dry[..., None] * d_secant
    else:
        tau_cld = tau_cld[..., gpt2band.long()]
        group = lambda y8, tc: (y8 * col_dry[..., None] + tc) * d_secant
    h1_pre = x2d @ w1a + (const_feats @ w1c)[None] + model.biases[0]
    return _lw_plain(model, h1_pre, group, tau_cld, tlay, tlev, tsfc,
                     planck_table, gpt2band, sfc_emis, weight)


def scale_raw_lanes(lanes, tf_codes, scale_rows) -> list:
    """Raw lanes -> the scaled (nlay, ncol) features, as the raw-lane
    kernel mode makes them: transform by code (0 identity, 1 log, 2 fourth
    root), then (x - min) * inv with scale_rows = [min; 1 / (max - min)]."""
    out = []
    for k, (x, code) in enumerate(zip(lanes, tf_codes)):
        if code == 1:
            x = torch.log(x)
        elif code == 2:
            x = torch.sqrt(torch.sqrt(x))
        out.append((x - scale_rows[0, k]) * scale_rows[1, k])
    return out


def lw_clearsky_mega5_plain(
    model: NNModel,
    lanes,                      # n2d RAW (nlay, ncol) lanes; lanes[0] is tlay
    tf_codes,                   # per-lane transform: 0 identity, 1 log, 2 x**(1/4)
    scale_rows: torch.Tensor,   # (2, n2d) [input_min; 1 / (max - min)]
    const_feats: torch.Tensor,  # (ncol, nc) SCALED per-column constant features
    w1a: torch.Tensor,
    w1c: torch.Tensor,
    col_dry: torch.Tensor,      # (nlay, ncol)
    tlev: torch.Tensor,         # (nlay+1, ncol) [K]
    tsfc: torch.Tensor,         # (ncol,) [K]
    planck_table: PlanckTable,
    gpt2band: torch.Tensor,
    sfc_emis: torch.Tensor,
    d_secant: float = LW_DIFFUSIVITY,
    weight: float = LW_WEIGHT,
):
    """The raw-lane mode's function in tensor ops: lw_clearsky_mega4_plain
    with the feature transform and scaling done here and the layer
    temperature read from lane 0; the first layer accumulated lane by
    lane on top of the const block's share and the bias, and tau = y**8 *
    (col_dry * D): the raw-lane Pallas kernel's order and grouping.
    Clear-sky only."""
    h1_pre = ((const_feats @ w1c) + model.biases[0])[None]
    for k, xs in enumerate(scale_raw_lanes(lanes, tf_codes, scale_rows)):
        h1_pre = h1_pre + xs[..., None] * w1a[k]
    group = lambda y8, _: y8 * (col_dry * d_secant)[..., None]
    return _lw_plain(model, h1_pre, group, None, lanes[0], tlev, tsfc,
                     planck_table, gpt2band, sfc_emis, weight)


def _smem_limit(dev) -> int:
    """Dynamic shared memory one block may opt into on ``dev``."""
    props = torch.cuda.get_device_properties(dev)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(mode, model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev, tsfc,
            planck_table, gpt2band, sfc_emis, d_secant, weight, *, cld_fields=None,
            cld_lut=None, cld_tau_band=None, lanes=None, tf_codes=None, scale_rows=None):
    """Check every tensor the mode reads, launch the kernel on the current
    stream and count the launch. ``x2d`` and ``tlay`` are None in the lanes
    mode (the kernel reads the lanes)."""
    global LAUNCHES
    what = f"lw_clearsky_mega4[{mode}]"
    refuse_grad(what, model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev, tsfc, sfc_emis,
                d_secant, cld_fields, cld_tau_band, lanes, scale_rows)
    dev = (lanes[0] if mode == "lanes" else x2d).device
    index, stream = build.launch_target(what, dev)
    if not megakernel_model_ok([model]):
        raise NotImplementedError(
            "lw_clearsky_mega4 hard-codes a 3-layer softsign/softsign/linear "
            "net; other models take the staged path (fused_predict_lw_both)")
    f32 = torch.float32
    nlay, ncol = col_dry.shape
    n2d = w1a.shape[0]
    nc = const_feats.shape[1]
    w1, w2, w3 = model.weights
    b1, b2, b3 = model.biases
    h1, h2 = w1.shape[1], w2.shape[1]
    ngpt = w3.shape[1] // 2
    ntab, nband = planck_table.totplnk.shape
    plan = launch_plan(nlay, n2d, h1, h2, ngpt, _smem_limit(dev))
    checks = [
        ("const_feats", const_feats, (ncol, nc)),
        ("w1a", w1a, (n2d, h1)), ("w1c", w1c, (nc, h1)), ("b1", b1, (h1,)),
        ("w2", w2, (h1, h2)), ("b2", b2, (h2,)), ("w3", w3, (h2, 2 * ngpt)),
        ("b3", b3, (2 * ngpt,)), ("output_mean", model.output_mean, (2 * ngpt,)),
        ("output_std", model.output_std, (2 * ngpt,)),
        ("col_dry", col_dry, (nlay, ncol)),
        ("tlev", tlev, (nlay + 1, ncol)), ("tsfc", tsfc, (ncol,)),
        ("sfc_emis", sfc_emis, (ncol, ngpt)),
        ("totplnk", planck_table.totplnk, (ntab, nband)),
        ("totplnk_diff", planck_table.totplnk_diff, (ntab - 1, nband)),
    ]
    p = lambda t: t.data_ptr()
    cloud = lane_list = None
    # mode_fields: the LwArgs fields only this mode reads
    if mode == "lanes":
        if len(lanes) != n2d or len(tf_codes) != n2d:
            raise ValueError(f"{what}: {len(lanes)} lanes and {len(tf_codes)} codes for "
                             f"{n2d} first-layer rows")
        if n2d > MAX_LANES:
            raise ValueError(f"{what}: {n2d} lanes, the kernel takes {MAX_LANES}")
        checks += [(f"lanes[{k}]", t, (nlay, ncol)) for k, t in enumerate(lanes)]
        checks.append(("scale_rows", scale_rows, (2, n2d)))
        lane_list = build.lane_list(lanes, tf_codes)
        mode_fields = dict(tlay=p(lanes[0]), scale=p(scale_rows))
    else:
        checks += [("x2d", x2d, (nlay, ncol, n2d)), ("tlay", tlay, (nlay, ncol))]
        mode_fields = dict(x=p(x2d), tlay=p(tlay))
    if mode == "cld_lut":
        liq, ice, geom = cld_lut
        n_liq, n_ice = liq.shape[0], ice.shape[0]
        names = ("lwp", "iwp", "rel", "rei")
        checks += [(n, t, (nlay, ncol)) for n, t in zip(names, cld_fields)]
        checks += [("cld_lut liquid", liq, (n_liq, 3 * nband)),
                   ("cld_lut ice", ice, (n_ice, 3 * nband))]
        cloud = build.CloudLut(p(liq), p(ice), n_liq, n_ice, nband, *geom)
        mode_fields.update(zip(names, map(p, cld_fields)))
    elif mode == "cld_bands":
        checks.append(("cld_tau_band", cld_tau_band, (nlay, ncol, nband)))
        mode_fields["cld_band"] = p(cld_tau_band)
    for name, t, shape in checks:
        _check(name, t, shape, f32, dev)
    _check("gpt2band", gpt2band, (ngpt,), torch.int32, dev)

    lib = build.library()
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    args = build.LwArgs(
        cf=p(const_feats), col_dry=p(col_dry), tlev=p(tlev), tsfc=p(tsfc), emis=p(sfc_emis),
        gpt2band=p(gpt2band), up=p(up), dn=p(dn),
        ncol=ncol, nlay=nlay, n2d=n2d, nc=nc, ngpt=ngpt,
        d_secant=d_secant, two_pi_w=2.0 * torch.pi * weight,
        tau_thresh=tau_thresh_for(torch.float32), **mode_fields)
    planck = build.PlanckTab(p(planck_table.totplnk), p(planck_table.totplnk_diff), nband, ntab,
                             planck_table.temp_ref_min, planck_table.totplnk_delta)
    ref = lambda s: None if s is None else ctypes.byref(s)
    err = lib.lw_clearsky_mega4_launch(
        ref(args), ref(build.mlp3(w1a, w1c, model)), ref(planck), ref(build.MegaPlan(*plan)),
        ref(cloud), ref(lane_list), MODE_CODES[mode], index, stream)
    build.check(err, f"{what} launch")
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    return up, dn


def lw_clearsky_mega4(model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev,
                      tsfc, planck_table, gpt2band, sfc_emis,
                      d_secant=LW_DIFFUSIVITY, weight=LW_WEIGHT,
                      cld_tau_band=None, cld_fields=None, cld_lut=None):
    """Fused LW pipeline; arguments as lw_clearsky_mega4_plain. CPU tensors
    take the plain twin; CUDA float32 tensors launch the kernel, in the mode
    the cloud arguments select; anything else raises."""
    dev = x2d.device
    if cld_fields is not None and cld_lut is None:
        raise ValueError("cld_fields requires cld_lut (CloudOptics.lut_pack)")
    if dev.type == "cpu":
        return lw_clearsky_mega4_plain(
            model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev, tsfc,
            planck_table, gpt2band, sfc_emis, d_secant, weight,
            cld_tau_band=cld_tau_band, cld_fields=cld_fields, cld_lut=cld_lut)
    mode = ("cld_lut" if cld_fields is not None
            else "cld_bands" if cld_tau_band is not None else "clear")
    return _launch(mode, model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev, tsfc,
                   planck_table, gpt2band, sfc_emis, d_secant, weight,
                   cld_fields=cld_fields, cld_lut=cld_lut, cld_tau_band=cld_tau_band)


def lw_clearsky_mega5(model, lanes, tf_codes, scale_rows, const_feats, w1a, w1c, col_dry,
                      tlev, tsfc, planck_table, gpt2band, sfc_emis,
                      d_secant=LW_DIFFUSIVITY, weight=LW_WEIGHT):
    """Fused LW clear-sky pipeline on raw lanes; arguments as
    lw_clearsky_mega5_plain. The same kernel as lw_clearsky_mega4 in its
    lanes mode: it reads one array per feature, applies the transform and
    the scaling while it fills its feature rows, and takes the layer
    temperature from lane 0. CPU tensors take the plain twin; CUDA float32
    tensors launch the kernel; anything else raises."""
    lanes = list(lanes)
    dev = lanes[0].device
    if dev.type == "cpu":
        return lw_clearsky_mega5_plain(
            model, lanes, tf_codes, scale_rows, const_feats, w1a, w1c, col_dry, tlev, tsfc,
            planck_table, gpt2band, sfc_emis, d_secant, weight)
    return _launch("lanes", model, None, const_feats, w1a, w1c, col_dry, None, tlev, tsfc,
                   planck_table, gpt2band, sfc_emis, d_secant, weight,
                   lanes=lanes, tf_codes=tf_codes, scale_rows=scale_rows)
