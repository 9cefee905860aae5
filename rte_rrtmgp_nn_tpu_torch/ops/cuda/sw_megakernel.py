"""Fused SW pipeline: the absorption and Rayleigh NN nets, optional clouds,
PIFM two-stream coefficients, direct beam and both adding sweeps in one
CUDA kernel (``csrc/sw_megakernel.cu``), and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py::
sw_clearsky_megakernel (the Pallas ``_sw_mega_kernel``) with its cloud
options and its ``input_mode="lanes"``. What bounds the kernel on an H100
and how its design answers it is written at the top of the CUDA source:
latency, with one column resident per SM (five per-layer fields in shared
memory), so a block is up to four layer groups of one thread per g-point
each, and the two nets' hidden layers run side by side. ``launch_plan``
decides that geometry (threads, groups, shared memory) from the shapes; the
launch entry checks it again.

The kernel has four modes: clear-sky; clouds from (lwp, iwp, rel, rei)
through the lookup tables inside the kernel, delta-scaled in the
subtraction form (``cld_fields`` + ``cld_lut``); clouds as band lanes of the
delta-scaled tau, tau*ssa, tau*ssa*g (``cld_bands``); and clear-sky with one
array per feature (``input_mode="lanes"``). ``sw_clearsky_megakernel``
launches the kernel for CUDA tensors and runs
``sw_clearsky_megakernel_plain`` for CPU tensors; it never falls back on
CUDA. ``LAUNCHES`` counts kernel launches, ``MODE_LAUNCHES`` the same
launches by mode.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ...config import config, megakernel_model_ok, refuse_grad
from ...gasoptics.nn_gas_optics import split_first_layer
from ...models.network import NNModel
from ..sw_solver import pifm_coefficients, sw_adding_broadband
from . import build
from .lw_megakernel import (
    MAX_LANES, MAX_SMEM, MODE_CODES, LaunchPlan, _align4, _check, _smem_limit,
    _softsign, cloud_lut_phases, plan_groups)

LAUNCHES = 0  # kernel launches by sw_clearsky_megakernel (not plain-path calls)
# the same launches by kernel mode (csrc/common.cuh MegaMode)
MODE_LAUNCHES = {"clear": 0, "cld_lut": 0, "cld_bands": 0, "lanes": 0}
# float32's eps guards the cloud combine's divides in every precision; the
# float64 coefficient guard of the k*mu0 = 1 resonance is another constant
CLD_EPS = float(torch.finfo(torch.float32).eps)


def launch_plan(nlay: int, n2d: int, h1, h2, ngpt: int,
                smem_limit: int = MAX_SMEM) -> LaunchPlan:
    """Launch geometry of the SW kernel for ``nlay`` layers, ``n2d``
    layer-varying features, hidden widths ``h1`` and ``h2`` (an int for two
    nets alike, or the (absorption, Rayleigh) pair) and ``ngpt`` g-points:
    five fields of nlay x ngpt floats, three rows more, the broadband direct
    flux, the column's per-layer scalars, and per group the k-major feature
    rows and both nets' two hidden layers. Raises ValueError in words when
    the shape does not fit the shared memory or the 128 g-points of a
    group."""
    h1a, h1r = (h1, h1) if isinstance(h1, int) else h1
    h2a, h2r = (h2, h2) if isinstance(h2, int) else h2
    return plan_groups("sw_clearsky_megakernel", nlay, ngpt,
                       5 * nlay * ngpt + 3 * ngpt + nlay + 1,
                       n2d + h1a + h1r + h2a + h2r,
                       _align4(h1a) + _align4(h1r) + 5 * nlay, smem_limit)


def _net_tau(m: NNModel, x2d, const_feats, perm, col_dry):
    w1a, w1c = split_first_layer(m, perm, x2d.shape[-1])
    _, w2, w3 = m.weights
    b1, b2, b3 = m.biases
    h = _softsign(x2d @ w1a + (const_feats @ w1c)[None] + b1)
    h = _softsign(h @ w2 + b2)
    y = h @ w3 + b3
    yt = m.output_std * y + m.output_mean
    y2 = yt * yt
    y4 = y2 * y2
    return (y4 * y4) * col_dry[..., None]


def sw_clearsky_megakernel_plain(
    abs_model: NNModel,
    ray_model: NNModel,
    x2d,                          # (nlay, ncol, n2d) scaled layer-varying features;
                                  #   with input_mode="lanes" a list of n2d (nlay, ncol)
    const_feats: torch.Tensor,    # (ncol, nc) scaled per-column constant features
    perm: Sequence[int],          # [lanes | consts] -> model input positions
    col_dry: torch.Tensor,        # (nlay, ncol)
    mu0: torch.Tensor,            # (ncol,) cos(sza), night columns set to 1
    inc_flux_dir: torch.Tensor,   # (ncol, ngpt) TOA direct flux, times mu0
    sfc_alb_dir: torch.Tensor,    # (ncol, ngpt)
    sfc_alb_dif: torch.Tensor,    # (ncol, ngpt)
    inc_flux_dif: Optional[torch.Tensor] = None,  # (ncol, ngpt) or None
    cld_bands=None,               # DELTA-SCALED (tau, tau*ssa, tau*ssa*g), each
                                  #   (nlay, ncol, nband), or None
    gpt2band=None,                # (ngpt,) int band of each g-point, with clouds
    cld_fields=None,              # (lwp, iwp, rel, rei), each (nlay, ncol); needs cld_lut
    cld_lut=None,                 # CloudOptics.lut_pack, on the fields' device
    input_mode: str = "fused",    # "lanes": x2d is one tensor per feature (clear-sky)
):
    """The kernel's function in tensor ops: both nets scaled with the same
    features, tau = tau_abs + tau_ray, ssa = tau_ray / tau (0 where tau is
    0), g = 0; with clouds, the delta-scaled band products (given, or from
    the lookup tables with the delta scaling in its subtraction form) are
    expanded to g-points and incremented into the gas properties; PIFM
    two-stream coefficients in float64 (their rdir/tdir are 0/0 forms at
    k*mu0 = 1, where float32 loses up to ~10 W/m2), by pifm_coefficients
    as every staged SW route takes them; then the direct beam
    and the adding sweeps in the input precision with the exact
    exponential. Canonical top-at-0. Returns (flux_up, flux_dn_total,
    flux_dn_dir), each (ncol, nlay+1).

    The kernel groups two float64 products otherwise, so that no divide of
    its loop has a zero numerator: the path is tau * (1 / mu0) where this
    divides by mu0, and rdir / tdir take ssa * (rt_term / denom) where
    sw_two_stream_coeffs takes ssa * rt_term / denom. Both differ in the
    last float64 bits only and vanish in the rounding to float32 (kernel
    against twin is the same to the digit either way); the twin keeps the
    staged form and is not to be brought in line."""
    if input_mode == "lanes":
        x2d = torch.stack(list(x2d), dim=-1)
    tau_abs = _net_tau(abs_model, x2d, const_feats, perm, col_dry)
    tau_ray = _net_tau(ray_model, x2d, const_feats, perm, col_dry)
    tau = tau_abs + tau_ray
    pos = tau > 0
    ssa = torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)
    g = torch.zeros_like(tau)
    if cld_fields is not None or cld_bands is not None:
        idx = gpt2band.long()
        if cld_fields is not None:
            (lt, lts, ltsg), (it, its, itsg) = cloud_lut_phases(cld_fields, cld_lut)
            tau_b, taussa, tsg = lt + it, lts + its, ltsg + itsg
            # delta scaling with f = g**2: all three products lose
            # u = (tau*ssa*g)**2 / (tau*ssa)
            u = tsg * (tsg / torch.clamp_min(taussa, CLD_EPS))
            bands = (tau_b - u, taussa - u, tsg - u)
        else:
            bands = cld_bands
        tc, tsc, tgc = (b[..., idx] for b in bands)
        tauscat = tau * ssa + tsc
        tau = tau + tc
        g = tgc / torch.clamp_min(tauscat, CLD_EPS)
        ssa = tauscat / torch.clamp_min(tau, CLD_EPS)
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux_dir)
    rdif, tdif, rdir, tdir = pifm_coefficients(tau, ssa, g, mu0[:, None], fast_exp=False)
    return sw_adding_broadband(rdif, tdif, rdir, tdir, tau, mu0, inc_flux_dir,
                               sfc_alb_dir, sfc_alb_dif, inc_flux_dif, fast_exp=False)


def _launch(mode, abs_model, ray_model, x2d, const_feats, perm, col_dry, mu0,
            inc_flux_dir, sfc_alb_dir, sfc_alb_dif, inc_flux_dif, cld_bands, gpt2band,
            cld_fields, cld_lut):
    """Check every tensor the mode reads, launch the kernel on the current
    stream and count the launch. In the lanes mode ``x2d`` is the list of
    feature lanes."""
    global LAUNCHES
    what = f"sw_clearsky_megakernel[{mode}]"
    refuse_grad(what, abs_model, ray_model, x2d, const_feats, col_dry, mu0, inc_flux_dir,
                sfc_alb_dir, sfc_alb_dif, inc_flux_dif, cld_bands, cld_fields)
    lanes = list(x2d) if mode == "lanes" else None
    dev = (lanes[0] if lanes else x2d).device
    index, stream = build.launch_target(what, dev)
    if not megakernel_model_ok([abs_model, ray_model]):
        raise NotImplementedError(
            "sw_clearsky_megakernel hard-codes 3-layer softsign/softsign/linear "
            "nets; other models take the staged path (fused_predict_sw)")
    f32 = torch.float32
    nlay, ncol = col_dry.shape
    n2d = len(lanes) if lanes else x2d.shape[-1]
    nc = const_feats.shape[1]
    ngpt = abs_model.n_outputs
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros((ncol, ngpt), dtype=f32, device=dev)
    checks = [
        ("const_feats", const_feats, (ncol, nc)),
        ("col_dry", col_dry, (nlay, ncol)), ("mu0", mu0, (ncol,)),
        ("inc_flux_dir", inc_flux_dir, (ncol, ngpt)),
        ("inc_flux_dif", inc_flux_dif, (ncol, ngpt)),
        ("sfc_alb_dir", sfc_alb_dir, (ncol, ngpt)),
        ("sfc_alb_dif", sfc_alb_dif, (ncol, ngpt)),
    ]
    p = lambda t: t.data_ptr()
    cloud = lane_list = None
    mode_fields = {}  # the SwArgs fields only this mode reads
    if lanes:
        if n2d > MAX_LANES:
            raise ValueError(f"{what}: {n2d} lanes, the kernel takes {MAX_LANES}")
        checks += [(f"lanes[{k}]", t, (nlay, ncol)) for k, t in enumerate(lanes)]
        lane_list = build.lane_list(lanes)
    else:
        checks.append(("x2d", x2d, (nlay, ncol, n2d)))
        mode_fields["x"] = p(x2d)
    if mode == "cld_lut":
        liq, ice, geom = cld_lut
        n_liq, n_ice, nband = liq.shape[0], ice.shape[0], liq.shape[1] // 3
        names = ("lwp", "iwp", "rel", "rei")
        checks += [(n, t, (nlay, ncol)) for n, t in zip(names, cld_fields)]
        checks += [("cld_lut liquid", liq, (n_liq, 3 * nband)),
                   ("cld_lut ice", ice, (n_ice, 3 * nband))]
        cloud = build.CloudLut(p(liq), p(ice), n_liq, n_ice, nband, *geom)
        mode_fields.update(zip(names, map(p, cld_fields)), nband=nband)
    elif mode == "cld_bands":
        nband = cld_bands[0].shape[-1]
        checks += [(f"cld_bands[{k}]", t, (nlay, ncol, nband)) for k, t in enumerate(cld_bands)]
        mode_fields.update(zip(("cld_tau", "cld_ts", "cld_tsg"), map(p, cld_bands)), nband=nband)
    for name, t, shape in checks:
        _check(name, t, shape, f32, dev)
    if mode in ("cld_lut", "cld_bands"):
        _check("gpt2band", gpt2band, (ngpt,), torch.int32, dev)
        mode_fields["gpt2band"] = p(gpt2band)
    nets = []
    for tag, m in (("abs", abs_model), ("ray", ray_model)):
        w1a, w1c = split_first_layer(m, perm, n2d)
        _, w2, w3 = m.weights
        b1, b2, b3 = m.biases
        h1, h2 = w1a.shape[1], w2.shape[1]
        for name, t, shape in (
            ("w1a", w1a, (n2d, h1)), ("w1c", w1c, (nc, h1)), ("b1", b1, (h1,)),
            ("w2", w2, (h1, h2)), ("b2", b2, (h2,)), ("w3", w3, (h2, ngpt)),
            ("b3", b3, (ngpt,)), ("output_mean", m.output_mean, (ngpt,)),
            ("output_std", m.output_std, (ngpt,)),
        ):
            _check(f"{tag}.{name}", t, shape, f32, dev)
        nets.append(build.mlp3(w1a, w1c, m))  # w1a, w1c: kept by the model
    net_a, net_r = nets

    plan = launch_plan(nlay, n2d, (net_a.h1, net_r.h1), (net_a.h2, net_r.h2), ngpt,
                       _smem_limit(dev))
    lib = build.library()
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn_dir = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    args = build.SwArgs(
        cf=p(const_feats), col_dry=p(col_dry), mu0=p(mu0), inc_dir=p(inc_flux_dir),
        inc_dif=p(inc_flux_dif), alb_dir=p(sfc_alb_dir), alb_dif=p(sfc_alb_dif),
        up=p(up), dn=p(dn), dir=p(dn_dir),
        ncol=ncol, nlay=nlay, n2d=n2d, nc=nc, ngpt=ngpt,
        k_min=config.k_min, eps=float(torch.finfo(torch.float64).eps), cld_eps=CLD_EPS,
        **mode_fields)
    ref = lambda s: None if s is None else ctypes.byref(s)
    err = lib.sw_clearsky_megakernel_launch(
        ref(args), ref(net_a), ref(net_r), ref(build.MegaPlan(*plan)), ref(cloud),
        ref(lane_list), MODE_CODES[mode], index, stream)
    build.check(err, f"{what} launch")
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    return up, dn, dn_dir


def sw_clearsky_megakernel(abs_model, ray_model, x2d, const_feats, perm,
                           col_dry, mu0, inc_flux_dir, sfc_alb_dir,
                           sfc_alb_dif, inc_flux_dif=None, cld_bands=None,
                           gpt2band=None, cld_fields=None, cld_lut=None,
                           input_mode: str = "fused"):
    """Fused SW pipeline; arguments as sw_clearsky_megakernel_plain. The
    two nets must share input names (the features are packed once); the
    caller checks that they share the input scaling too. CPU tensors take
    the plain twin; CUDA float32 tensors launch the kernel, in the mode the
    cloud arguments and ``input_mode`` select; anything else raises."""
    if tuple(abs_model.input_names) != tuple(ray_model.input_names):
        raise ValueError("SW megakernel requires matching abs/ray inputs")
    if abs_model.n_outputs != ray_model.n_outputs:
        raise ValueError("SW megakernel requires equal abs/ray output widths "
                         f"({abs_model.n_outputs} vs {ray_model.n_outputs})")
    cloudy = cld_fields is not None or cld_bands is not None
    if cld_fields is not None and cld_lut is None:
        raise ValueError("cld_fields requires cld_lut (CloudOptics.lut_pack)")
    if cloudy and gpt2band is None:
        raise ValueError("clouds require gpt2band")
    if input_mode not in ("fused", "lanes"):
        raise ValueError(f"input_mode {input_mode!r}: 'fused' or 'lanes'")
    lanes_mode = input_mode == "lanes"
    if lanes_mode and (cloudy or torch.is_tensor(x2d)):
        raise ValueError("input_mode='lanes' requires a clear-sky lane list input")
    dev = (x2d[0] if lanes_mode else x2d).device
    if dev.type == "cpu":
        return sw_clearsky_megakernel_plain(
            abs_model, ray_model, x2d, const_feats, perm, col_dry, mu0,
            inc_flux_dir, sfc_alb_dir, sfc_alb_dif, inc_flux_dif,
            cld_bands=cld_bands, gpt2band=gpt2band, cld_fields=cld_fields,
            cld_lut=cld_lut, input_mode=input_mode)
    mode = ("lanes" if lanes_mode else "cld_lut" if cld_fields is not None
            else "cld_bands" if cld_bands is not None else "clear")
    return _launch(mode, abs_model, ray_model, x2d, const_feats, perm, col_dry, mu0,
                   inc_flux_dir, sfc_alb_dir, sfc_alb_dif, inc_flux_dif, cld_bands,
                   gpt2band, cld_fields, cld_lut)
