"""Fused SW clear-sky pipeline: the absorption and Rayleigh NN nets, PIFM
two-stream coefficients, direct beam and both adding sweeps in one CUDA
kernel (``csrc/sw_megakernel.cu``), and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py::
sw_clearsky_megakernel (the Pallas ``_sw_mega_kernel``), clear-sky only.
What bounds the kernel on an H100 and how its design answers it is written
at the top of the CUDA source: the two MLPs' weight reads and the six
per-layer fields held in shared memory, one block per column, one thread
per g-point.

``sw_clearsky_megakernel`` launches the kernel for CUDA tensors and runs
``sw_clearsky_megakernel_plain`` for CPU tensors; it never falls back on
CUDA. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...config import config, megakernel_model_ok
from ...gasoptics.nn_gas_optics import split_first_layer
from ...models.network import NNModel
from ..sw_solver import sw_adding_broadband, sw_two_stream_coeffs
from . import build
from .lw_megakernel import _check, _smem_limit, _softsign

LAUNCHES = 0  # kernel launches by sw_clearsky_megakernel (not plain-path calls)


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
    x2d: torch.Tensor,            # (nlay, ncol, n2d) scaled layer-varying features
    const_feats: torch.Tensor,    # (ncol, nc) scaled per-column constant features
    perm: Sequence[int],          # [lanes | consts] -> model input positions
    col_dry: torch.Tensor,        # (nlay, ncol)
    mu0: torch.Tensor,            # (ncol,) cos(sza), night columns set to 1
    inc_flux_dir: torch.Tensor,   # (ncol, ngpt) TOA direct flux, times mu0
    sfc_alb_dir: torch.Tensor,    # (ncol, ngpt)
    sfc_alb_dif: torch.Tensor,    # (ncol, ngpt)
    inc_flux_dif: Optional[torch.Tensor] = None,  # (ncol, ngpt) or None
):
    """The kernel's function in tensor ops: both nets scaled with the same
    features, tau = tau_abs + tau_ray, ssa = tau_ray / tau (0 where tau is
    0), g = 0; PIFM two-stream coefficients in float64 (their rdir/tdir are
    0/0 forms at k*mu0 = 1, where float32 loses up to ~10 W/m2); then the
    direct beam and the adding sweeps in the input precision with the exact
    exponential. Canonical top-at-0. Returns (flux_up, flux_dn_total,
    flux_dn_dir), each (ncol, nlay+1)."""
    tau_abs = _net_tau(abs_model, x2d, const_feats, perm, col_dry)
    tau_ray = _net_tau(ray_model, x2d, const_feats, perm, col_dry)
    tau = tau_abs + tau_ray
    pos = tau > 0
    ssa = torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux_dir)
    f64 = torch.float64
    coeffs = sw_two_stream_coeffs(tau.to(f64), ssa.to(f64), torch.zeros_like(tau, dtype=f64),
                                  mu0.to(f64)[:, None], fast_exp=False)
    rdif, tdif, rdir, tdir = (c.to(tau.dtype) for c in coeffs[:4])
    return sw_adding_broadband(rdif, tdif, rdir, tdir, tau, mu0, inc_flux_dir,
                               sfc_alb_dir, sfc_alb_dif, inc_flux_dif, fast_exp=False)


def sw_clearsky_megakernel(abs_model, ray_model, x2d, const_feats, perm,
                           col_dry, mu0, inc_flux_dir, sfc_alb_dir,
                           sfc_alb_dif, inc_flux_dif=None):
    """Fused SW clear-sky pipeline; arguments as
    sw_clearsky_megakernel_plain. The two nets must share input names (the
    features are packed once); the caller checks that they share the input
    scaling too. CPU tensors take the plain twin; CUDA float32 tensors
    launch the kernel; anything else raises."""
    global LAUNCHES
    dev = x2d.device
    if tuple(abs_model.input_names) != tuple(ray_model.input_names):
        raise ValueError("SW megakernel requires matching abs/ray inputs")
    if abs_model.n_outputs != ray_model.n_outputs:
        raise ValueError("SW megakernel requires equal abs/ray output widths "
                         f"({abs_model.n_outputs} vs {ray_model.n_outputs})")
    if dev.type == "cpu":
        return sw_clearsky_megakernel_plain(
            abs_model, ray_model, x2d, const_feats, perm, col_dry, mu0,
            inc_flux_dir, sfc_alb_dir, sfc_alb_dif, inc_flux_dif)
    if dev.type != "cuda":
        raise ValueError(f"sw_clearsky_megakernel: unsupported device {dev}")
    if not megakernel_model_ok([abs_model, ray_model]):
        raise NotImplementedError(
            "sw_clearsky_megakernel hard-codes 3-layer softsign/softsign/linear "
            "nets; other models need kernel K5 (fused_predict_sw, ROADMAP "
            "Queue 2)")
    f32 = torch.float32
    nlay, ncol, n2d = x2d.shape
    nc = const_feats.shape[1]
    ngpt = abs_model.n_outputs
    if ngpt > 128:
        raise ValueError(f"sw_clearsky_megakernel: ngpt {ngpt} > 128 threads per block")
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros((ncol, ngpt), dtype=f32, device=dev)
    for name, t, shape in (
        ("x2d", x2d, (nlay, ncol, n2d)), ("const_feats", const_feats, (ncol, nc)),
        ("col_dry", col_dry, (nlay, ncol)), ("mu0", mu0, (ncol,)),
        ("inc_flux_dir", inc_flux_dir, (ncol, ngpt)),
        ("inc_flux_dif", inc_flux_dif, (ncol, ngpt)),
        ("sfc_alb_dir", sfc_alb_dir, (ncol, ngpt)),
        ("sfc_alb_dif", sfc_alb_dif, (ncol, ngpt)),
    ):
        _check(name, t, shape, f32, dev)
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
        nets.append(((w1a, w1c, b1, w2, b2, w3, b3, m.output_mean, m.output_std),
                     (h1, h2)))
    (wa, (h1a, h2a)), (wr, (h1r, h2r)) = nets

    lib = build.library()
    smem = lib.sw_clearsky_megakernel_smem_bytes(nlay, n2d, h1a, h2a, h1r, h2r, ngpt)
    limit = _smem_limit(dev)
    if smem > limit:
        raise ValueError(f"sw_clearsky_megakernel: {smem} B of shared memory "
                         f"per block needed, the card allows {limit} (nlay={nlay})")
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn_dir = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    err = lib.sw_clearsky_megakernel_launch(
        p(x2d), p(const_feats), p(col_dry), p(mu0), p(inc_flux_dir),
        p(inc_flux_dif), p(sfc_alb_dir), p(sfc_alb_dif),
        *map(p, wa), *map(p, wr), p(up), p(dn), p(dn_dir),
        ncol, nlay, n2d, nc, h1a, h2a, h1r, h2r, ngpt,
        config.k_min, float(torch.finfo(torch.float64).eps),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sw_clearsky_megakernel launch")
    LAUNCHES += 1
    return up, dn, dn_dir
