"""Fused LW clear-sky pipeline: NN gas optics + Planck sources + the
no-scattering broadband transport in one CUDA kernel (``csrc/
lw_megakernel.cu``), and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_clearsky_mega4
(the Pallas ``_mega4_kernel``), clear-sky only. What bounds the kernel on
an H100 and how its design answers it is written at the top of the CUDA
source: the MLP's weight reads bound it, each weight load serves several
layers, and the per-layer fields stay in shared memory, one block per
column, one thread per g-point.

``lw_clearsky_mega4`` launches the kernel for CUDA tensors and runs
``lw_clearsky_mega4_plain`` for CPU tensors; it never falls back on CUDA.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ...config import megakernel_model_ok, tau_thresh_for
from ...gasoptics.planck import PlanckTable
from ...models.network import NNModel
from ..lw_solver import LW_DIFFUSIVITY, LW_WEIGHT, lw_broadband_sweeps, source_fact
from . import build

LAUNCHES = 0  # kernel launches by lw_clearsky_mega4 (not plain-path calls)


def _softsign(x):
    return x / (1.0 + torch.abs(x))


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
):
    """The kernel's function in tensor ops. Canonical top-at-0, single
    angle, zero incident flux, exact exponential and linear-in-tau source.
    Returns broadband (flux_up, flux_dn), each (ncol, nlay+1)."""
    ngpt = model.n_outputs // 2
    _, w2, w3 = model.weights
    b1, b2, b3 = model.biases
    hc = const_feats @ w1c
    h = _softsign(x2d @ w1a + hc[None] + b1)
    h = _softsign(h @ w2 + b2)
    y = h @ w3 + b3
    yt = model.output_std[:ngpt] * y[..., :ngpt] + model.output_mean[:ngpt]
    y2 = yt * yt
    y4 = y2 * y2
    tl = (y4 * y4) * col_dry[..., None] * d_secant
    pf = y[..., ngpt:] * y[..., ngpt:]

    trans = torch.exp(-tl)
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


def lw_clearsky_mega4(model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev,
                      tsfc, planck_table, gpt2band, sfc_emis,
                      d_secant=LW_DIFFUSIVITY, weight=LW_WEIGHT):
    """Fused LW clear-sky pipeline; arguments as lw_clearsky_mega4_plain.
    CPU tensors take the plain twin; CUDA float32 tensors launch the
    kernel; anything else raises."""
    global LAUNCHES
    dev = x2d.device
    if dev.type == "cpu":
        return lw_clearsky_mega4_plain(
            model, x2d, const_feats, w1a, w1c, col_dry, tlay, tlev, tsfc,
            planck_table, gpt2band, sfc_emis, d_secant, weight)
    if dev.type != "cuda":
        raise ValueError(f"lw_clearsky_mega4: unsupported device {dev}")
    if not megakernel_model_ok([model]):
        raise NotImplementedError(
            "lw_clearsky_mega4 hard-codes a 3-layer softsign/softsign/linear "
            "net; other models need kernel K3 (fused_predict_lw_both, "
            "ROADMAP Queue 2)")
    f32 = torch.float32
    nlay, ncol, n2d = x2d.shape
    nc = const_feats.shape[1]
    w1, w2, w3 = model.weights
    b1, b2, b3 = model.biases
    h1, h2 = w1.shape[1], w2.shape[1]
    ngpt = w3.shape[1] // 2
    ntab, nband = planck_table.totplnk.shape
    if ngpt > 128:
        raise ValueError(f"lw_clearsky_mega4: ngpt {ngpt} > 128 threads per block")
    for name, t, shape in (
        ("x2d", x2d, (nlay, ncol, n2d)), ("const_feats", const_feats, (ncol, nc)),
        ("w1a", w1a, (n2d, h1)), ("w1c", w1c, (nc, h1)), ("b1", b1, (h1,)),
        ("w2", w2, (h1, h2)), ("b2", b2, (h2,)), ("w3", w3, (h2, 2 * ngpt)),
        ("b3", b3, (2 * ngpt,)), ("output_mean", model.output_mean, (2 * ngpt,)),
        ("output_std", model.output_std, (2 * ngpt,)),
        ("col_dry", col_dry, (nlay, ncol)), ("tlay", tlay, (nlay, ncol)),
        ("tlev", tlev, (nlay + 1, ncol)), ("tsfc", tsfc, (ncol,)),
        ("sfc_emis", sfc_emis, (ncol, ngpt)),
        ("totplnk", planck_table.totplnk, (ntab, nband)),
        ("totplnk_diff", planck_table.totplnk_diff, (ntab - 1, nband)),
    ):
        _check(name, t, shape, f32, dev)
    _check("gpt2band", gpt2band, (ngpt,), torch.int32, dev)

    lib = build.library()
    smem = lib.lw_clearsky_mega4_smem_bytes(nlay, n2d, h1, h2, ngpt)
    limit = _smem_limit(dev)
    if smem > limit:
        raise ValueError(f"lw_clearsky_mega4: {smem} B of shared memory per "
                         f"block needed, the card allows {limit} (nlay={nlay})")
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    err = lib.lw_clearsky_mega4_launch(
        p(x2d), p(const_feats), p(col_dry), p(tlay), p(tlev), p(tsfc), p(sfc_emis),
        p(w1a), p(w1c), p(b1), p(w2), p(b2), p(w3), p(b3),
        p(model.output_mean), p(model.output_std),
        p(planck_table.totplnk), p(planck_table.totplnk_diff), p(gpt2band),
        p(up), p(dn),
        ncol, nlay, n2d, nc, h1, h2, ngpt, nband, ntab,
        planck_table.temp_ref_min, planck_table.totplnk_delta, d_secant,
        2.0 * torch.pi * weight, tau_thresh_for(torch.float32),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "lw_clearsky_mega4 launch")
    LAUNCHES += 1
    return up, dn
