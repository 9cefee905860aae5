"""The LW front end in one CUDA kernel (``csrc/lw_prep.cu``): NN gas optics,
transmittance and the no-scattering layer sources from band Planck values
interpolated outside, written as the three layer-major fields the broadband
sweeps read plus the surface source; and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py::lw_prep_pallas
(``_prep_kernel`` on ``_phase_a_sources``). What bounds the kernel on an
H100 and how its design answers it is written at the top of the CUDA
source: the MLP's FMA issue and the loads feeding it; it is the fused LW
kernel's phase A (one block per column, up to four layer groups through the
tiled MLP, the weights streamed through shared memory, tau and the Planck
fraction left in shared-memory fields), then one thread per g-point forms
and stores the transmittance and both sources. ``lw_prep_plan`` decides the
geometry (threads, groups, shared memory) from the shapes; the launch entry
checks it again.

``lw_prep`` launches the kernel for CUDA tensors and runs ``lw_prep_plain``
for CPU tensors; it never falls back on CUDA. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...config import megakernel_model_ok, refuse_grad, tau_thresh_for
from ...models.network import NNModel
from ..lw_solver import LW_DIFFUSIVITY, pfrac_sources, transmittance
from . import build
from .lw_megakernel import MAX_SMEM, LaunchPlan, _align4, _check, _smem_limit, plan_groups
from .mlp import fused_predict_lw_both_plain

LAUNCHES = 0  # kernel launches by lw_prep (not plain-path calls)


def lw_prep_plan(nlay: int, nf: int, h1: int, h2: int, ngpt: int,
                 smem_limit: int = MAX_SMEM) -> LaunchPlan:
    """Launch geometry of the kernel for ``nlay`` layers, ``nf`` features,
    hidden widths ``h1`` and ``h2`` and ``ngpt`` g-points: two fields of
    nlay x ngpt floats (the net's tau term and Planck fraction), the
    column's col_dry, per layer group the k-major feature rows and two
    hidden layers, and the two buffers the weights stream through (no sweep
    row: the fields go to device memory). Raises ValueError in words when
    the shape does not fit the shared memory or the 128 g-points of a
    group."""
    return plan_groups("lw_prep", nlay, ngpt, 2 * nlay * ngpt, nf + h1 + h2, _align4(nlay),
                       smem_limit, stream_widths=(h1, h2, 2 * ngpt))


def lw_prep_plain(
    model: NNModel,
    x: torch.Tensor,                # (nlay, ncol, nf) scaled features, layer-major
    col_dry: torch.Tensor,          # (nlay, ncol)
    planck_lay_band: torch.Tensor,  # (nlay, ncol, nband)
    planck_lev_band: torch.Tensor,  # (nlay+1, ncol, nband)
    planck_sfc_band: torch.Tensor,  # (ncol, nband)
    gpt2band: torch.Tensor,         # (ngpt,) int band of each g-point
    d_secant: float = LW_DIFFUSIVITY,
):
    """The kernel's function in tensor ops, from the staged pieces: the
    "lw_both" net, the band -> g-point expansion, the linear-in-tau
    sources (ops/lw_solver.pfrac_sources). Canonical top-at-0, exact
    exponential. Returns (trans, src_dn, src_up), each (nlay, ncol,
    ngpt), and sfc_source (ncol, ngpt)."""
    tau, pf = fused_predict_lw_both_plain(model, x, col_dry)
    tl = tau * d_secant
    trans = transmittance(tl)
    idx = gpt2band.long()
    src_dn, src_up = pfrac_sources(tl, trans, pf, planck_lay_band, planck_lev_band, idx,
                                   pade=False)
    return trans, src_dn, src_up, pf[-1] * planck_sfc_band[..., idx]


def _launch(model, x, col_dry, planck_lay_band, planck_lev_band, planck_sfc_band, gpt2band,
            d_secant):
    """Check every tensor, launch the kernel on the current stream and count
    the launch."""
    global LAUNCHES
    refuse_grad("lw_prep", model, x, col_dry, planck_lay_band, planck_lev_band,
                planck_sfc_band, d_secant)
    dev = x.device
    if not megakernel_model_ok([model]) or model.n_outputs % 2:
        raise NotImplementedError(
            "lw_prep hard-codes one 3-layer softsign/softsign/linear 'lw_both' net; other "
            "models take the staged path (fused_predict_lw_both, compute_planck_source_nn)")
    index, stream = build.launch_target("lw_prep", dev)
    f32 = torch.float32
    nlay, ncol, nf = x.shape
    w1, w2, w3 = model.weights
    b1, b2, b3 = model.biases
    h1, h2 = w1.shape[1], w2.shape[1]
    ngpt = w3.shape[1] // 2
    nband = planck_sfc_band.shape[-1]
    plan = lw_prep_plan(nlay, nf, h1, h2, ngpt, _smem_limit(dev))
    for name, t, shape in (
            ("x", x, (nlay, ncol, nf)), ("col_dry", col_dry, (nlay, ncol)),
            ("planck_lay_band", planck_lay_band, (nlay, ncol, nband)),
            ("planck_lev_band", planck_lev_band, (nlay + 1, ncol, nband)),
            ("planck_sfc_band", planck_sfc_band, (ncol, nband)),
            ("w1", w1, (nf, h1)), ("b1", b1, (h1,)), ("w2", w2, (h1, h2)), ("b2", b2, (h2,)),
            ("w3", w3, (h2, 2 * ngpt)), ("b3", b3, (2 * ngpt,)),
            ("output_mean", model.output_mean, (2 * ngpt,)),
            ("output_std", model.output_std, (2 * ngpt,))):
        _check(name, t, shape, f32, dev)
    _check("gpt2band", gpt2band, (ngpt,), torch.int32, dev)

    outs = [torch.empty((nlay, ncol, ngpt), dtype=f32, device=dev) for _ in range(3)]
    sfc = torch.empty((ncol, ngpt), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    args = build.LwPrepArgs(
        x=p(x), col_dry=p(col_dry), b_lay=p(planck_lay_band), b_lev=p(planck_lev_band),
        b_sfc=p(planck_sfc_band), gpt2band=p(gpt2band), trans=p(outs[0]), src_dn=p(outs[1]),
        src_up=p(outs[2]), sfc_src=p(sfc), ncol=ncol, nlay=nlay, nf=nf, ngpt=ngpt, nband=nband,
        d_secant=d_secant, tau_thresh=tau_thresh_for(f32))
    # the whole first layer multiplies the features: no per-column constant block
    net = build.mlp3(w1, w1, model)
    err = build.library().lw_prep_launch(
        ctypes.byref(args), ctypes.byref(net), ctypes.byref(build.MegaPlan(*plan)), index, stream)
    build.check(err, "lw_prep launch")
    LAUNCHES += 1
    return outs[0], outs[1], outs[2], sfc


def lw_prep(model, x, col_dry, planck_lay_band, planck_lev_band, planck_sfc_band, gpt2band,
            d_secant: float = LW_DIFFUSIVITY):
    """Fused LW front end; arguments as lw_prep_plain. CPU tensors take the
    plain twin; CUDA float32 tensors launch the kernel; anything else
    raises."""
    if x.device.type == "cpu":
        return lw_prep_plain(model, x, col_dry, planck_lay_band, planck_lev_band,
                             planck_sfc_band, gpt2band, d_secant)
    return _launch(model, x, col_dry, planck_lay_band, planck_lev_band, planck_sfc_band,
                   gpt2band, d_secant)
