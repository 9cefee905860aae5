"""K11: the broadband shortwave two-stream + adding solve of general optical
properties in one CUDA kernel (``csrc/sw_2stream.cu``).

Its twin is ``ops/sw_solver.sw_2stream_broadband``, whose per-layer sweeps
are some fifteen hundred tensor operations a call at 60 layers: the float64
PIFM coefficients rounded to float32, the direct beam, the surface-to-top
sweep of albedo and source, the flux sweep and the spectral sums at every
level. What bounds the kernel on an H100 is written at the top of its
source. ``sw_2stream_broadband_kernel`` launches it for CUDA tensors and
runs the twin for CPU tensors; on CUDA anything but float32 raises.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...config import config
from ..sw_solver import sw_2stream_broadband
from . import build

LAUNCHES = 0
MAX_GPT = 1024  # csrc/sw_2stream.cu: 32 warps of one thread a g-point


def _check(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"sw_2stream: {name} is {t.dtype} on {t.device}, expected "
                         f"torch.float32 on {dev}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"sw_2stream: {name} has shape {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}, expected "
                         f"{tuple(shape)} contiguous")


def _launch(tau, ssa, g, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif, inc_flux_dif, top_at_1):
    global LAUNCHES
    dev = tau.device
    index, stream = build.launch_target("sw_2stream", dev)
    ncol, nlay, ngpt = tau.shape
    if ngpt > MAX_GPT:
        raise ValueError(f"sw_2stream: {ngpt} g-points, at most {MAX_GPT}")
    for name, t, shape in (("tau", tau, (ncol, nlay, ngpt)), ("ssa", ssa, (ncol, nlay, ngpt)),
                           ("g", g, (ncol, nlay, ngpt)), ("mu0", mu0, (ncol,)),
                           ("inc_flux", inc_flux, (ncol, ngpt)),
                           ("sfc_alb_dir", sfc_alb_dir, (ncol, ngpt)),
                           ("sfc_alb_dif", sfc_alb_dif, (ncol, ngpt))):
        _check(name, t, shape, dev)
    if inc_flux_dif is not None:
        _check("inc_flux_dif", inc_flux_dif, (ncol, ngpt), dev)
    scratch = torch.empty((ncol, 5, nlay, ngpt), dtype=torch.float32, device=dev)
    up, dn, dn_dir = (torch.empty((ncol, nlay + 1), dtype=torch.float32, device=dev)
                      for _ in range(3))
    p = lambda t: 0 if t is None else t.data_ptr()
    args = build.Sw2StreamArgs(
        tau=p(tau), ssa=p(ssa), g=p(g), mu0=p(mu0), inc_flux=p(inc_flux),
        alb_dir=p(sfc_alb_dir), alb_dif=p(sfc_alb_dif), inc_dif=p(inc_flux_dif),
        scratch=p(scratch), up=p(up), dn=p(dn), dir=p(dn_dir), ncol=ncol, nlay=nlay,
        ngpt=ngpt, top_at_1=int(top_at_1), k_min=config.k_min,
        eps=float(torch.finfo(torch.float64).eps))
    err = build.library().sw_2stream_launch(ctypes.byref(args), index, stream)
    build.check(err, "sw_2stream launch")
    LAUNCHES += 1
    return up, dn, dn_dir


def sw_2stream_broadband_kernel(tau, ssa, g, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif,
                                inc_flux_dif=None, top_at_1=True):
    """Broadband (up, dn total, dn direct), each (ncol, nlay+1) in the
    inputs' orientation: tau, ssa, g (ncol, nlay, ngpt) column-major, mu0
    (ncol,), inc_flux (ncol, ngpt) TOA flux before the mu0 weighting,
    per-g-point albedos and the diffuse TOA flux (ncol, ngpt; None = 0).
    CPU tensors take the twin (sw_2stream_broadband); CUDA float32 tensors
    launch K11, with the exact exponential (``config.fast_exponential`` is
    the twin's)."""
    if tau.device.type != "cpu":
        c = lambda a: None if a is None else a.contiguous()
        return _launch(c(tau), c(ssa), c(g), c(mu0), c(inc_flux), c(sfc_alb_dir),
                       c(sfc_alb_dif), c(inc_flux_dif), top_at_1)
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux)
    if not top_at_1:
        tau, ssa, g = tau.flip(1), ssa.flip(1), g.flip(1)
    t = lambda a: a.transpose(0, 1)
    out = sw_2stream_broadband(t(tau), t(ssa), t(g), mu0, inc_flux * mu0[:, None], sfc_alb_dir,
                               sfc_alb_dif, inc_flux_dif)
    return out if top_at_1 else tuple(o.flip(1) for o in out)
