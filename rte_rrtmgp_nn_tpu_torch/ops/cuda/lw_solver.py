"""LW no-scattering broadband transport of one angle in one CUDA kernel
(``csrc/lw_noscat.cu``, K7), and its plain PyTorch twin.

Replaces rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py::
lw_noscat_broadband_pallas (``_down_kernel``, ``_up_kernel``,
``_layer_step``). What bounds the kernel on an H100 and how its design
answers it is written at the top of the CUDA source: the sweeps stream
tau and both sources from device memory, so one block walks one column
(one thread per g-point, reads contiguous in g) and many columns stay in
flight; the per-level spectral sums are warp partials added once after
both sweeps.

``lw_noscat_broadband`` launches the kernel for CUDA tensors and runs
``lw_noscat_broadband_plain`` for CPU tensors; it never falls back on
CUDA. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import tau_thresh_for
from ..lw_solver import LW_DIFFUSIVITY, LW_WEIGHT, noscat_broadband_1angle
from . import build
from .lw_megakernel import _check

LAUNCHES = 0  # kernel launches by lw_noscat_broadband (not plain-path calls)
MAX_NGPT = 256  # one thread per g-point (csrc/lw_noscat.cu kMaxGpt)


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
    """The kernel's function in tensor ops: exact exponential,
    linear-in-tau source, canonical top-at-0. Returns broadband
    (flux_up, flux_dn), each (ncol, nlay+1)."""
    sol = noscat_broadband_1angle(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                  _secants(d_secant, tau), weight, inc_rad,
                                  fast_exp=False, pade=False)
    return sol.flux_up, sol.flux_dn


def lw_noscat_broadband(tau, lay_source, lev_source, sfc_emis, sfc_source,
                        d_secant=LW_DIFFUSIVITY, weight=LW_WEIGHT, inc_rad=None):
    """LW no-scattering broadband transport; arguments as
    lw_noscat_broadband_plain. CPU tensors take the plain twin; CUDA
    float32 tensors launch the kernel; anything else raises."""
    if tau.device.type == "cpu":
        return lw_noscat_broadband_plain(tau, lay_source, lev_source, sfc_emis, sfc_source,
                                         d_secant, weight, inc_rad)
    return _launch(tau, lay_source, lev_source, sfc_emis, sfc_source, d_secant, weight, inc_rad)


def _launch(tau, lay_source, lev_source, sfc_emis, sfc_source, d_secant, weight, inc_rad):
    """Check the inputs and launch the kernel; returns (flux_up, flux_dn)."""
    global LAUNCHES
    dev = tau.device
    index, stream = build.launch_target("lw_noscat_broadband", dev)
    f32 = torch.float32
    ncol, nlay, ngpt = tau.shape
    if ngpt > MAX_NGPT:
        raise ValueError(f"lw_noscat_broadband: ngpt {ngpt} > {MAX_NGPT} threads per block")
    ds = _secants(d_secant, tau)
    if inc_rad is None:
        inc_rad = torch.zeros((ncol, ngpt), dtype=f32, device=dev)
    for name, t, shape in (
        ("tau", tau, (ncol, nlay, ngpt)), ("lay_source", lay_source, (ncol, nlay, ngpt)),
        ("lev_source", lev_source, (ncol, nlay + 1, ngpt)),
        ("sfc_emis", sfc_emis, (ncol, ngpt)), ("sfc_source", sfc_source, (ncol, ngpt)),
        ("d_secant", ds, (ncol, ngpt)), ("inc_rad", inc_rad, (ncol, ngpt)),
    ):
        _check(name, t, shape, f32, dev)
    lib = build.library()
    up = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    dn = torch.empty((ncol, nlay + 1), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    err = lib.lw_noscat_broadband_launch(
        p(tau), p(lay_source), p(lev_source), p(sfc_emis), p(sfc_source), p(ds), p(inc_rad),
        p(up), p(dn), ncol, nlay, ngpt, 2.0 * np.pi * float(weight), tau_thresh_for(f32),
        index, stream)
    build.check(err, "lw_noscat_broadband launch")
    LAUNCHES += 1
    return up, dn
