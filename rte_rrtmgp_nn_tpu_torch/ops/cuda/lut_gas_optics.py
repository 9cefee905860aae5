"""K10: the lookup-table gas optics in one CUDA kernel
(``csrc/lut_gas_optics.cu``), and its plain PyTorch twin.

From the layers' pressure, temperature and gas columns, one launch makes
the interpolation state, the major and minor absorbers' optical depth and,
LW, the Planck fraction, or, SW, the Rayleigh optical depth, the total tau
and the single-scattering albedo: what ``ops/gas_optics_lut.py`` makes in
some four hundred tensor operations a call (``interpolation``,
``compute_tau_absorption``, ``compute_tau_rayleigh`` and the Planck
fraction's ``_interp3d``), which is the twin. What bounds the kernel on an
H100 is written at the top of its source.

``lut_optics_lw`` / ``lut_optics_sw`` launch the kernel for tensors off the
CPU and run the twin for CPU tensors (with the spans ``rte.lut.major``,
``.minor`` and, SW, ``.rayleigh``); on CUDA anything but float32 raises.
``LAUNCHES`` counts launches by mode.
"""
from __future__ import annotations

import ctypes

import torch

from ...gasoptics.kdist import KDist
from ..gas_optics_lut import (
    _interp3d, compute_tau_absorption, compute_tau_rayleigh, interpolation)
from ...utils.timing import span
from . import build

LAUNCHES = {"lw": 0, "sw": 0}
MODES = {"lw": 0, "sw": 1}  # csrc/lut_gas_optics.cu kModeLw, kModeSw


def lut_optics_lw_plain(kd: KDist, play, tlay, col_gas):
    """(tau, pfrac), each (ncol, nlay, ngpt): the absorption optical depth
    and the Planck fraction in tensor ops."""
    ic = interpolation(kd, play, tlay, col_gas)
    return (compute_tau_absorption(kd, ic, play, tlay, col_gas),
            _interp3d(kd, ic, kd.pfracin, scaled=False))


def lut_optics_sw_plain(kd: KDist, play, tlay, col_gas):
    """(tau, ssa), each (ncol, nlay, ngpt): absorption plus Rayleigh, and
    Rayleigh over the total (0 where the total is 0), in tensor ops
    (reference combine_2str)."""
    ic = interpolation(kd, play, tlay, col_gas)
    tau_abs = compute_tau_absorption(kd, ic, play, tlay, col_gas)
    with span("rte.lut.rayleigh"):
        tau_ray = compute_tau_rayleigh(kd, ic, col_gas, col_gas[..., 0])
        tau = tau_abs + tau_ray
        pos = tau > 0
        return tau, torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)


def _check(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"lut_gas_optics: {name} is {t.dtype} on {t.device}, expected "
                         f"torch.float32 on {dev}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"lut_gas_optics: {name} has shape {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}, expected "
                         f"{tuple(shape)} contiguous")


def _launch(mode: str, kd: KDist, play, tlay, col_gas):
    """Check every tensor, launch K10 on the current stream and count it."""
    dev = play.device
    index, stream = build.launch_target("lut_gas_optics", dev)
    ncol, nlay = play.shape
    ncg, ngpt = 1 + kd.ngas, kd.ngpt
    ntemp, npres, neta = kd.ntemp, kd.npres, kd.neta
    tables = kd.kernel_tables
    kmajor, vmr_ref = tables["kmajor"], tables["vmr_ref"]
    ktab = tables["pfracin" if mode == "lw" else "krayl"]
    lo, up = tables["kminor_lower"], tables["kminor_upper"]
    for name, t, shape in (
            ("play", play, (ncol, nlay)), ("tlay", tlay, (ncol, nlay)),
            ("col_gas", col_gas, (ncol, nlay, ncg)),
            ("kmajor", kmajor, (ntemp, npres + 1, neta, ngpt)),
            ("pfracin" if mode == "lw" else "krayl", ktab,
             (ntemp, npres + 1, neta, ngpt) if mode == "lw" else (2, ntemp, neta, ngpt)),
            ("vmr_ref", vmr_ref, (2, ncg, ntemp)), ("temp_ref", tables["temp_ref"], (ntemp,)),
            ("kminor_lower", lo, (ntemp, neta, lo.shape[-1])),
            ("kminor_upper", up, (ntemp, neta, up.shape[-1]))):
        _check(name, t, shape, dev)
    tau = torch.empty((ncol, nlay, ngpt), dtype=torch.float32, device=dev)
    out2 = torch.empty_like(tau)
    p = lambda t: t.data_ptr()
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))
    args = build.LutArgs(
        play=p(play), tlay=p(tlay), col_gas=p(col_gas), kmajor=p(kmajor), ktab=p(ktab),
        vmr_ref=p(vmr_ref), temp_ref=p(tables["temp_ref"]), flavor=p(tables["flavor"]),
        gflav=p(tables["gflav"]), kminor_lo=p(lo), kminor_up=p(up), minor=p(tables["minor"]),
        tau=p(tau), out2=p(out2), nrow=ncol * nlay, ngpt=ngpt, ncg=ncg, ntemp=ntemp,
        npres=npres, neta=neta, nminor=tables["minor"].shape[0], ncontrib_lo=lo.shape[-1],
        ncontrib_up=up.shape[-1], idx_h2o=1 + kd.gas_names.index("h2o"),
        # the twin's Python scalars, rounded to float32 as its tensor ops round them
        t_shift=f32(kd.temp_ref_min - kd.temp_ref_delta), t_delta=f32(kd.temp_ref_delta),
        p_log0=f32(kd.press_ref_log[0]), p_log_delta=f32(kd.press_ref_log_delta),
        p_trop_log=f32(kd.press_ref_trop_log),
        mix_min=f32(2.0 * torch.finfo(torch.float32).tiny))
    err = build.library().lut_gas_optics_launch(ctypes.byref(args), MODES[mode], index, stream)
    build.check(err, f"lut_gas_optics[{mode}] launch")
    LAUNCHES[mode] += 1
    return tau, out2


def lut_optics_lw(kd: KDist, play, tlay, col_gas):
    """(tau, pfrac) of the LW k-distribution ``kd``: play, tlay (ncol,
    nlay), col_gas (ncol, nlay, 1 + ngas) as ``compute_col_gas`` makes it.
    CPU tensors take the twin; CUDA float32 tensors launch K10."""
    if play.device.type == "cpu":
        return lut_optics_lw_plain(kd, play, tlay, col_gas)
    return _launch("lw", kd, play, tlay, col_gas)


def lut_optics_sw(kd: KDist, play, tlay, col_gas):
    """(tau, ssa) of the SW k-distribution ``kd``; arguments as
    lut_optics_lw. CPU tensors take the twin; CUDA float32 tensors launch
    K10."""
    if play.device.type == "cpu":
        return lut_optics_sw_plain(kd, play, tlay, col_gas)
    return _launch("sw", kd, play, tlay, col_gas)
