"""Optical-property containers.

Port of the containers of rte_rrtmgp_nn_tpu/optical_props.py (reference
rte/mo_optical_props.F90 ty_optical_props_1scl / _2str / _nstr and
``validate``), ``delta_scale`` (mo_optical_props_kernels.F90:46-107),
``increment`` (mo_optical_props.F90:882-1023) and ``subset`` (:723-874).
Arrays are (ncol, nlay, ngpt), g-points minor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .spectral import SpectralMapping


@dataclasses.dataclass(frozen=True)
class OpticalProps1scl:
    """Absorption optical depth only (reference _1scl)."""

    tau: torch.Tensor  # (ncol, nlay, ngpt)
    spectral: SpectralMapping

    @property
    def ncol(self) -> int:
        return self.tau.shape[0]

    @property
    def nlay(self) -> int:
        return self.tau.shape[1]

    @property
    def ngpt(self) -> int:
        return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalProps2str:
    """Two-stream: optical depth, single-scattering albedo, asymmetry
    (reference _2str)."""

    tau: torch.Tensor  # (ncol, nlay, ngpt)
    ssa: torch.Tensor
    g: torch.Tensor
    spectral: SpectralMapping

    @property
    def ncol(self) -> int:
        return self.tau.shape[0]

    @property
    def nlay(self) -> int:
        return self.tau.shape[1]

    @property
    def ngpt(self) -> int:
        return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalPropsNstr:
    """n-stream: optical depth, single-scattering albedo, phase-function
    moments p (nmom, ncol, nlay, ngpt) (reference _nstr)."""

    tau: torch.Tensor
    ssa: torch.Tensor
    p: torch.Tensor
    spectral: SpectralMapping

    @property
    def ncol(self) -> int:
        return self.tau.shape[0]

    @property
    def nlay(self) -> int:
        return self.tau.shape[1]

    @property
    def ngpt(self) -> int:
        return self.tau.shape[2]

    @property
    def nmom(self) -> int:
        return self.p.shape[0]


def zeros_1scl(ncol, nlay, spectral: SpectralMapping, dtype=torch.float32,
               device=None) -> OpticalProps1scl:
    return OpticalProps1scl(
        torch.zeros((ncol, nlay, spectral.ngpt), dtype=dtype, device=device), spectral)


def zeros_2str(ncol, nlay, spectral: SpectralMapping, dtype=torch.float32,
               device=None) -> OpticalProps2str:
    z = torch.zeros((ncol, nlay, spectral.ngpt), dtype=dtype, device=device)
    return OpticalProps2str(z, z.clone(), z.clone(), spectral)


def zeros_nstr(nmom, ncol, nlay, spectral: SpectralMapping, dtype=torch.float32,
               device=None) -> OpticalPropsNstr:
    z = torch.zeros((ncol, nlay, spectral.ngpt), dtype=dtype, device=device)
    return OpticalPropsNstr(z, z.clone(), torch.zeros((nmom,) + tuple(z.shape), dtype=dtype,
                                                      device=device), spectral)


def validate(op) -> list[str]:
    """Value checks, host-side (reads the values): a list of error strings,
    empty when valid. ssa may exceed 1 by 1e-4 (the reference's fast-math
    tolerance, mo_optical_props.F90:663)."""
    errs = []
    if bool((op.tau < 0).any()):
        errs.append("validate: tau values out of range")
    if isinstance(op, (OpticalProps2str, OpticalPropsNstr)):
        if bool((op.ssa < 0).any()) or bool((op.ssa > 1.0001).any()):
            errs.append("validate: ssa values out of range [0,1]")
    if isinstance(op, OpticalProps2str):
        if bool((op.g < -1).any()) or bool((op.g > 1).any()):
            errs.append("validate: g values out of range [-1,1]")
    return errs


def delta_scale(op: OpticalProps2str,
                forward_frac: Optional[torch.Tensor] = None) -> OpticalProps2str:
    """Delta-scale two-stream properties. With no ``forward_frac``, f = g**2
    (delta_scale_2str_kernel); with it, the given forward fraction
    (delta_scale_2str_f_kernel)."""
    eps = torch.finfo(op.tau.dtype).eps
    f = op.g * op.g if forward_frac is None else forward_frac
    wf = op.ssa * f
    tau = op.tau * (1.0 - wf)
    g = (op.g - f) / torch.clamp_min(1.0 - f, eps)
    ssa = (op.ssa - wf) / torch.clamp_min(1.0 - wf, eps)
    return dataclasses.replace(op, tau=tau, ssa=ssa, g=g)


def _expand_if_byband(arr: torch.Tensor, src: SpectralMapping,
                      dst: SpectralMapping) -> torch.Tensor:
    """``arr`` on ``dst``'s g-point grid: unchanged when ``src`` has it
    already, broadcast band -> g-point when ``src`` is ``dst``'s band grid
    (the ``inc_X_by_Y_bybnd`` kernels)."""
    if src.ngpt == dst.ngpt:
        return arr
    if src.ngpt == dst.nband:
        return dst.expand(arr)
    raise ValueError(
        f"increment: incompatible spectral discretizations (src ngpt {src.ngpt}, "
        f"dst ngpt {dst.ngpt}, dst nband {dst.nband})")


def increment(op1, op2):
    """``op1`` with ``op2``'s optical properties added: the nine same-grid
    pairs of the reference and their by-band broadcasts
    (mo_optical_props_kernels.F90:109-636). Moment counts must match for
    nstr + nstr."""
    eps = torch.finfo(op1.tau.dtype).eps
    tau2 = _expand_if_byband(op2.tau, op2.spectral, op1.spectral)

    if isinstance(op1, OpticalProps1scl):
        if isinstance(op2, OpticalProps1scl):
            return dataclasses.replace(op1, tau=op1.tau + tau2)
        # absorption only: a scattering medium adds (1 - ssa) * tau
        ssa2 = _expand_if_byband(op2.ssa, op2.spectral, op1.spectral)
        return dataclasses.replace(op1, tau=op1.tau + tau2 * (1.0 - ssa2))

    if isinstance(op2, OpticalProps1scl):
        # an absorber leaves g and p unchanged (increment_2stream_by_1scalar
        # :169-189, increment_nstream_by_1scalar :255-275)
        tau12 = op1.tau + tau2
        ssa = op1.tau * op1.ssa / torch.clamp_min(tau12, eps)
        return dataclasses.replace(op1, tau=tau12, ssa=ssa)

    ssa2 = _expand_if_byband(op2.ssa, op2.spectral, op1.spectral)
    if isinstance(op2, OpticalProps2str):
        g2 = _expand_if_byband(op2.g, op2.spectral, op1.spectral)
    else:  # nstr: the first moment is the asymmetry
        g2 = _expand_if_byband(op2.p[0], op2.spectral, op1.spectral)
    tau12 = op1.tau + tau2
    tauscat12 = op1.tau * op1.ssa + tau2 * ssa2

    if isinstance(op1, OpticalProps2str):
        g = (op1.tau * op1.ssa * op1.g + tau2 * ssa2 * g2) / torch.clamp_min(tauscat12, eps)
        ssa = tauscat12 / torch.clamp_min(tau12, eps)
        return dataclasses.replace(op1, tau=tau12, ssa=ssa, g=g)

    # nstr destination
    if isinstance(op2, OpticalPropsNstr):
        p2 = torch.stack([_expand_if_byband(m, op2.spectral, op1.spectral) for m in op2.p])
        if p2.shape[0] != op1.p.shape[0]:
            raise ValueError("increment: moment counts differ for nstr+nstr")
    else:  # 2str source: moments from the asymmetry, p_m = g**m
        m = torch.arange(1, op1.p.shape[0] + 1, dtype=op1.tau.dtype, device=op1.tau.device)
        p2 = g2[None] ** m[:, None, None, None]
    p = ((op1.p * (op1.tau * op1.ssa)[None] + p2 * (tau2 * ssa2)[None])
         / torch.clamp_min(tauscat12, eps)[None])
    ssa = tauscat12 / torch.clamp_min(tau12, eps)
    return dataclasses.replace(op1, tau=tau12, ssa=ssa, p=p)


def subset(op, start: int, n: int):
    """Columns [start, start + n) of ``op``."""
    sl = slice(start, start + n)
    if isinstance(op, OpticalProps1scl):
        return dataclasses.replace(op, tau=op.tau[sl])
    if isinstance(op, OpticalProps2str):
        return dataclasses.replace(op, tau=op.tau[sl], ssa=op.ssa[sl], g=op.g[sl])
    return dataclasses.replace(op, tau=op.tau[sl], ssa=op.ssa[sl], p=op.p[:, sl])
