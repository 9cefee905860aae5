"""Flux containers and spectral reductions (port of
rte_rrtmgp_nn_tpu/fluxes.py; reference rte/mo_fluxes.F90
ty_fluxes_broadband, rte/kernels/mo_fluxes_broadband_kernels.F90,
extensions/mo_fluxes_byband.F90 with its kernels and
extensions/mo_fluxes_bygpoint.F90). The solvers return spectral (g-point)
or broadband fluxes; the reducers here are plain functions from g-point
fluxes (ncol, nlev, ngpt) to the diagnostics asked for."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .spectral import SpectralMapping


@dataclasses.dataclass(frozen=True)
class FluxesBroadband:
    """(ncol, nlev) broadband fluxes [W/m2]; dn_dir and the Jacobian
    optional."""

    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_net: Optional[torch.Tensor] = None
    flux_dn_dir: Optional[torch.Tensor] = None
    flux_up_jac: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FluxesByband:
    """Broadband plus band-resolved fluxes (ncol, nlev, nband)."""

    broadband: FluxesBroadband
    bnd_flux_up: torch.Tensor
    bnd_flux_dn: torch.Tensor
    bnd_flux_net: Optional[torch.Tensor] = None
    bnd_flux_dn_dir: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FluxesBygpoint:
    """Spectral fluxes as they are (ncol, nlev, ngpt)."""

    gpt_flux_up: torch.Tensor
    gpt_flux_dn: torch.Tensor
    gpt_flux_net: Optional[torch.Tensor] = None
    gpt_flux_dn_dir: Optional[torch.Tensor] = None


def sum_broadband(gpt_flux: torch.Tensor) -> torch.Tensor:
    """(ncol, nlev, ngpt) -> (ncol, nlev)."""
    return gpt_flux.sum(-1)


def net_broadband(flux_dn: torch.Tensor, flux_up: torch.Tensor) -> torch.Tensor:
    return flux_dn - flux_up


def net_broadband_full(gpt_flux_dn: torch.Tensor, gpt_flux_up: torch.Tensor) -> torch.Tensor:
    """Net broadband flux from the spectral fluxes (net_broadband_full)."""
    return (gpt_flux_dn - gpt_flux_up).sum(-1)


def sum_byband(gpt_flux: torch.Tensor, spectral: SpectralMapping) -> torch.Tensor:
    """(ncol, nlev, ngpt) -> (ncol, nlev, nband) (reference sum_byband,
    mo_fluxes_byband_kernels.F90:31-66)."""
    return spectral.reduce_sum(gpt_flux)


def net_byband(bnd_flux_dn: torch.Tensor, bnd_flux_up: torch.Tensor) -> torch.Tensor:
    return bnd_flux_dn - bnd_flux_up


def reduce_broadband(gpt_flux_up, gpt_flux_dn, gpt_flux_dn_dir=None,
                     gpt_flux_up_jac=None, with_net: bool = True) -> FluxesBroadband:
    """Broadband fluxes from spectral (ncol, nlev, ngpt) ones."""
    up = sum_broadband(gpt_flux_up)
    dn = sum_broadband(gpt_flux_dn)
    return FluxesBroadband(
        flux_up=up,
        flux_dn=dn,
        flux_net=net_broadband(dn, up) if with_net else None,
        flux_dn_dir=None if gpt_flux_dn_dir is None else sum_broadband(gpt_flux_dn_dir),
        flux_up_jac=None if gpt_flux_up_jac is None else sum_broadband(gpt_flux_up_jac),
    )


def reduce_byband(spectral: SpectralMapping, gpt_flux_up, gpt_flux_dn, gpt_flux_dn_dir=None,
                  with_net: bool = True) -> FluxesByband:
    """Band-resolved and broadband fluxes from spectral ones; the broadband
    sums are taken over the band sums."""
    bu = sum_byband(gpt_flux_up, spectral)
    bd = sum_byband(gpt_flux_dn, spectral)
    return FluxesByband(
        broadband=FluxesBroadband(
            flux_up=bu.sum(-1),
            flux_dn=bd.sum(-1),
            flux_net=(bd - bu).sum(-1) if with_net else None,
            flux_dn_dir=None if gpt_flux_dn_dir is None else gpt_flux_dn_dir.sum(-1),
        ),
        bnd_flux_up=bu,
        bnd_flux_dn=bd,
        bnd_flux_net=net_byband(bd, bu) if with_net else None,
        bnd_flux_dn_dir=None if gpt_flux_dn_dir is None else sum_byband(gpt_flux_dn_dir, spectral),
    )
