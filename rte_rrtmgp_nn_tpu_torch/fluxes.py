"""Broadband flux container (port of rte_rrtmgp_nn_tpu/fluxes.py
``FluxesBroadband``; reference rte/mo_fluxes.F90 ty_fluxes_broadband)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FluxesBroadband:
    """(ncol, nlev) broadband fluxes [W/m2]; dn_dir optional."""

    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_net: Optional[torch.Tensor] = None
    flux_dn_dir: Optional[torch.Tensor] = None
