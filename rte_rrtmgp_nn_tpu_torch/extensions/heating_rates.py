"""Heating rates from flux profiles.

Port of rte_rrtmgp_nn_tpu/extensions/heating_rates.py (reference
extensions/mo_heating_rates.F90:48-52):
    HR [K/s] = g/cp * d(F_net)/dp,   F_net = F_dn - F_up
per layer, from the level fluxes that bracket it, plus the K/day variant
of the eval drivers (rrtmgp_lw_eval_nn_rfmip.F90 calc_heating_rate).
"""
from __future__ import annotations

import torch

from ..constants import constants

SECONDS_PER_DAY = 86400.0


def compute_heating_rate(flux_up: torch.Tensor, flux_dn: torch.Tensor,
                         plev: torch.Tensor) -> torch.Tensor:
    """Layer heating rate [K/s]: flux_up / flux_dn (ncol, nlay+1) broadband
    level fluxes, plev (ncol, nlay+1) level pressures [Pa] -> (ncol, nlay)."""
    net = flux_dn - flux_up
    return constants.grav / constants.cp_dry * (net[:, 1:] - net[:, :-1]) \
        / (plev[:, 1:] - plev[:, :-1])


def compute_heating_rate_kday(flux_up, flux_dn, plev) -> torch.Tensor:
    """Heating rate in K/day, the unit of the training-eval metrics."""
    return compute_heating_rate(flux_up, flux_dn, plev) * SECONDS_PER_DAY
