"""Gas volume-mixing-ratio container.

Port of rte_rrtmgp_nn_tpu/gas_concs.py (reference
rrtmgp/mo_gas_concentrations.F90 and mo_gas_ref_concentrations.F90): each
gas is stored as a tensor of shape (), (nlay,) or (ncol, nlay) and
broadcast on read.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

_CHEM_NAME_MAP = {
    # RFMIP-style long names -> kdist names (reference determine_gas_names)
    "carbon_dioxide": "co2",
    "methane": "ch4",
    "nitrous_oxide": "n2o",
    "water_vapor": "h2o",
    "ozone": "o3",
    "carbon_monoxide": "co",
    "nitrogen": "n2",
    "oxygen": "o2",
}


def normalize_gas_name(name: str) -> str:
    n = name.lower().strip()
    return _CHEM_NAME_MAP.get(n, n)


@dataclasses.dataclass(frozen=True)
class GasConcs:
    """Mapping gas name -> VMR tensor of shape (), (nlay,), or (ncol, nlay)."""

    concs: dict  # str -> torch.Tensor

    def __post_init__(self):
        for k in self.concs:
            if k != normalize_gas_name(k):
                raise ValueError(f"gas name {k!r} not normalized (use GasConcs.create)")

    @staticmethod
    def create(vmrs: Mapping[str, object]) -> "GasConcs":
        """Normalize names, convert to tensors and check the [0, 1] range
        (the reference's set_vmr validation)."""
        out = {}
        for name, v in vmrs.items():
            arr = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            if arr.ndim > 2:
                raise ValueError(f"{name}: VMR must be scalar, (nlay,), or (ncol, nlay)")
            if bool(torch.any(arr < 0.0)) or bool(torch.any(arr > 1.0)):
                raise ValueError(f"create({name}): values outside [0,1]")
            out[normalize_gas_name(name)] = arr
        return GasConcs(out)

    @property
    def gas_names(self) -> list[str]:
        return list(self.concs.keys())

    def __contains__(self, name: str) -> bool:
        return normalize_gas_name(name) in self.concs

    def get_vmr(self, name: str, ncol: int, nlay: int) -> torch.Tensor:
        """The stored VMR broadcast to (ncol, nlay) (reference get_vmr)."""
        arr = self.concs[normalize_gas_name(name)]
        if arr.ndim == 0:
            return arr.expand(ncol, nlay)
        if arr.ndim == 1:
            return arr[None, :].expand(ncol, nlay)
        return arr

    def get_raw(self, name: str) -> torch.Tensor:
        return self.concs[normalize_gas_name(name)]

    def set_vmr(self, name: str, value) -> "GasConcs":
        """A copy with ``name`` set to ``value``, checked to lie in [0, 1]
        (reference set_vmr, mo_gas_concentrations.F90:130-250)."""
        arr = torch.as_tensor(value if torch.is_tensor(value) else np.asarray(value))
        if bool(torch.any(arr < 0.0)) or bool(torch.any(arr > 1.0)):
            raise ValueError(f"set_vmr({name}): values outside [0,1]")
        return GasConcs({**self.concs, normalize_gas_name(name): arr})

    def subset(self, start: int, n: int) -> "GasConcs":
        """Columns [start, start + n) (reference get_subset_range): 2-D
        entries are sliced, scalars and per-layer profiles shared."""
        return GasConcs({k: v[start:start + n] if v.ndim == 2 else v
                         for k, v in self.concs.items()})


# Reference-scenario global-mean VMRs (reference
# rrtmgp/mo_gas_ref_concentrations.F90:46-60): present-day, pre-industrial,
# future.
_REF_VMR = {
    #            present-day    pre-industrial  future
    "co2":      (397.5470e-6,   284.3170e-6,    1066.850e-6),
    "n2o":      (326.9880e-9,   273.0211e-9,    389.3560e-9),
    "co":       (1.200000e-7,   1.000000e-8,    1.800000e-7),
    "ch4":      (1831.471e-9,   808.2490e-9,    2478.709e-9),
    "ccl4":     (83.06993e-12,  0.0250004e-12,  6.082623e-12),
    "cfc11":    (233.0799e-12,  0.0,            57.17037e-12),
    "cfc12":    (520.5810e-12,  0.0,            221.1720e-12),
    "cfc22":    (229.5421e-12,  0.0,            0.856923e-12),
    "hfc143a":  (15.25278e-12,  0.0,            713.8991e-12),
    "hfc125":   (15.35501e-12,  0.0,            966.1801e-12),
    "hfc23":    (26.89044e-12,  0.0,            24.61550e-12),
    "hfc32":    (8.336969e-12,  0.0002184e-12,  0.046355e-12),
    "hfc134a":  (80.51573e-12,  0.0,            421.3692e-12),
    "cf4":      (81.09249e-12,  34.050000e-12,  126.5040e-12),
}


def get_ref_vmr(scenario_index: int, gas: str) -> float:
    """Reference-scenario global-mean VMR for a gas (reference get_ref_vmr);
    1 = present-day, 2 = pre-industrial, 3 = future. 0.0 for unknown
    gases."""
    g = normalize_gas_name(gas)
    if g not in _REF_VMR:
        return 0.0
    if scenario_index not in (1, 2, 3):
        raise ValueError(f"scenario_index must be 1..3, got {scenario_index}")
    return _REF_VMR[g][scenario_index - 1]
