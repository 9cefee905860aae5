"""Planck and solar source-function containers.

Port of rte_rrtmgp_nn_tpu/sources.py (reference rte/mo_source_functions.F90:
ty_source_func_lw with a single level source, the surface source and its
surface-temperature Jacobian, and the optional saved Planck fraction;
ty_source_func_sw with the TOA source).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .spectral import SpectralMapping


@dataclasses.dataclass(frozen=True)
class SourceFuncLW:
    lay_source: torch.Tensor      # (ncol, nlay, ngpt) Planck source at layer mean T
    lev_source: torch.Tensor      # (ncol, nlay+1, ngpt) Planck source at levels
    sfc_source: torch.Tensor      # (ncol, ngpt)
    sfc_source_jac: torch.Tensor  # (ncol, ngpt) d(sfc_source)/dT_sfc
    spectral: SpectralMapping
    # Saved Planck fraction for NN training data; None if unused.
    planck_frac: Optional[torch.Tensor] = None  # (ncol, nlay, ngpt)

    @property
    def ncol(self) -> int:
        return self.lay_source.shape[0]

    @property
    def nlay(self) -> int:
        return self.lay_source.shape[1]

    @property
    def ngpt(self) -> int:
        return self.lay_source.shape[2]

    def subset(self, start: int, n: int) -> "SourceFuncLW":
        """Columns [start, start + n)."""
        sl = slice(start, start + n)
        return dataclasses.replace(
            self, lay_source=self.lay_source[sl], lev_source=self.lev_source[sl],
            sfc_source=self.sfc_source[sl], sfc_source_jac=self.sfc_source_jac[sl],
            planck_frac=None if self.planck_frac is None else self.planck_frac[sl])


@dataclasses.dataclass(frozen=True)
class SourceFuncSW:
    toa_source: torch.Tensor  # (ncol, ngpt) TOA spectral solar flux
    spectral: SpectralMapping

    @property
    def ncol(self) -> int:
        return self.toa_source.shape[0]

    @property
    def ngpt(self) -> int:
        return self.toa_source.shape[1]
