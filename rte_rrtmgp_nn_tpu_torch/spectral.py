"""Spectral discretization: bands and g-points.

Port of rte_rrtmgp_nn_tpu/spectral.py (reference
rte/mo_optical_props.F90 band2gpt / gpt2band bookkeeping and ``expand``).
The mapping is static numpy metadata; ``expand`` is an index on
``gpt2band``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _gpt2band(band_lims_gpt: tuple, ngpt: int) -> np.ndarray:
    out = np.zeros(ngpt, dtype=np.int64)
    for ib, (s, e) in enumerate(band_lims_gpt):
        out[s:e] = ib
    out.flags.writeable = False  # cached: shared across callers
    return out


@dataclasses.dataclass(frozen=True)
class SpectralMapping:
    """Bands <-> g-points. Internal g-point indices are 0-based half-open.

    band_lims_gpt: (nband, 2) int, [start, end) g-point range per band.
    band_lims_wvn: (nband, 2) float, wavenumber limits [cm-1] per band.
    """

    band_lims_gpt: tuple  # nested tuples for hashability
    band_lims_wvn: tuple

    @staticmethod
    def create(band_lims_gpt, band_lims_wvn) -> "SpectralMapping":
        blg = np.asarray(band_lims_gpt, dtype=np.int64)
        blw = np.asarray(band_lims_wvn, dtype=np.float64)
        if blg.shape != blw.shape or blg.ndim != 2 or blg.shape[1] != 2:
            raise ValueError(f"bad band-limit shapes {blg.shape} {blw.shape}")
        return SpectralMapping(
            band_lims_gpt=tuple(map(tuple, blg.tolist())),
            band_lims_wvn=tuple(map(tuple, blw.tolist())),
        )

    @property
    def nband(self) -> int:
        return len(self.band_lims_gpt)

    @property
    def ngpt(self) -> int:
        return max(e for _, e in self.band_lims_gpt)

    @property
    def gpt2band(self) -> np.ndarray:
        """(ngpt,) 0-based band index of each g-point (cached per mapping)."""
        return _gpt2band(self.band_lims_gpt, self.ngpt)

    @property
    def band_lims_wvn_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_wvn, dtype=np.float64)

    def gpt2band_tensor(self, device) -> torch.Tensor:
        """``gpt2band`` as an int32 tensor on ``device`` (the fused kernels'
        band index)."""
        return torch.tensor(self.gpt2band, dtype=torch.int32, device=device)

    def expand(self, band_values: torch.Tensor) -> torch.Tensor:
        """Per-band (..., nband) -> per-g-point (..., ngpt) by indexing the
        last axis with ``gpt2band``."""
        idx = torch.tensor(self.gpt2band, device=band_values.device)
        return band_values[..., idx]
