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

    @staticmethod
    def from_fortran_limits(band_lims_gpt_1based, band_lims_wvn) -> "SpectralMapping":
        """From a k-distribution file's 1-based inclusive [start, end] pairs
        (reference ``bnd_limits_gpt``)."""
        blg = np.asarray(band_lims_gpt_1based, dtype=np.int64).copy()
        blg[:, 0] -= 1  # the inclusive 1-based end is the exclusive 0-based one
        return SpectralMapping.create(blg, band_lims_wvn)

    @staticmethod
    def bands_only(band_lims_wvn) -> "SpectralMapping":
        """One g-point per band (band-resolved cloud optics; reference
        mo_optical_props.F90 init without band_lims_gpt)."""
        nband = np.asarray(band_lims_wvn).shape[0]
        blg = np.stack([np.arange(nband), np.arange(nband) + 1], axis=1)
        return SpectralMapping.create(blg, band_lims_wvn)

    def gpt_subset(self, start: int, stop: int) -> "SpectralMapping":
        """The mapping of g-points [start, stop) alone (a rank's block under
        a split of the g-points): every band is kept, its g-point range
        clipped to the block and numbered from 0, so per-band values index
        as before and a band outside the block has no g-point."""
        n = stop - start
        blg = [(min(max(s - start, 0), n), min(max(e - start, 0), n))
               for s, e in self.band_lims_gpt]
        return SpectralMapping(tuple(blg), self.band_lims_wvn)

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
    def band_lims_gpt_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_gpt, dtype=np.int64)

    @property
    def band_lims_wvn_array(self) -> np.ndarray:
        return np.asarray(self.band_lims_wvn, dtype=np.float64)

    def gpts_are_equal(self, other: "SpectralMapping") -> bool:
        return self.band_lims_gpt == other.band_lims_gpt

    def bands_are_equal(self, other: "SpectralMapping") -> bool:
        return self.nband == other.nband and np.allclose(
            self.band_lims_wvn_array, other.band_lims_wvn_array)

    def gpt2band_tensor(self, device) -> torch.Tensor:
        """``gpt2band`` as an int32 tensor on ``device`` (the fused kernels'
        band index)."""
        return torch.tensor(self.gpt2band, dtype=torch.int32, device=device)

    def expand(self, band_values: torch.Tensor) -> torch.Tensor:
        """Per-band (..., nband) -> per-g-point (..., ngpt) by indexing the
        last axis with ``gpt2band``."""
        idx = torch.tensor(self.gpt2band, device=band_values.device)
        return band_values[..., idx]

    def reduce_sum(self, gpt_values: torch.Tensor) -> torch.Tensor:
        """Per-g-point (..., ngpt) -> per-band sums (..., nband) (the
        by-band flux reduction, mo_fluxes_byband_kernels.F90:31-66): each
        band's g-points are contiguous."""
        return torch.stack([gpt_values[..., s:e].sum(-1) for s, e in self.band_lims_gpt], dim=-1)
