"""Planck source computation and the spectral mappings of the shipped NN
models.

Port of rte_rrtmgp_nn_tpu/gasoptics/planck.py. Reference parity:
``compute_Planck_source_nn`` (rrtmgp/kernels/mo_gas_optics_kernels.F90:
615-683) -- per-band linear interpolation of the band-integrated Planck
table ``totplnk`` at layer / level / surface temperatures, times the
NN-predicted Planck fraction per g-point. Without the k-distribution file
the table is computed from first principles (``planck_band_radiance``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import constants
from ..spectral import SpectralMapping

# Standard RRTMGP longwave band limits [cm-1], 16 bands.
LW_BAND_LIMS_WVN = np.array(
    [
        [10.0, 250.0], [250.0, 500.0], [500.0, 630.0], [630.0, 700.0],
        [700.0, 820.0], [820.0, 980.0], [980.0, 1080.0], [1080.0, 1180.0],
        [1180.0, 1390.0], [1390.0, 1480.0], [1480.0, 1800.0], [1800.0, 2080.0],
        [2080.0, 2250.0], [2250.0, 2380.0], [2380.0, 2600.0], [2600.0, 3250.0],
    ]
)
# Standard RRTMGP shortwave band limits [cm-1], 14 bands.
SW_BAND_LIMS_WVN = np.array(
    [
        [820.0, 2680.0], [2680.0, 3250.0], [3250.0, 4000.0], [4000.0, 4650.0],
        [4650.0, 5150.0], [5150.0, 6150.0], [6150.0, 7700.0], [7700.0, 8050.0],
        [8050.0, 12850.0], [12850.0, 16000.0], [16000.0, 22650.0],
        [22650.0, 29000.0], [29000.0, 38000.0], [38000.0, 50000.0],
    ]
)

# G-points per band of the k-distributions the shipped NN models target
# (how they were recovered is documented in the JAX package's planck.py).
LW_G128_GPT_PER_BAND = (10, 14, 13, 13, 13, 5, 7, 6, 10, 7, 8, 8, 5, 3, 2, 4)
SW_G112_GPT_PER_BAND = (10, 8, 11, 8, 9, 10, 11, 4, 9, 9, 8, 4, 8, 3)

# The canonical RRTM 16-point g-space quadrature weights of the unreduced
# k-distributions (g-224 SW / g-256 LW: 16 per band).
W16_CANONICAL = np.array(
    [
        0.1527534276, 0.1491729617, 0.1420961469, 0.1316886544,
        0.1181945205, 0.1019300893, 0.0832767040, 0.0626720116,
        0.0424925000, 0.0046269894, 0.0038279891, 0.0030260086,
        0.0022199750, 0.0014140010, 0.0005330000, 0.0000750000,
    ]
)


def _mapping_from_counts(counts, band_lims_wvn) -> SpectralMapping:
    ends = np.cumsum(counts)
    starts = ends - np.asarray(counts)
    return SpectralMapping.create(np.stack([starts, ends], axis=1), band_lims_wvn)


def lw_spectral_g128() -> SpectralMapping:
    """Spectral mapping of the g-128 LW k-distribution (16 bands)."""
    return _mapping_from_counts(LW_G128_GPT_PER_BAND, LW_BAND_LIMS_WVN)


def sw_spectral_g112() -> SpectralMapping:
    """Spectral mapping of the g-112 SW k-distribution (14 bands)."""
    return _mapping_from_counts(SW_G112_GPT_PER_BAND, SW_BAND_LIMS_WVN)


def gpt_weights_for(spectral: SpectralMapping) -> np.ndarray:
    """Per-g-point quadrature weights (normalized to 1 per band): canonical
    16-point weights for the unreduced distributions, calibrated weights for
    g-112 SW, uniform otherwise."""
    if all(e - s == 16 for s, e in spectral.band_lims_gpt):
        return np.tile(W16_CANONICAL, spectral.nband)
    if spectral.ngpt == 112 and tuple(
        e - s for s, e in spectral.band_lims_gpt
    ) == SW_G112_GPT_PER_BAND:
        from .sw_g112_weights import SW_G112_WEIGHTS

        return SW_G112_WEIGHTS
    out = np.zeros(spectral.ngpt)
    for s, e in spectral.band_lims_gpt:
        out[s:e] = 1.0 / (e - s)
    return out


# Solar brightness temperature vs wavelength [um] (piecewise-linear fit; the
# sun is close to a 5777 K blackbody in the visible/IR, cooler in the UV).
SOLAR_BRIGHTNESS_TEMP = (
    (0.18, 4400.0), (0.21, 4500.0), (0.25, 4850.0), (0.30, 5100.0),
    (0.35, 5450.0), (0.40, 5700.0), (0.45, 5800.0), (0.55, 5850.0),
    (0.70, 5800.0), (1.00, 5777.0), (2.00, 5777.0), (15.0, 5777.0),
)

# Calibrated per-band TSI fractions for the 14 standard SW bands (the
# calibration is documented in the JAX package's planck.py).
SW_SOLAR_BAND_FRAC_CAL = np.array([
    0.00909312, 0.00431360, 0.01349780, 0.01242415, 0.01245213,
    0.03365848, 0.06882194, 0.01813326, 0.26774213, 0.16940386,
    0.25643558, 0.09959361, 0.02677813, 0.00765220,
])


def solar_band_fractions(band_lims_wvn: np.ndarray,
                         calibrated: bool = True) -> np.ndarray:
    """Fraction of the TSI in each band (normalized to 1): the calibrated
    table for the standard 14 SW bands, else the brightness-temperature
    solar spectrum integral."""
    bl = np.asarray(band_lims_wvn, dtype=float)
    if (calibrated and bl.shape == SW_BAND_LIMS_WVN.shape
            and np.allclose(bl, SW_BAND_LIMS_WVN, rtol=5e-2)):
        return SW_SOLAR_BAND_FRAC_CAL.copy()
    h, c, kb = constants.h_planck, constants.c_light, constants.k_boltz
    lam_pts = np.array([p[0] for p in SOLAR_BRIGHTNESS_TEMP])
    t_pts = np.array([p[1] for p in SOLAR_BRIGHTNESS_TEMP])
    fr = np.zeros(len(band_lims_wvn))
    for ib, (w1, w2) in enumerate(np.asarray(band_lims_wvn)):
        nu = np.linspace(w1, w2, 512) * 100.0  # m^-1
        lam_um = 1e6 / nu
        T = np.interp(lam_um, lam_pts, t_pts)
        B = 2 * h * c * c * nu**3 / (np.exp(np.minimum(h * c * nu / (kb * T), 700.0)) - 1.0)
        fr[ib] = np.trapezoid(B, nu)
    return fr / fr.sum()


def planck_band_radiance(temps: np.ndarray, band_lims_wvn: np.ndarray, n_quad: int = 256) -> np.ndarray:
    """Band-integrated Planck radiance B(T, band) [W/m2/sr], computed on the
    host in float64 by Gauss-Legendre quadrature over each band."""
    h, c, kb = constants.h_planck, constants.c_light, constants.k_boltz
    temps = np.atleast_1d(np.asarray(temps, np.float64))
    out = np.zeros((temps.size, band_lims_wvn.shape[0]))
    x, w = np.polynomial.legendre.leggauss(n_quad)
    for ib, (w1, w2) in enumerate(np.asarray(band_lims_wvn, np.float64)):
        nu = (0.5 * (x + 1.0) * (w2 - w1) + w1) * 100.0  # m^-1
        wgt = w * 0.5 * (w2 - w1) * 100.0  # m^-1
        expo = np.exp(np.clip(h * c * nu[None, :] / (kb * temps[:, None]), None, 700.0))
        b = 2.0 * h * c * c * nu[None, :] ** 3 / (expo - 1.0)
        out[:, ib] = b @ wgt
    return out


@dataclasses.dataclass(frozen=True)
class PlanckTable:
    """The totplnk table, its forward differences and its temperature axis.

    ``totplnk_diff[i] = totplnk[i+1] - totplnk[i]`` is taken once, in the
    table's precision, so every interpolation (plain or in a kernel) reads
    the same two rows."""

    totplnk: torch.Tensor  # (ntab, nband) band Planck radiance [W/m2/sr]
    totplnk_diff: torch.Tensor  # (ntab - 1, nband)
    temp_ref_min: float
    totplnk_delta: float

    @staticmethod
    def from_table(totplnk: torch.Tensor, temp_ref_min: float,
                   totplnk_delta: float) -> "PlanckTable":
        return PlanckTable(totplnk, totplnk[1:] - totplnk[:-1],
                           float(temp_ref_min), float(totplnk_delta))

    @staticmethod
    def compute(band_lims_wvn: np.ndarray, *, device, t_min: float = 160.0,
                t_max: float = 355.0, dt: float = 1.0,
                dtype=torch.float32) -> "PlanckTable":
        temps = np.arange(t_min, t_max + 0.5 * dt, dt)
        tbl = planck_band_radiance(temps, band_lims_wvn)
        return PlanckTable.from_table(
            torch.as_tensor(tbl, dtype=dtype, device=device), t_min, dt)

    def to(self, device) -> "PlanckTable":
        return PlanckTable(self.totplnk.to(device), self.totplnk_diff.to(device),
                           self.temp_ref_min, self.totplnk_delta)

    def interpolate(self, t: torch.Tensor) -> torch.Tensor:
        """Linear interpolation at temperatures t (...,) -> (..., nband),
        as the reference interpolate1D (mo_gas_optics_kernels.F90:
        1024-1044): index = trunc toward zero, clamped to [0, ntab-2];
        fraction = val - trunc(val), NOT clamped."""
        ntab = self.totplnk.shape[0]
        val0 = (t - self.temp_ref_min) / self.totplnk_delta
        itr = val0.to(torch.int32)  # truncation toward zero
        idx0 = torch.clamp(itr, 0, ntab - 2).long()
        frac = val0 - itr.to(val0.dtype)
        return self.totplnk[idx0] + frac[..., None] * self.totplnk_diff[idx0]


def compute_planck_source_nn(
    pfrac: torch.Tensor,
    tlay: torch.Tensor,
    tlev: torch.Tensor,
    tsfc: torch.Tensor,
    spectral: SpectralMapping,
    table: PlanckTable,
    top_at_1: bool = True,
    delta_tsfc: float = 1.0,
):
    """Planck sources from an NN-predicted Planck fraction, layer-major:
    pfrac (nlay, ncol, ngpt), tlay (nlay, ncol), tlev (nlay+1, ncol), tsfc
    (ncol,). Returns (lay_source, lev_source, sfc_source, sfc_source_jac).

    Level l takes the fraction of layer min(l, nlay-1) in the top-at-0
    orientation; for ``top_at_1=False`` the pairing is mirrored (level l
    takes layer max(l-1, 0)), as in the JAX package."""
    nlay = pfrac.shape[0]
    sfc_lay = nlay - 1 if top_at_1 else 0
    planck_lay = spectral.expand(table.interpolate(tlay))
    planck_lev = spectral.expand(table.interpolate(tlev))
    planck_sfc = spectral.expand(table.interpolate(tsfc))
    planck_sfc_jac = spectral.expand(table.interpolate(tsfc + delta_tsfc))

    lay_source = pfrac * planck_lay
    if top_at_1:
        pfrac_lev = torch.cat([pfrac, pfrac[-1:]], dim=0)
    else:
        pfrac_lev = torch.cat([pfrac[:1], pfrac], dim=0)
    lev_source = pfrac_lev * planck_lev
    pfrac_sfc = pfrac[sfc_lay]
    sfc_source = pfrac_sfc * planck_sfc
    sfc_source_jac = pfrac_sfc * (planck_sfc_jac - planck_sfc)
    return lay_source, lev_source, sfc_source, sfc_source_jac
