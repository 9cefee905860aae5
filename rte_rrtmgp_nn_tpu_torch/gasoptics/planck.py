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
from ..utils.timing import span

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


def sw_spectral_g224() -> SpectralMapping:
    """Spectral mapping of the unreduced g-224 SW k-distribution (16
    g-points in each of the 14 bands)."""
    return _mapping_from_counts((16,) * 14, SW_BAND_LIMS_WVN)


def lw_spectral_g256() -> SpectralMapping:
    """Spectral mapping of the unreduced g-256 LW k-distribution (16
    g-points in each of the 16 bands)."""
    return _mapping_from_counts((16,) * 16, LW_BAND_LIMS_WVN)


RUN_OTHER_NETS = (
    "To run nets of another k-distribution, call the drivers (rfmip_clear_sky_lw / _sw, "
    "allsky_lw / _sw) with spectral= the mapping of the nets' own k-distribution "
    "(gasoptics.kdist.load_kdist(path, gases, device=...).spectral), as "
    "testing.sw_pair_setup does.")


def net_gpoints(band: str, models) -> int | None:
    """The g-points that ``models`` predict, as gasoptics.nn_gas_optics
    splits their outputs: LW one "both" net of 2*ngpt outputs (tau ||
    pfrac) or two nets (absorption, Planck fraction) of ngpt each; SW the
    absorption and Rayleigh nets of ngpt each. None where they fit no
    count. Reads host integers only."""
    outs = [m.n_outputs for m in models]
    if band == "lw" and len(outs) == 1:
        return outs[0] // 2 if outs[0] % 2 == 0 else None
    return outs[0] if len(outs) == 2 and outs[0] == outs[1] else None


def _outputs_text(band: str, counts) -> str:
    """The outputs that nets of ``counts`` g-points (any one of them) have."""
    ns = lambda k: " or ".join(str(k * n) for n in counts)
    if band == "lw":
        return f"{ns(2)} outputs in one net, or {ns(1)} in each of two"
    return f"{ns(1)} outputs in each of the absorption and Rayleigh nets"


def spectral_for(band: str, models, *, entry: str, accepts, spectral=None,
                 basis: str | None = None) -> SpectralMapping:
    """The spectral mapping that ``models`` fit (net_gpoints): the caller's
    ``spectral`` when given, else the first of ``accepts`` (mapping
    functions of this module, e.g. ``(sw_spectral_g112, sw_spectral_g224)``)
    of as many g-points. Nets that fit none raise ValueError naming
    ``entry``, the nets' outputs, the mappings expected and how to run such
    nets; ``basis`` says what the entry builds on the mapping (default: its
    inputs). Reads host integers only: callers check before any work."""
    B = band.upper()
    outs = [m.n_outputs for m in models]
    if len(outs) == 1:
        got = f"{outs[0]} outputs in one net"
    elif len(set(outs)) == 1:
        got = f"{outs[0]} outputs in each of {'two' if len(outs) == 2 else len(outs)} nets"
    else:
        got = f"{' and '.join(map(str, outs))} outputs in {len(outs)} nets"
    n = net_gpoints(band, models)
    if spectral is not None:
        if n == spectral.ngpt:
            return spectral
        raise ValueError(
            f"{entry}: the {B} nets ({got}) do not fit the spectral mapping passed "
            f"({spectral.ngpt} g-points: {_outputs_text(band, [spectral.ngpt])}). "
            + RUN_OTHER_NETS)
    mappings = [make() for make in accepts]
    for m in mappings:
        if m.ngpt == n:
            return m
    names = " or ".join(f"g-{m.ngpt}" for m in mappings)
    basis = basis or f"it builds its {B} inputs on that mapping"
    raise ValueError(
        f"{entry} takes the {names} {B} nets "
        f"({_outputs_text(band, [m.ngpt for m in mappings])}), not {got}: {basis}. "
        + RUN_OTHER_NETS)


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
        # contiguous, as the kernels read it (a k-distribution file's table
        # arrives transposed)
        totplnk = totplnk.contiguous()
        return PlanckTable(totplnk, totplnk[1:] - totplnk[:-1],
                           float(temp_ref_min), float(totplnk_delta))

    @staticmethod
    def compute(band_lims_wvn: np.ndarray, *, device, t_min: float = 160.0,
                t_max: float = 355.0, dt: float = 1.0,
                dtype=torch.float32) -> "PlanckTable":
        """The table on [t_min, t_max] every ``dt`` K, made anew: the float64
        quadrature on the host (planck_band_radiance), rounded once to
        ``dtype`` and copied to ``device``. The drivers read it through
        ``kept``, which makes it once per key."""
        temps = np.arange(t_min, t_max + 0.5 * dt, dt)
        tbl = planck_band_radiance(temps, band_lims_wvn)
        return PlanckTable.from_table(
            torch.as_tensor(tbl, dtype=dtype, device=device), t_min, dt)

    @staticmethod
    def kept(band_lims_wvn: np.ndarray, *, device, t_min: float = 160.0,
             t_max: float = 355.0, dt: float = 1.0,
             dtype=torch.float32) -> "PlanckTable":
        """``compute``'s table, kept in ``PLANCK_TABLES`` per band limits,
        grid (``t_min``, ``t_max``, ``dt``), device and dtype: the first call
        of a key computes it under the span ``rte.planck``, every later one
        returns the same object with no host work and no copy. Shared by
        every caller of the key, so read-only."""
        device = placed(device)
        lims = tuple(map(tuple, np.asarray(band_lims_wvn, np.float64).tolist()))
        key = (lims, float(t_min), float(t_max), float(dt), device, dtype)
        return PLANCK_TABLES.get(key, lambda: PlanckTable.compute(
            band_lims_wvn, device=device, t_min=t_min, t_max=t_max, dt=dt, dtype=dtype))

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


def placed(device) -> torch.device:
    """``device`` as a key: a CUDA device without an index is the current
    card's, named with its index, so that a key never stands for two cards."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class KeptTables:
    """Device tables that depend on constants alone, made once per key and
    kept, as the reference keeps ``totplnk`` and the solar source in its
    k-distribution object (mo_gas_optics_rrtmgp.F90:144-152). A miss makes
    the table under the span ``name``, so that span counts misses; a hit
    opens none. Past ``size`` keys the oldest is dropped. A kept table is
    shared by every caller of its key: read-only by contract."""

    def __init__(self, name: str, size: int = 8):
        self.name, self.size = name, size
        self._tables: dict = {}

    def get(self, key, make):
        """The table kept under ``key``, or ``make()``'s, kept."""
        table = self._tables.get(key)
        if table is None:
            with span(self.name):
                table = make()
            self._tables[key] = table
            if len(self._tables) > self.size:
                self._tables.pop(next(iter(self._tables)))
        return table

    def clear(self) -> None:
        self._tables.clear()


# PlanckTable.kept's tables
PLANCK_TABLES = KeptTables("rte.planck")


def compute_planck_source_nn(
    pfrac: torch.Tensor,
    tlay: torch.Tensor,
    tlev: torch.Tensor,
    tsfc: torch.Tensor,
    spectral: SpectralMapping,
    table: PlanckTable,
    top_at_1: bool = True,
    delta_tsfc: float = 1.0,
    lay_axis: int = 1,
):
    """Planck sources from an NN-predicted Planck fraction. Column-major
    (``lay_axis=1``): pfrac (ncol, nlay, ngpt), tlay (ncol, nlay), tlev
    (ncol, nlay+1); layer-major (``lay_axis=0``): pfrac (nlay, ncol, ngpt),
    tlay (nlay, ncol), tlev (nlay+1, ncol). tsfc is (ncol,). Returns
    (lay_source, lev_source, sfc_source, sfc_source_jac); the Jacobian is
    the surface source's change for tsfc + ``delta_tsfc``.

    Level l takes the fraction of layer min(l, nlay-1) in the top-at-0
    orientation. For ``top_at_1=False`` the pairing is DELIBERATELY
    mirrored (level l takes layer max(l-1, 0)), as in the JAX package, so
    that flipped inputs give exactly the flipped canonical solution (the
    vertical-reverse invariant); the reference pairs by index in both
    orientations."""
    nlay = pfrac.shape[lay_axis]
    sfc_lay = nlay - 1 if top_at_1 else 0
    planck_lay = spectral.expand(table.interpolate(tlay))
    planck_lev = spectral.expand(table.interpolate(tlev))
    planck_sfc = spectral.expand(table.interpolate(tsfc))
    planck_sfc_jac = spectral.expand(table.interpolate(tsfc + delta_tsfc))

    lay_source = pfrac * planck_lay
    if top_at_1:
        pfrac_lev = torch.cat([pfrac, pfrac.narrow(lay_axis, nlay - 1, 1)], dim=lay_axis)
    else:
        pfrac_lev = torch.cat([pfrac.narrow(lay_axis, 0, 1), pfrac], dim=lay_axis)
    lev_source = pfrac_lev * planck_lev
    pfrac_sfc = pfrac.select(lay_axis, sfc_lay)
    sfc_source = pfrac_sfc * planck_sfc
    sfc_source_jac = pfrac_sfc * (planck_sfc_jac - planck_sfc)
    return lay_source, lev_source, sfc_source, sfc_source_jac
