"""Cloud optics: band-resolved cloud optical properties from water path and
particle effective radius.

Port of rte_rrtmgp_nn_tpu/extensions/cloud_optics.py (reference
extensions/cloud_optics/mo_cloud_optics.F90: ty_cloud_optics with either
lookup tables, linear in effective radius, liquid and ice with roughness
categories, ``compute_all_from_table`` :603-645; or Pade approximants in
three size regimes, [2/3] for extinction and [2/2] for ssa and asymmetry,
``compute_all_from_pade`` + ``pade_eval`` :650-775; ``cloud_optics()``
combines liquid and ice into tau / tau*ssa / tau*ssa*g, :354-535;
``set_ice_roughness`` :541-554).

The table interpolation is an indexed load from the float32 tables with the
grouping ``lo + frac * (hi - lo)``. These are plain tensor functions: the
staged all-sky cores call them on any device; the fused kernels' lookup-table
mode does the same arithmetic inside the kernel, on the tables as
``CloudOptics.lut_pack`` lays them out.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional

import numpy as np
import torch

from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..spectral import SpectralMapping
from ..utils import ncio

LUT_FIELDS = ("lut_extliq", "lut_ssaliq", "lut_asyliq",
              "lut_extice", "lut_ssaice", "lut_asyice")
PADE_FIELDS = ("pade_extliq", "pade_ssaliq", "pade_asyliq",
               "pade_extice", "pade_ssaice", "pade_asyice")
SIZREG_FIELDS = ("pade_sizreg_extliq", "pade_sizreg_ssaliq", "pade_sizreg_asyliq",
                 "pade_sizreg_extice", "pade_sizreg_ssaice", "pade_sizreg_asyice")
RADIUS_FIELDS = ("radliq_lwr", "radliq_upr", "radice_lwr", "radice_upr")


@dataclasses.dataclass(frozen=True, eq=False)
class CloudOptics:
    """Loaded cloud-optics data. Exactly one of (lut_*, pade_*) is present.

    LUT tensors are (nband, nsize) for liquid and (nrghice, nband, nsize)
    for ice; Pade tensors are (ncoeff, nsizereg, nband) for liquid and
    (nrghice, ncoeff, nsizereg, nband) for ice (file order). Instances
    compare and hash by identity.
    """

    spectral: SpectralMapping
    radliq_lwr: float
    radliq_upr: float
    radice_lwr: float
    radice_upr: float
    lut_extliq: Optional[torch.Tensor] = None
    lut_ssaliq: Optional[torch.Tensor] = None
    lut_asyliq: Optional[torch.Tensor] = None
    lut_extice: Optional[torch.Tensor] = None
    lut_ssaice: Optional[torch.Tensor] = None
    lut_asyice: Optional[torch.Tensor] = None
    pade_extliq: Optional[torch.Tensor] = None
    pade_ssaliq: Optional[torch.Tensor] = None
    pade_asyliq: Optional[torch.Tensor] = None
    pade_extice: Optional[torch.Tensor] = None
    pade_ssaice: Optional[torch.Tensor] = None
    pade_asyice: Optional[torch.Tensor] = None
    pade_sizreg_extliq: Optional[tuple] = None
    pade_sizreg_ssaliq: Optional[tuple] = None
    pade_sizreg_asyliq: Optional[tuple] = None
    pade_sizreg_extice: Optional[tuple] = None
    pade_sizreg_ssaice: Optional[tuple] = None
    pade_sizreg_asyice: Optional[tuple] = None
    icergh: int = 1  # ice roughness category, 1-based (set_ice_roughness)

    @property
    def is_lut(self) -> bool:
        return self.lut_extliq is not None

    @property
    def nband(self) -> int:
        return self.spectral.nband

    # reference get_min/max_radius_liq/ice
    @property
    def min_radius_liq(self):
        return self.radliq_lwr

    @property
    def max_radius_liq(self):
        return self.radliq_upr

    @property
    def min_radius_ice(self):
        return self.radice_lwr

    @property
    def max_radius_ice(self):
        return self.radice_upr

    def set_ice_roughness(self, icergh: int) -> "CloudOptics":
        nr = (self.lut_extice if self.is_lut else self.pade_extice).shape[0]
        if not 1 <= icergh <= nr:
            raise ValueError(f"ice roughness {icergh} out of range 1..{nr}")
        return dataclasses.replace(self, icergh=icergh)

    @functools.cached_property
    def lut_pack(self):
        """The fused kernels' view of lookup-table cloud optics, made at
        first use and kept with this object (``to`` and ``set_ice_roughness``
        return new objects, which pack anew): per phase (liquid; ice at the
        set roughness) one contiguous float32 (nsize, 3 * nband) table of
        [ext | ssa | asy] rows on the tensors' device, and the even radius
        grids' (offset, step). Returns (liq, ice, (liq_off, liq_step,
        ice_off, ice_step))."""
        if not self.is_lut:
            raise ValueError("lut_pack needs lookup-table cloud optics")
        r = self.icergh - 1
        liq = lut_table(self.lut_extliq, self.lut_ssaliq, self.lut_asyliq).float()
        ice = lut_table(self.lut_extice[r], self.lut_ssaice[r], self.lut_asyice[r]).float()
        geom = (self.radliq_lwr, (self.radliq_upr - self.radliq_lwr) / (liq.shape[0] - 1),
                self.radice_lwr, (self.radice_upr - self.radice_lwr) / (ice.shape[0] - 1))
        return liq, ice, geom

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "CloudOptics":
        """The same data with every tensor on ``device`` (and in ``dtype``)."""
        moved = {n: getattr(self, n).to(device=device, dtype=dtype)
                 for n in LUT_FIELDS + PADE_FIELDS if getattr(self, n) is not None}
        return dataclasses.replace(self, **moved)


def cloud_optics_from_arrays(arrays: Mapping[str, object], spectral: SpectralMapping,
                             device, dtype=torch.float32) -> CloudOptics:
    """A CloudOptics from its fields as numpy arrays and numbers (the table
    or Pade arrays, the four radius bounds, the ``pade_sizreg_*`` bounds,
    ``icergh``), on the band grid ``spectral``: the counterpart of
    ``nn_model_from_arrays`` for cloud-optics data."""
    kw = {n: float(arrays[n]) for n in RADIUS_FIELDS}
    for n in LUT_FIELDS + PADE_FIELDS:
        if arrays.get(n) is not None:
            kw[n] = torch.as_tensor(np.array(arrays[n]), dtype=dtype, device=device)
    for n in SIZREG_FIELDS:
        if arrays.get(n) is not None:
            kw[n] = tuple(float(x) for x in np.asarray(arrays[n]).ravel())
    return CloudOptics(spectral=spectral, icergh=int(arrays.get("icergh", 1)), **kw)


def load_cloud_optics(path: str, dtype=torch.float32, prefer: str = "lut", *,
                      device) -> CloudOptics:
    """Load a cloud-optics coefficient file onto ``device``; tables or Pade
    coefficients are detected from its variables (reference load_lut
    :91-173 / load_pade :179-301). When a file holds both, ``prefer``
    ('lut' or 'pade') picks one."""
    with ncio.NCFile(path) as f:
        spectral = SpectralMapping.bands_only(f.read("bnd_limits_wavenumber"))
        arrays = {n: f.read(n) for n in RADIUS_FIELDS}
        have_lut, have_pade = f.has_var("lut_extliq"), f.has_var("pade_extliq")
        if have_lut and have_pade:
            have_lut, have_pade = prefer == "lut", prefer != "lut"
        if have_lut:
            arrays.update({n: f.read(n, np.float64) for n in LUT_FIELDS})
        if have_pade:
            arrays.update({n: f.read(n, np.float64) for n in PADE_FIELDS + SIZREG_FIELDS})
    return cloud_optics_from_arrays(arrays, spectral, device, dtype)


def lut_table(ext_t, ssa_t, asy_t) -> torch.Tensor:
    """One phase's tables (nband, nsize) each as one contiguous (nsize,
    3 * nband) table of [ext | ssa | asy] rows: the layout the fused
    kernels read."""
    return torch.cat([ext_t.T, ssa_t.T, asy_t.T], dim=1).contiguous()


def lut_lerp(wp_, re, table, offset: float, step: float):
    """(tau, tau*ssa, tau*ssa*g) of one phase at band resolution, band
    minor, from ``table`` (lut_table) on an even radius grid: index clamped
    to [0, nsize - 2], fraction not clamped, tau masked by wp > 0 (cells
    without cloud have re = 0, so the mask and not the clamp zeroes them)."""
    nsteps, nband = table.shape[0], table.shape[1] // 3
    fidx = (re - offset) / step
    index = torch.clamp(torch.floor(fidx), 0, nsteps - 2)
    fint = (fidx - index)[..., None]
    index = index.long()
    lo, hi = table[index], table[index + 1]
    vals = lo + fint * (hi - lo)
    t = torch.where((wp_ > 0.0)[..., None], wp_[..., None] * vals[..., :nband], 0.0)
    ts = t * vals[..., nband:2 * nband]
    return t, ts, ts * vals[..., 2 * nband:]


def _from_table(mask, wp_, re, offset, upr, ext_t, ssa_t, asy_t):
    """Linear table interpolation in effective radius; tables (nband,
    nsize). Returns tau, tau*ssa, tau*ssa*g with band as the minor axis,
    zero outside ``mask``."""
    nsteps = ext_t.shape[1]
    t, ts, tsg = lut_lerp(wp_, re, lut_table(ext_t, ssa_t, asy_t), offset,
                          (upr - offset) / (nsteps - 1))
    m = mask[..., None]
    return torch.where(m, t, 0.0), torch.where(m, ts, 0.0), torch.where(m, tsg, 0.0)


def _pade_eval(re, coeffs, irad, m: int, n: int):
    """Horner-evaluated [m/n] Pade approximant; coeffs (ncoeff, nsizereg,
    nband), irad the 0-based regime index of each cell."""
    sel = coeffs.movedim(0, -1)[irad]  # (..., nband, ncoeff)
    re_ = re[..., None]
    denom = sel[..., n + m]
    for i in range(n - 1 + m, m, -1):
        denom = sel[..., i] + re_ * denom
    denom = 1.0 + re_ * denom
    numer = sel[..., m]
    for i in range(m - 1, 0, -1):
        numer = sel[..., i] + re_ * numer
    numer = sel[..., 0] + re_ * numer
    return numer / denom


def _pade_irad(re, bounds):
    """Size-regime index (0-based) by the reference's three-regime formula
    (mo_cloud_optics.F90:689-702), which takes bounds[1] as offset and
    bounds[2] as step."""
    return torch.clamp(torch.floor((re - bounds[1]) / bounds[2]).long() + 1, 0, 2)


def _from_pade(mask, wp_, re, ext, ssa, asy, b_ext, b_ssa, b_asy):
    t = wp_[..., None] * _pade_eval(re, ext, _pade_irad(re, b_ext), 2, 3)
    # the Pade co-albedo can go slightly negative: clamp (reference :698)
    ts = t * (1.0 - torch.clamp_min(_pade_eval(re, ssa, _pade_irad(re, b_ssa), 2, 2), 0.0))
    tsg = ts * _pade_eval(re, asy, _pade_irad(re, b_asy), 2, 2)
    m = mask[..., None]
    return torch.where(m, t, 0.0), torch.where(m, ts, 0.0), torch.where(m, tsg, 0.0)


def cloud_optics(co: CloudOptics, clwp, ciwp, reliq, reice, as_2str: bool = True):
    """Band-resolved cloud optical properties: clwp/ciwp liquid/ice water
    path [g/m2], reliq/reice effective radii [microns], all of one 2-D
    shape. Returns OpticalProps2str (tau, ssa, g) or OpticalProps1scl
    (absorption tau) on the band grid (ngpt == nband), ready for
    ``increment`` with its by-band broadcast."""
    eps = torch.finfo(clwp.dtype).eps
    liqmsk = clwp > 0.0
    icemsk = ciwp > 0.0
    r = co.icergh - 1
    if co.is_lut:
        lt, lts, ltsg = _from_table(liqmsk, clwp, reliq, co.radliq_lwr, co.radliq_upr,
                                    co.lut_extliq, co.lut_ssaliq, co.lut_asyliq)
        it, its, itsg = _from_table(icemsk, ciwp, reice, co.radice_lwr, co.radice_upr,
                                    co.lut_extice[r], co.lut_ssaice[r], co.lut_asyice[r])
    else:
        lt, lts, ltsg = _from_pade(
            liqmsk, clwp, reliq, co.pade_extliq, co.pade_ssaliq, co.pade_asyliq,
            co.pade_sizreg_extliq, co.pade_sizreg_ssaliq, co.pade_sizreg_asyliq)
        it, its, itsg = _from_pade(
            icemsk, ciwp, reice, co.pade_extice[r], co.pade_ssaice[r], co.pade_asyice[r],
            co.pade_sizreg_extice, co.pade_sizreg_ssaice, co.pade_sizreg_asyice)

    if not as_2str:
        # absorption optical depth = tau - tau*ssa (reference 1scl branch)
        return OpticalProps1scl((lt - lts) + (it - its), co.spectral)
    tau = lt + it
    taussa = lts + its
    g = (ltsg + itsg) / torch.clamp_min(taussa, eps)
    ssa = taussa / torch.clamp_min(tau, eps)
    return OpticalProps2str(tau, ssa, g, co.spectral)
