"""K-distribution state and loader.

Port of rte_rrtmgp_nn_tpu/gasoptics/kdist.py. Reference parity:
``rrtmgp/mo_gas_optics_rrtmgp.F90`` -- ``load_int``/``load_ext`` ->
``init_abs_coeffs`` (:1130-1541): prune gases to those available, reduce
the minor-gas arrays (``reduce_minor_arrays`` :1922-2035), build the flavor
list from key species (``create_flavor`` :1802-1836) and the per-g-point
flavor map (``create_gpoint_flavor`` :2058-2074) -- plus the netCDF
variable set of ``examples/mo_load_coefficients.F90:104-250`` (including the
``plank_fraction`` spelling).

Array layouts (C order, g-point minor):
  kmajor, pfracin: (ntemp, npres+1, neta, ngpt)
  kminor_{lower,upper}: (ntemp, neta, ncontributors)
  krayl: (2, ntemp, neta, ngpt)       [itropo]
  vmr_ref: (2, 1+ngas, ntemp)         [itropo, 0=dry air]
  totplnk: (nPlanckTemp, nband)
The file is read and reduced on the host with numpy (``read_kdist_arrays``);
``kdist_from_arrays`` puts the tables on a device as tensors. Flavors, minor
maps and grids stay host tuples; the index tensors the lookups need are made
once per ``KDist`` (``flavor_index``, ``gpoint_flavor_index``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..gas_concs import GasConcs, normalize_gas_name
from ..spectral import SpectralMapping
from ..utils import ncio
from .planck import PlanckTable

# NRLSSI2 facular and sunspot index offsets (reference
# mo_gas_optics_rrtmgp.F90:1075-1083)
SOLAR_A_OFFSET = 0.1495954
SOLAR_B_OFFSET = 0.00066696

_MINOR_META = ("limits_gpt", "scales_with_density", "scale_by_complement", "idx_minor",
               "idx_minor_scaling", "kminor_start")
_TABLES = ("vmr_ref", "kmajor", "krayl", "pfracin", "solar_quiet", "solar_facular",
           "solar_sunspot")


@dataclasses.dataclass(frozen=True)
class MinorGasData:
    """Per-atmosphere (lower/upper) minor-gas data after reduction. The
    g-point limits are 0-based half-open."""

    kminor: torch.Tensor  # (ntemp, neta, ncontributors)
    limits_gpt: tuple  # ((start, end), ...) per minor interval
    scales_with_density: tuple  # bool per interval
    scale_by_complement: tuple  # bool per interval
    idx_minor: tuple  # col_gas index of the minor gas per interval
    idx_minor_scaling: tuple  # col_gas index of the scaling gas, -1 if none
    kminor_start: tuple  # 0-based start row in kminor per interval

    @property
    def n_minor(self) -> int:
        return len(self.limits_gpt)

    def to(self, device) -> "MinorGasData":
        return dataclasses.replace(self, kminor=self.kminor.to(device))


@dataclasses.dataclass(frozen=True)
class KDist:
    """Loaded k-distribution (LW or SW)."""

    spectral: SpectralMapping
    gas_names: tuple  # reduced to the available gases; the col_gas axis is [dry] + these
    press_ref_log: tuple  # (npres,) log(Pa), decreasing
    temp_ref: tuple  # (ntemp,) K, increasing
    press_ref_trop_log: float
    flavor: tuple  # ((ig1, ig2), ...) 0-based into the col_gas axis (0 = dry)
    gpoint_flavor: tuple  # ((flav_lower, flav_upper), ...) per g-point, 0-based
    vmr_ref: torch.Tensor  # (2, 1+ngas, ntemp)
    kmajor: torch.Tensor  # (ntemp, npres+1, neta, ngpt)
    minor_lower: MinorGasData
    minor_upper: MinorGasData
    krayl: Optional[torch.Tensor] = None  # (2, ntemp, neta, ngpt)
    # LW only
    pfracin: Optional[torch.Tensor] = None  # like kmajor
    planck: Optional[PlanckTable] = None
    optimal_angle_fit: Optional[tuple] = None  # (nband, 2)
    # SW only
    solar_quiet: Optional[torch.Tensor] = None  # (ngpt,)
    solar_facular: Optional[torch.Tensor] = None
    solar_sunspot: Optional[torch.Tensor] = None
    tsi_default: float = 0.0
    mg_default: float = 0.0
    sb_default: float = 0.0

    @property
    def ngas(self) -> int:
        return len(self.gas_names)

    @property
    def nflav(self) -> int:
        return len(self.flavor)

    @property
    def neta(self) -> int:
        return self.kmajor.shape[2]

    @property
    def npres(self) -> int:
        return len(self.press_ref_log)

    @property
    def ntemp(self) -> int:
        return len(self.temp_ref)

    @property
    def ngpt(self) -> int:
        return self.spectral.ngpt

    @property
    def nband(self) -> int:
        return self.spectral.nband

    @property
    def is_internal_source(self) -> bool:
        """LW if the file carried a Planck table."""
        return self.planck is not None

    @property
    def press_ref_min(self) -> float:
        return float(np.exp(min(self.press_ref_log)))

    @property
    def press_ref_max(self) -> float:
        return float(np.exp(max(self.press_ref_log)))

    @property
    def temp_ref_min(self) -> float:
        return float(self.temp_ref[0])

    @property
    def temp_ref_max(self) -> float:
        return float(self.temp_ref[-1])

    @property
    def press_ref_log_delta(self) -> float:
        return (min(self.press_ref_log) - max(self.press_ref_log)) / (self.npres - 1)

    @property
    def temp_ref_delta(self) -> float:
        return (self.temp_ref_max - self.temp_ref_min) / (self.ntemp - 1)

    @functools.cached_property
    def flavor_index(self) -> torch.Tensor:
        """``flavor`` as an (nflav, 2) index tensor on the tables' device."""
        return torch.tensor(self.flavor, dtype=torch.long, device=self.kmajor.device)

    @functools.cached_property
    def gpoint_flavor_index(self) -> torch.Tensor:
        """``gpoint_flavor`` as an (ngpt, 2) index tensor on the tables'
        device: [:, 0] the lower atmosphere's flavor, [:, 1] the upper's."""
        return torch.tensor(self.gpoint_flavor, dtype=torch.long, device=self.kmajor.device)

    @functools.cached_property
    def kernel_tables(self) -> dict:
        """The index tables the fused lookup-table kernel (K10,
        ``ops/cuda/lut_gas_optics.py``) reads, on the tables' device, made
        once: ``temp_ref``, int32 ``flavor`` (nflav, 2) and ``gflav`` (ngpt,
        2), ``minor`` (nminor, 8) int32 rows of both atmospheres' minor
        intervals, the lower first: atmosphere (0 lower, 1 upper), first and
        end g-point, kminor start, flavor, gas, scaling gas (-1 none), flags
        (1 scales with density, 2 by complement); and the tables it reads,
        contiguous (``vmr_ref`` is a transposed copy of the file's)."""
        dev = self.kmajor.device
        rows = []
        for upper, m in enumerate((self.minor_lower, self.minor_upper)):
            for i in range(m.n_minor):
                s, e = m.limits_gpt[i]
                rows.append((upper, s, e, m.kminor_start[i], self.gpoint_flavor[s][upper],
                             m.idx_minor[i], m.idx_minor_scaling[i],
                             int(m.scales_with_density[i]) | 2 * int(m.scale_by_complement[i])))
        i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
        tables = {n: getattr(self, n).contiguous()
                  for n in ("kmajor", "vmr_ref", "pfracin", "krayl") if getattr(self, n) is not None}
        return {"temp_ref": torch.tensor(self.temp_ref, dtype=self.kmajor.dtype, device=dev),
                "flavor": i32(self.flavor), "gflav": i32(self.gpoint_flavor),
                "minor": i32(rows).reshape(-1, 8),
                "kminor_lower": self.minor_lower.kminor.contiguous(),
                "kminor_upper": self.minor_upper.kminor.contiguous(), **tables}

    def to(self, device) -> "KDist":
        """The same k-distribution with its tables on ``device``."""
        moved = {n: getattr(self, n).to(device) for n in _TABLES if getattr(self, n) is not None}
        return dataclasses.replace(
            self, minor_lower=self.minor_lower.to(device), minor_upper=self.minor_upper.to(device),
            planck=None if self.planck is None else self.planck.to(device), **moved)

    def solar_source(self, mg_index: Optional[float] = None, sb_index: Optional[float] = None,
                     tsi: Optional[float] = None) -> torch.Tensor:
        """Spectral solar source (ngpt,) from the NRLSSI2 terms (reference
        set_solar_variability / set_tsi, mo_gas_optics_rrtmgp.F90:
        1058-1120): with no arguments the default facular and sunspot
        indices; with ``tsi`` rescaled to that total."""
        mg = self.mg_default if mg_index is None else mg_index
        sb = self.sb_default if sb_index is None else sb_index
        src = (self.solar_quiet + (mg - SOLAR_A_OFFSET) * self.solar_facular
               + (sb - SOLAR_B_OFFSET) * self.solar_sunspot)
        if tsi is not None:
            src = src * (tsi / src.sum())
        return src


def _reduce_minor(f: ncio.NCFile, suffix: str, gas_minor: list, identifier_minor: list,
                  reduced_gas_names: list) -> dict:
    """One atmosphere's minor-gas intervals pruned to the available gases,
    with the kminor table repacked (reference reduce_minor_arrays +
    create_idx_minor[_scaling]): MinorGasData's fields, kminor a float64
    array."""
    kminor = f.read(f"kminor_{suffix}", np.float64)  # (ntemp, neta, ncontrib)
    minor_gases = [normalize_gas_name(s) for s in f.read_strings(f"minor_gases_{suffix}")]
    limits = f.read(f"minor_limits_gpt_{suffix}").astype(int)  # (nminor, 2) 1-based
    swd = f.read(f"minor_scales_with_density_{suffix}").astype(bool).ravel()
    sbc = f.read(f"scale_by_complement_{suffix}").astype(bool).ravel()
    scaling_gas = [normalize_gas_name(s) for s in f.read_strings(f"scaling_gas_{suffix}")]
    kstart = f.read(f"kminor_start_{suffix}").astype(int).ravel()  # 1-based

    gas_minor_n = [normalize_gas_name(s) for s in gas_minor]
    ident_n = [normalize_gas_name(s) for s in identifier_minor]
    keep_rows = []
    out = {k: [] for k in _MINOR_META}
    pos = 0
    for i, mg in enumerate(minor_gases):
        base_gas = gas_minor_n[ident_n.index(mg)]
        ng = limits[i, 1] - limits[i, 0] + 1
        if base_gas not in reduced_gas_names:
            continue
        out["limits_gpt"].append((int(limits[i, 0] - 1), int(limits[i, 1])))
        out["scales_with_density"].append(bool(swd[i]))
        out["scale_by_complement"].append(bool(sbc[i]))
        # col_gas axis: 0 = dry, 1.. = the reduced gases
        out["idx_minor"].append(1 + reduced_gas_names.index(base_gas))
        sg = scaling_gas[i]
        out["idx_minor_scaling"].append(
            1 + reduced_gas_names.index(sg) if sg in reduced_gas_names else -1)
        out["kminor_start"].append(pos)
        keep_rows.extend(range(int(kstart[i] - 1), int(kstart[i] - 1 + ng)))
        pos += ng
    out = {k: tuple(v) for k, v in out.items()}
    out["kminor"] = kminor[:, :, keep_rows] if keep_rows else kminor[:, :, :0]
    return out


def read_kdist_arrays(path: str, available_gases) -> dict:
    """Read a k-distribution netCDF file on the host, keeping only the
    gases in ``available_gases`` (reference load_and_init +
    init_abs_coeffs): KDist's fields by name, the tables float64 numpy
    arrays, ``minor_lower`` / ``minor_upper`` dicts of MinorGasData's
    fields, ``totplnk`` (nPlanckTemp, nband) in place of ``planck``."""
    if isinstance(available_gases, GasConcs):
        available_gases = available_gases.gas_names
    avail = [normalize_gas_name(g) for g in available_gases]

    with ncio.NCFile(path) as f:
        gas_names_all = [normalize_gas_name(s) for s in f.read_strings("gas_names")]
        key_species = f.read("key_species").astype(int)  # (nbnd, 2, 2): [band, atm, pair]
        band_lims_wvn = f.read("bnd_limits_wavenumber", np.float64)
        band2gpt = f.read("bnd_limits_gpt").astype(int)  # (nbnd, 2) 1-based
        press_ref = f.read("press_ref", np.float64).ravel()
        temp_ref = f.read("temp_ref", np.float64).ravel()
        press_ref_trop = float(f.read("press_ref_trop"))
        vmr_ref = f.read("vmr_ref", np.float64)  # (ntemp, next, 2)
        gas_minor = f.read_strings("gas_minor")
        identifier_minor = f.read_strings("identifier_minor")

        # prune to the available gases, in the file's order
        reduced = [g for g in gas_names_all if g in avail]
        # vmr_ref: the file's axis 1 is [dry] + gases
        sel = [0] + [1 + gas_names_all.index(g) for g in reduced]
        out = dict(
            gas_names=tuple(reduced),
            press_ref_log=tuple(np.log(press_ref).tolist()),
            temp_ref=tuple(temp_ref.tolist()),
            press_ref_trop_log=float(np.log(press_ref_trop)),
            vmr_ref=np.transpose(vmr_ref, (2, 1, 0))[:, sel, :],
            kmajor=f.read("kmajor", np.float64),
            minor_lower=_reduce_minor(f, "lower", gas_minor, identifier_minor, reduced),
            minor_upper=_reduce_minor(f, "upper", gas_minor, identifier_minor, reduced),
        )

        # key species -> reduced indices first, then (0,0) -> (2,2): the
        # reference rewrites after create_key_species_reduce
        # (mo_gas_optics_rrtmgp.F90:1509-1514,1764-1771), so (2,2) means the
        # second gas of the reduced list, not of the file's
        nbnd = key_species.shape[0]
        ks_red = np.zeros((nbnd, 2, 2), dtype=int)
        for ib in range(nbnd):
            for ia in range(2):
                pair = []
                for v in key_species[ib, ia, :]:
                    if v == 0:
                        pair.append(0)
                        continue
                    g = gas_names_all[v - 1]
                    if g not in reduced:
                        raise ValueError(f"key species {g} not in available gases")
                    pair.append(1 + reduced.index(g))
                ks_red[ib, ia] = [2, 2] if pair == [0, 0] else pair
        # the flavor list: unique (ig1, ig2) pairs in order of first appearance
        flavor: list = []
        for ib in range(nbnd):
            for ia in range(2):
                pair = (int(ks_red[ib, ia, 0]), int(ks_red[ib, ia, 1]))
                if pair not in flavor:
                    flavor.append(pair)
        spectral = SpectralMapping.from_fortran_limits(band2gpt, band_lims_wvn)
        g2b = spectral.gpt2band
        out.update(
            spectral=spectral, flavor=tuple(flavor),
            gpoint_flavor=tuple(
                (flavor.index((int(ks_red[g2b[ig], 0, 0]), int(ks_red[g2b[ig], 0, 1]))),
                 flavor.index((int(ks_red[g2b[ig], 1, 0]), int(ks_red[g2b[ig], 1, 1]))))
                for ig in range(spectral.ngpt)))
        if f.has_var("rayl_lower"):
            out["krayl"] = np.stack([f.read("rayl_lower", np.float64),
                                     f.read("rayl_upper", np.float64)])
        if f.has_var("totplnk"):
            out["totplnk"] = f.read("totplnk", np.float64).T  # the file holds (nbnd, nT)
            out["pfracin"] = f.read("plank_fraction", np.float64)
            if f.has_var("optimal_angle_fit"):
                oaf = f.read("optimal_angle_fit", np.float64)  # (nbnd, nfit)
                out["optimal_angle_fit"] = tuple(map(tuple, oaf.tolist()))
        else:
            for name in ("quiet", "facular", "sunspot"):
                out[f"solar_{name}"] = f.read(f"solar_source_{name}", np.float64)
            for name in ("tsi_default", "mg_default", "sb_default"):
                out[name] = float(f.read(name))
    return out


def kdist_from_arrays(arrays: dict, device, dtype=torch.float32) -> KDist:
    """A KDist on ``device`` from host arrays laid out as
    ``read_kdist_arrays`` returns them (numpy or anything
    ``numpy.asarray`` takes): the way to hand a k-distribution over
    without a file."""
    # np.array copies: a read-only source array must not back a tensor
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)
    kw = dict(arrays)

    def minor(d):
        return MinorGasData(kminor=t(d["kminor"]), **{k: tuple(d[k]) for k in _MINOR_META})

    kw["minor_lower"], kw["minor_upper"] = minor(kw["minor_lower"]), minor(kw["minor_upper"])
    for name in _TABLES:
        if kw.get(name) is not None:
            kw[name] = t(kw[name])
    totplnk = kw.pop("totplnk", None)
    if totplnk is not None:
        temp_ref = kw["temp_ref"]
        kw["planck"] = PlanckTable.from_table(
            t(totplnk), float(temp_ref[0]),
            (float(temp_ref[-1]) - float(temp_ref[0])) / (np.shape(totplnk)[0] - 1))
    return KDist(**kw)


def load_kdist(path: str, available_gases, dtype=torch.float32, *, device) -> KDist:
    """Load a k-distribution netCDF file onto ``device``, keeping only the
    gases in ``available_gases`` (a list of names or a GasConcs)."""
    return kdist_from_arrays(read_kdist_arrays(path, available_gases), device, dtype)
