"""RFMIP clear-sky input reading.

Port of rte_rrtmgp_nn_tpu/drivers/rfmip_io.py (reference
examples/rfmip-clear-sky/mo_rfmip_io.F90: read_size, read_and_block_pt,
read_and_block_gases_ty with the per-variable units scale factor,
read_and_block_lw_bc / _sw_bc). Arrays come out (ncol, nlay[+1]) numpy with
ncol = nexp * nsites (experiment-major); gases are host tensors in a
GasConcs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..gas_concs import GasConcs
from ..utils import ncio

# chemical formula -> RFMIP file variable name (reference chem_name/conc_name)
CHEM_TO_FILE = {
    "co": "carbon_monoxide",
    "ch4": "methane",
    "o2": "oxygen",
    "n2o": "nitrous_oxide",
    "n2": "nitrogen",
    "co2": "carbon_dioxide",
    "ccl4": "carbon_tetrachloride",
    "ch3br": "methyl_bromide",
    "ch3cl": "methyl_chloride",
    "cfc22": "hcfc22",
    "h2o": "water_vapor",
    "o3": "ozone",
}

# The 16 gases the g-128 LW NN models take besides tlay and play.
NN_LW_GASES = [
    "h2o", "o3", "co2", "ch4", "n2o", "cfc11", "cfc12", "co", "ccl4",
    "cfc22", "hfc143a", "hfc125", "hfc23", "hfc32", "hfc134a", "cf4",
]


@dataclasses.dataclass
class RFMIPData:
    """All-experiment flattened RFMIP problem, (ncol = nexp*nsites, ...)."""

    play: np.ndarray  # (ncol, nlay) [Pa]
    plev: np.ndarray  # (ncol, nlay+1)
    tlay: np.ndarray  # (ncol, nlay) [K]
    tlev: np.ndarray  # (ncol, nlay+1)
    tsfc: np.ndarray  # (ncol,)
    sfc_emis: np.ndarray  # (ncol,)
    sfc_alb: np.ndarray  # (ncol,)
    sza: np.ndarray  # (ncol,) solar zenith angle [deg]
    tsi: np.ndarray  # (ncol,) total solar irradiance [W/m2]
    gas_concs: GasConcs
    nexp: int
    nsites: int
    nlay: int
    top_at_1: bool

    @property
    def ncol(self) -> int:
        return self.nexp * self.nsites


def rfmip_data_from_arrays(arrays: dict) -> RFMIPData:
    """RFMIPData of one experiment from a dict of (ncol, nlay[+1]) arrays:
    play, plev, tlay, tlev, tsfc, sfc_emis, sfc_alb, sza, tsi, ``gases``
    (name -> VMR) and ``top_at_1`` (the layout of testing.synthesize_rfmip)."""
    ncol, nlay = np.shape(arrays["play"])
    return RFMIPData(
        play=arrays["play"], plev=arrays["plev"], tlay=arrays["tlay"],
        tlev=arrays["tlev"], tsfc=arrays["tsfc"], sfc_emis=arrays["sfc_emis"],
        sfc_alb=arrays["sfc_alb"], sza=arrays["sza"], tsi=arrays["tsi"],
        gas_concs=GasConcs.create(arrays["gases"]), nexp=1, nsites=ncol,
        nlay=nlay, top_at_1=bool(arrays["top_at_1"]))


def _units_scale(f: ncio.NCFile, var: str) -> float:
    """RFMIP gas variables carry a multiplicative units attribute (e.g.
    '1.e-6'); reference read_and_block_gases_ty."""
    u = f.attr(var, "units", b"1")
    if isinstance(u, bytes):
        u = u.decode()
    try:
        return float(u)
    except ValueError:
        return 1.0


def read_rfmip(path: str, gases: list[str] | None = None, dtype=np.float32) -> RFMIPData:
    """Read the RFMIP file, flattening (exp, site) -> columns.

    gases: kdist-style names to load (default: the NN LW gas set). Gases
    missing from the file are skipped; the NN input packing substitutes
    zero or scenario values for them."""
    gases = gases if gases is not None else NN_LW_GASES
    with ncio.NCFile(path) as f:
        nexp = f.read("temp_layer").shape[0]
        nsites, nlay = f.read("pres_layer").shape
        ncol = nexp * nsites

        play = np.broadcast_to(f.read("pres_layer", dtype), (nexp, nsites, nlay)).reshape(ncol, nlay)
        plev = np.broadcast_to(f.read("pres_level", dtype), (nexp, nsites, nlay + 1)).reshape(ncol, nlay + 1)
        tlay = f.read("temp_layer", dtype).reshape(ncol, nlay)
        tlev = f.read("temp_level", dtype).reshape(ncol, nlay + 1)
        tsfc = f.read("surface_temperature", dtype).reshape(ncol)
        sfc_emis = np.broadcast_to(f.read("surface_emissivity", dtype), (nexp, nsites)).reshape(ncol)
        sfc_alb = np.broadcast_to(f.read("surface_albedo", dtype), (nexp, nsites)).reshape(ncol)
        sza = np.broadcast_to(f.read("solar_zenith_angle", dtype), (nexp, nsites)).reshape(ncol)
        tsi = np.broadcast_to(f.read("total_solar_irradiance", dtype), (nexp, nsites)).reshape(ncol)

        concs = {}
        for g in gases:
            fvar = CHEM_TO_FILE.get(g, g)
            if f.has_var(fvar):
                # full (exp, site, lay) field, e.g. water_vapor, ozone
                v = f.read(fvar, np.float64) * _units_scale(f, fvar)
                concs[g] = v.reshape(ncol, nlay).astype(dtype)
            elif f.has_var(fvar + "_GM"):
                # global mean per experiment -> per column, constant in height
                v = f.read(fvar + "_GM", np.float64) * _units_scale(f, fvar + "_GM")
                concs[g] = np.repeat(v, nsites).astype(dtype)[:, None] * np.ones(
                    (1, nlay), dtype)

    top_at_1 = bool(play[0, 0] < play[0, -1])
    return RFMIPData(
        play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc,
        sfc_emis=sfc_emis, sfc_alb=sfc_alb, sza=sza, tsi=tsi,
        gas_concs=GasConcs.create(concs), nexp=nexp, nsites=nsites, nlay=nlay,
        top_at_1=top_at_1,
    )
