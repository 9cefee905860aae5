"""Garand-atmosphere I/O for the all-sky example.

Port of rte_rrtmgp_nn_tpu/drivers/allsky_io.py (reference
examples/all-sky/mo_garand_atmos_io.F90): read the file's profiles and
replicate them column-cyclically to ncol columns. Host-side numpy; the
drivers move the arrays to their device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..gas_concs import GasConcs
from ..utils import ncio

GARAND_GASES = ["h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2"]


@dataclasses.dataclass
class GarandAtmosphere:
    play: np.ndarray  # (ncol, nlay)
    plev: np.ndarray  # (ncol, nlay+1)
    tlay: np.ndarray  # (ncol, nlay)
    tlev: np.ndarray  # (ncol, nlay+1)
    gas_concs: GasConcs

    @property
    def ncol(self):
        return self.play.shape[0]

    @property
    def nlay(self):
        return self.play.shape[1]


def read_garand(path: str, ncol: int, dtype=np.float32) -> GarandAtmosphere:
    """Read a Garand atmosphere file (variables stored (nlay, ncol_file))
    and tile the file's columns cyclically up to ncol."""
    with ncio.NCFile(path) as f:
        play = f.read("p_lay", dtype)
        plev = f.read("p_lev", dtype)
        tlay = f.read("t_lay", dtype)
        tlev = f.read("t_lev", dtype)
        concs = {}
        for g in GARAND_GASES:
            name = f"vmr_{g}"
            if f.has_var(name):
                concs[g] = f.read(name, dtype)

    def rep(a):
        # (nlay, nfile) -> (ncol, nlay), cycling the file's columns
        a = a.T
        reps = int(np.ceil(ncol / a.shape[0]))
        return np.tile(a, (reps, 1))[:ncol]

    return GarandAtmosphere(
        play=rep(play), plev=rep(plev), tlay=rep(tlay), tlev=rep(tlev),
        gas_concs=GasConcs.create({k: rep(v) for k, v in concs.items()}),
    )
