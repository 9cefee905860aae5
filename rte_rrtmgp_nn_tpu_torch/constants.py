"""Physical constants (2018 SI redefinition values).

Port of rte_rrtmgp_nn_tpu/constants.py (reference
rrtmgp/mo_rrtmgp_constants.F90:30-64).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class PhysicalConstants:
    # Boltzmann constant [J/K]
    k_boltz: float = 1.380649e-23
    # Molar mass of water [kg/mol]
    m_h2o: float = 0.018016
    # Avogadro's number [molec/mol]
    avogad: float = 6.02214076e23
    # Molar mass of dry air [kg/mol]
    m_dry: float = 0.028964
    # Gravity at earth's surface [m/s2]
    grav: float = 9.80665
    # Specific heat at constant pressure for dry air [J/(K kg)]
    cp_dry: float = 1004.64
    # Stefan-Boltzmann constant [W/m2/K4]
    sigma_sb: float = 5.670374419e-8
    # Planck constant [J s] and speed of light [m/s] (Planck-band integrals)
    h_planck: float = 6.62607015e-34
    c_light: float = 2.99792458e8

    # Helmert gravity formula terms (reference mo_gas_optics_rrtmgp.F90:1673-1675)
    helmert1: float = 9.80665
    helmert2: float = 0.02586


constants = PhysicalConstants()


def init_constants(**kwargs) -> None:
    """Override constants (e.g. for other planets)."""
    for k, v in kwargs.items():
        if not hasattr(constants, k):
            raise ValueError(f"unknown constant {k!r}")
        setattr(constants, k, v)


PI = math.pi
