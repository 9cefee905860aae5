"""The yardstick's arithmetic for the lookup-table (LUT) gas optics: the
operations and bytes of one LW or SW call of the RFMIP drivers' LUT route,
from the shapes, the k-distribution file and the input state alone.

Operations, floating point only (index arithmetic is not counted), as the
port's plain twin (``ops/gas_optics_lut.py``) states them:
  - per (column, layer, g-point): the major absorbers' trilinear
    interpolation, 8 corners of 3 weight products, the product with the
    table's value and the sum, plus 4 complements 1 - f (MAJOR 44); the
    Planck fraction, the same unscaled (PFRAC 36); Rayleigh, 4 corners of
    the weight product, the product and the sum, 2 complements, the moist
    column's product (RAYLEIGH 15); the SW combination, tau's sum, the test
    and the divide of ssa (COMBINE 3); the LW sources, the fraction times
    the band radiance (PLANCK 1, also per level and at the surface);
  - per g-point of a minor interval, in the layers of its atmosphere: 4
    corners of the product and the sum, the scaling's product and the sum
    into tau (MINOR 10);
  - per (column, layer): the temperature and pressure indices and weights
    (ROW 13), and per flavor both temperature nodes' mixing column and eta
    (FLAVOR 14).
The transport: ``counts.ELEMENT_FLOPS`` per (column, layer, g-point).
Bytes: every table, input and output once, float32.
"""
from __future__ import annotations

import numpy as np

from radbench.counts import ELEMENT_FLOPS

MAJOR, PFRAC, RAYLEIGH, COMBINE, PLANCK, MINOR, ROW, FLAVOR = 44, 36, 15, 3, 1, 10, 13, 14


def minor_elements(kd, upper_rows: int, lower_rows: int) -> int:
    """g-point elements that minor intervals add to, over ``lower_rows``
    (column, layer) rows in the lower atmosphere and ``upper_rows`` in the
    upper; ``kd`` a ``reference.lut.KDistFile``."""
    width = [sum(e - s for s, e in m.gpts) for m in kd.minor]
    return lower_rows * width[0] + upper_rows * width[1]


def nflavors(kd) -> int:
    """Distinct (key species pair) flavors of the file's bands and atmospheres."""
    return len({tuple(p) for p in kd.key.reshape(-1, 2).tolist()})


def _tables(kd) -> int:
    """Floats of the tables the gas optics reads."""
    n = kd.kmajor.size + kd.vmr_ref.size + sum(m.kminor.size for m in kd.minor)
    for t in (kd.pfrac, kd.totplnk, kd.krayl):
        n += 0 if t is None else t.size
    return n + (3 * kd.ngpt if kd.solar is not None else 0)


def lw_gas_work(kd, ncol: int, nlay: int, upper_rows: int) -> tuple:
    """(operations, bytes) of the LW gas optics and Planck sources of
    ``ncol`` columns, ``upper_rows`` of whose layers lie above the
    tropopause."""
    rows, ngpt, ngas = ncol * nlay, kd.ngpt, len(kd.gases)
    flops = (rows * ngpt * (MAJOR + PFRAC + PLANCK) + ncol * (nlay + 1) * ngpt * PLANCK
             + 3 * ncol * ngpt * PLANCK
             + MINOR * minor_elements(kd, upper_rows, rows - upper_rows)
             + rows * (ROW + FLAVOR * nflavors(kd)))
    # play, tlay, the gases' VMRs; plev, tlev; tsfc | tau, the layer
    # source; the level source; the surface source and its derivative
    floats = (rows * (2 + ngas) + 2 * ncol * (nlay + 1) + ncol + _tables(kd)
              + 2 * rows * ngpt + ncol * (nlay + 1) * ngpt + 2 * ncol * ngpt)
    return float(flops), 4.0 * floats


def sw_gas_work(kd, ncol: int, nlay: int, upper_rows: int) -> tuple:
    """(operations, bytes) of the SW gas optics of ``ncol`` columns:
    absorption, Rayleigh, tau and ssa."""
    rows, ngpt, ngas = ncol * nlay, kd.ngpt, len(kd.gases)
    flops = (rows * ngpt * (MAJOR + RAYLEIGH + COMBINE)
             + MINOR * minor_elements(kd, upper_rows, rows - upper_rows)
             + rows * (ROW + FLAVOR * nflavors(kd)))
    # play, tlay, the gases' VMRs; plev | tau, ssa
    floats = rows * (2 + ngas) + ncol * (nlay + 1) + _tables(kd) + 2 * rows * ngpt
    return float(flops), 4.0 * floats


def lw_rte_work(ngpt: int, nband: int, ncol: int, nlay: int) -> tuple:
    """(operations, bytes) of the LW transport at one angle: tau, the layer,
    level and surface sources and the band emissivity in, broadband up and
    down out."""
    rows = ncol * nlay
    floats = (2 * rows * ngpt + ncol * (nlay + 1) * ngpt + ncol * ngpt + ncol * nband
              + 2 * ncol * (nlay + 1))
    return float(ELEMENT_FLOPS["lw"] * rows * ngpt), 4.0 * floats


def sw_rte_work(ngpt: int, ncol: int, nlay: int) -> tuple:
    """(operations, bytes) of the SW two-stream + adding: tau, ssa, g, mu0,
    the TOA flux and both albedos in, broadband up, down and direct out."""
    rows = ncol * nlay
    floats = 3 * rows * ngpt + ncol + 3 * ncol * ngpt + 3 * ncol * (nlay + 1)
    return float(ELEMENT_FLOPS["sw"] * rows * ngpt), 4.0 * floats


def upper_rows(kd, play: np.ndarray) -> int:
    """(column, layer) rows above the tropopause, as float32 decides it."""
    log_p = np.log(np.asarray(play, np.float32))
    return int(np.count_nonzero(log_p <= np.float32(kd.log_p_trop)))
