"""The yardstick's arithmetic: the operations and bytes a radiation call
needs, from its shapes and nets alone, and the card's peaks. Whatever
implements the call, a roofline or an MFU reads the same work.

Counts (frozen from the port's smoke run, ``chip_smoke.py``):
  - an MLP: 2 * rows * sum(n_in * n_out) over its layers;
  - per (layer, g-point) after the nets, counted from the fused kernels'
    sources: LW 40 (transmittance, source, both sweeps), SW 110 (two-stream
    coefficients, direct beam, both adding sweeps);
  - clouds, only on the cells that hold cloud: per (cell, band) a phase's
    lookup (LW 14, SW 18 a phase present) and the combination (LW 3, SW 9);
    per (cell, g-point) the increment (LW 1, SW 16).
Bytes: every input read once and every output written once, float32.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (TF32 and
# bf16 are outside the configurations' accuracy), and the HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ELEMENT_FLOPS = {"lw": 40, "sw": 110}
CLOUD_FLOPS = {"lw": {"lut_phase": 14, "lut_band": 3, "gpt": 1},
               "sw": {"lut_phase": 18, "lut_band": 9, "gpt": 16}}
PLANCK_TEMPS = 196  # rows of the Planck table (160-355 K)


def mlp_flops(dims, rows: int) -> float:
    """2 * multiply-adds of the net's matrix products over ``rows`` rows."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def net_floats(dims) -> int:
    """Weights, biases and the output mean and std of a net."""
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + 2 * dims[-1]


def cloud_flops(kind: str, n_liq: int, n_ice: int, n_any: int, nband: int, ngpt: int) -> float:
    """Operations the clouds add: n_liq / n_ice / n_any cells hold liquid,
    ice, either."""
    c = CLOUD_FLOPS[kind]
    return float(c["gpt"] * ngpt * n_any
                 + (c["lut_phase"] * (n_liq + n_ice) + c["lut_band"] * n_any) * nband)


def lw_work(ncol: int, nlay: int, dims, nband: int, clouds=None) -> tuple:
    """(operations, bytes) of the LW radiation of ``ncol`` columns: one
    "both" net of ``dims`` (2 x ngpt outputs), the Planck sources and the
    transport; ``clouds`` = (n_liq, n_ice, n_any) cells or None."""
    ngpt = dims[-1] // 2
    cells = ncol * nlay
    flops = mlp_flops(dims, cells) + ELEMENT_FLOPS["lw"] * cells * ngpt
    floats = (cells * (dims[0] + 2) + ncol * (nlay + 1) + ncol * (1 + ngpt)
              + net_floats(dims) + PLANCK_TEMPS * nband + 2 * ncol * (nlay + 1))
    if clouds is not None:
        flops += cloud_flops("lw", *clouds, nband, ngpt)
        floats += 4 * cells
    return flops, 4.0 * floats


def sw_work(ncol: int, nlay: int, dims_abs, dims_ray, nband: int, clouds=None) -> tuple:
    """(operations, bytes) of the SW radiation of ``ncol`` columns: the
    absorption and Rayleigh nets, the two-stream coefficients, the direct
    beam and the adding sweeps; ``clouds`` as lw_work."""
    ngpt = dims_abs[-1]
    cells = ncol * nlay
    flops = (mlp_flops(dims_abs, cells) + mlp_flops(dims_ray, cells)
             + ELEMENT_FLOPS["sw"] * cells * ngpt)
    floats = (cells * (dims_abs[0] + 1) + ncol * (1 + 4 * ngpt)
              + net_floats(dims_abs) + net_floats(dims_ray) + 3 * ncol * (nlay + 1))
    if clouds is not None:
        flops += cloud_flops("sw", *clouds, nband, ngpt)
        floats += 4 * cells
    return flops, 4.0 * floats


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the operations at the float32
    peak or the bytes at the memory peak, whichever is longer."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
