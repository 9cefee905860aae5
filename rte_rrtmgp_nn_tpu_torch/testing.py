"""Synthetic RFMIP-like inputs for the tests and the chip smoke run.

Numpy only: this is input synthesis, not physics. One seeded dict of
arrays can feed both the JAX package's and this package's ``RFMIPData``,
so the two are compared on identical inputs.
"""
from __future__ import annotations

import numpy as np


def synthesize_rfmip(ncol: int, nlay: int, seed: int, top_at_1: bool = True) -> dict:
    """A clear-sky RFMIP-like problem of ``ncol`` columns and ``nlay``
    layers, from ``seed``.

    Returns a dict of float32 numpy arrays: play/tlay (ncol, nlay),
    plev/tlev (ncol, nlay+1), tsfc/sfc_emis/sfc_alb/sza/tsi (ncol,), and
    ``gases``: h2o and o3 2-D; co2 2-D but constant in height; ch4 and n2o
    per-layer 1-D profiles, constant; cfc11 and cfc12 scalars. The other
    gases of the g-128 LW model are absent (they take the missing-gas
    path). sza spans 0-120 deg, so about a quarter of the columns are night.
    ``top_at_1`` selects the vertical orientation (True: index 0 is the top
    of the atmosphere). Also holds ``top_at_1``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    psfc = rng.uniform(95000.0, 103000.0, ncol)
    frac = np.exp(np.linspace(np.log(1.0e-4), 0.0, nlay + 1))  # of psfc, top to surface
    plev = psfc[:, None] * frac[None, :]
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    sigma = play / psfc[:, None]
    # stratosphere ~215 K over a troposphere warming towards the surface
    t_sfc_air = rng.uniform(260.0, 305.0, ncol)
    tlay = np.maximum(215.0, t_sfc_air[:, None] * sigma ** 0.19)
    tlay = tlay + rng.uniform(-2.0, 2.0, (ncol, nlay))
    tlev = np.concatenate(
        [tlay[:, :1] - 1.0, 0.5 * (tlay[:, 1:] + tlay[:, :-1]), t_sfc_air[:, None]], axis=1)
    tsfc = t_sfc_air + rng.uniform(-2.0, 5.0, ncol)

    h2o = (1.0e-2 * rng.uniform(0.2, 1.0, ncol)[:, None] * sigma ** 3.0
           * rng.uniform(0.8, 1.2, (ncol, nlay)) + 2.0e-6)
    o3 = 8.0e-6 * np.exp(-((np.log(sigma) - np.log(0.01)) / 1.5) ** 2) + 2.0e-8
    o3 = o3 * rng.uniform(0.8, 1.2, (ncol, nlay))
    co2 = rng.uniform(2.8e-4, 8.0e-4, ncol)[:, None] * np.ones((1, nlay))
    ch4 = np.full(nlay, rng.uniform(8.0e-7, 2.5e-6))
    n2o = np.full(nlay, rng.uniform(2.7e-7, 3.9e-7))
    gases = {
        "h2o": h2o, "o3": o3, "co2": co2, "ch4": ch4, "n2o": n2o,
        "cfc11": np.asarray(2.3e-10), "cfc12": np.asarray(5.2e-10),
    }

    out = {
        "play": play, "plev": plev, "tlay": tlay, "tlev": tlev, "tsfc": tsfc,
        "sfc_emis": rng.uniform(0.9, 1.0, ncol),
        "sfc_alb": rng.uniform(0.05, 0.3, ncol),
        "sza": rng.uniform(0.0, 120.0, ncol),
        "tsi": rng.uniform(1355.0, 1365.0, ncol),
    }
    if not top_at_1:
        for k in ("play", "plev", "tlay", "tlev"):
            out[k] = out[k][:, ::-1]
        gases = {k: (v[..., ::-1] if np.ndim(v) else v) for k, v in gases.items()}
    out = {k: np.ascontiguousarray(v, dtype=f32) for k, v in out.items()}
    out["gases"] = {k: np.array(v, dtype=f32) for k, v in gases.items()}
    out["top_at_1"] = bool(top_at_1)
    return out
