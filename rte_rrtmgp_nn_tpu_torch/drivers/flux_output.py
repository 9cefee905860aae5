"""Flux output writing and golden-file comparison.

Port of rte_rrtmgp_nn_tpu/drivers/flux_output.py (reference mo_rfmip_io.F90
``unblock_and_write`` :703-871, the rlu/rld/rsu/rsd variables in the RFMIP
layout; the CI comparators examples/rfmip-clear-sky/_compare-to-reference.py
and examples/all-sky/compare-to-reference.py, :25-60). Host-side numpy;
fluxes given as tensors are copied to the host.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ..utils import ncio


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def write_fluxes_rfmip(
    path: str,
    fluxes: Mapping[str, object],
    plev,
    nexp: int,
    nsites: int,
) -> None:
    """Write flux fields in the RFMIP output layout (expt, site, level).

    fluxes: name (e.g. 'rlu', 'rld', 'rsu', 'rsd', 'rsdcs') -> (ncol =
    nexp*nsites, nlev) array or tensor; plev: (ncol, nlev) or (nlev,)."""
    plev = _host(plev)
    nlev = plev.shape[-1]
    dims = {"expt": nexp, "site": nsites, "level": nlev}
    variables = {
        name: (("expt", "site", "level"),
               np.asarray(_host(v), np.float32).reshape(nexp, nsites, nlev))
        for name, v in fluxes.items()
    }
    variables["pres_level"] = (
        ("expt", "site", "level"),
        np.asarray(plev, np.float64).reshape(nexp, nsites, nlev)
        if plev.ndim > 1 and plev.shape[0] == nexp * nsites
        else np.broadcast_to(np.asarray(plev, np.float64), (nexp, nsites, nlev)).copy(),
    )
    ncio.write_nc(path, dims, variables)


def compare_flux_files(
    candidate_path: str,
    reference_path: str,
    variables: Optional[list[str]] = None,
    fail_threshold: float = 1.0e-5,
    report_threshold: float = 1.0e-10,
    verbose: bool = True,
) -> dict:
    """Golden-file comparison: max |candidate - reference| per variable.

    Returns {'passed': bool, 'max_diffs': {var: float}}; the thresholds
    follow the reference CI (report 1e-10; fail 7e-4 W/m2 for RFMIP, 1e-5
    for all-sky). A comparison of no common variable fails."""
    with ncio.NCFile(candidate_path) as fc, ncio.NCFile(reference_path) as fr:
        names = variables or [v for v in fc.variables() if fr.has_var(v)]
        max_diffs = {}
        for v in names:
            if not (fc.has_var(v) and fr.has_var(v)):
                continue
            a = np.asarray(fc.read(v), np.float64)
            b = np.asarray(fr.read(v), np.float64)
            if a.shape != b.shape:
                max_diffs[v] = float("inf")
                continue
            d = float(np.nanmax(np.abs(a - b))) if a.size else 0.0
            max_diffs[v] = d
            if verbose and d > report_threshold:
                print(f"{v}: max abs diff {d:.3e}")
    passed = bool(max_diffs) and all(d <= fail_threshold for d in max_diffs.values())
    if verbose and not max_diffs:
        print("FAILED: no common variables to compare")
    if verbose and not passed:
        bad = {k: v for k, v in max_diffs.items() if v > fail_threshold}
        print(f"FAILED variables (> {fail_threshold:g}): {bad}")
    return {"passed": passed, "max_diffs": max_diffs}
