#!/usr/bin/env python
"""Run the clear-sky regression harness on the PyTorch port and print the
verification table.

The counterpart of scripts/run_regression.py, with the same flags, table
and exit status (the reference's regression flow,
tests/clear_sky_regression.F90 driven by tests/verification.py): every LW
and SW solver variant over one atmosphere with the LUT gas-optics path on
``--device`` (on CUDA each broadband LW solve of absorption optical depths
without the Jacobian is one launch of K7), cross-checked (vertical
reversal, subset, increment identities, TSI scaling) and written as named
broadband fields.

It runs in float32, as the JAX script does run as a script (64-bit mode
off), and as the kernels on CUDA take it. The reference's k-distribution
files are not shipped; by default a reference-format synthetic
k-distribution (gasoptics/synthetic.py) exercises the identical code path.
Pass --kdist-lw/--kdist-sw to use real files.

Usage:
    python scripts/torch_run_regression.py [--ncol 8] [--output test_atmospheres.nc]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from rte_rrtmgp_nn_tpu_torch.drivers.clear_sky_regression import (
    run_lw_variants,
    run_sw_variants,
    verify_variants,
    write_fields,
)
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.testing import REGRESSION_GASES, make_atmosphere
from rte_rrtmgp_nn_tpu_torch.utils import cli


# the harness's surface and sun (the JAX script's)
SFC_EMIS, MU0, SFC_ALB = 0.97, 0.7, 0.12


def load_kdists(kdist_lw, kdist_sw, dtype=torch.float32, *, device) -> tuple:
    """The LW and SW k-distributions on ``device``: each band its real file
    when given, the synthetic one (16 x 4 LW, 14 x 4 SW g-points) otherwise
    -- a single supplied file must be USED, not silently dropped."""
    gases = list(REGRESSION_GASES)
    kds = []
    with tempfile.TemporaryDirectory() as d:
        for band, path, nband in (("LW", kdist_lw, 16), ("SW", kdist_sw, 14)):
            if path:
                print(f"{band} k-distribution: {path}")
            else:
                path = os.path.join(d, f"{band.lower()}.nc")
                generate_kdist_nc(path, kind=band.lower(), gpts_per_band=4, nband=nband)
                print(f"{band} k-distribution: synthetic (gasoptics/synthetic.py)")
            kds.append(load_kdist(path, gases, dtype, device=device))
    return tuple(kds)


def regression_fields(kd_lw, kd_sw, ncol: int, nlay: int, dtype=torch.float32, *,
                      device) -> dict:
    """Every LW and SW variant of the harness over make_atmosphere(ncol,
    nlay) in ``dtype`` on ``device``: {field name: (ncol, nlev) numpy}."""
    npt = torch.empty((), dtype=dtype).numpy().dtype
    play, plev, tlay, tlev, tsfc, vmr = (
        a.astype(npt) if isinstance(a, np.ndarray) else a
        for a in make_atmosphere(ncol=ncol, nlay=nlay))
    gc = GasConcs.create({g: np.asarray(v, npt) for g, v in vmr.items()})
    t = lambda a: torch.from_numpy(a)
    emis = np.full((ncol, kd_lw.nband), SFC_EMIS, npt)
    fields = run_lw_variants(kd_lw, *map(t, (play, plev, tlay, tlev, tsfc)), gc, t(emis),
                             device=device)
    mu0 = np.full((ncol,), MU0, npt)
    alb = np.full((ncol, kd_sw.nband), SFC_ALB, npt)
    fields.update(run_sw_variants(kd_sw, *map(t, (play, plev, tlay)), gc, t(mu0), t(alb),
                                  device=device))
    return fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=8)
    ap.add_argument("--nlay", type=int, default=20)
    ap.add_argument("--kdist-lw", default=None, help="real LW k-distribution netCDF")
    ap.add_argument("--kdist-sw", default=None, help="real SW k-distribution netCDF")
    ap.add_argument("--output", default="test_atmospheres.nc")
    ap.add_argument("--fail-tol", type=float, default=1e-5)
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)
    kd_lw, kd_sw = load_kdists(args.kdist_lw, args.kdist_sw, device=dev)
    fields = regression_fields(kd_lw, kd_sw, args.ncol, args.nlay, device=dev)

    # per-check thresholds: identity checks at fail_tol; different-input
    # checks (interpolated tlev, linearized Jacobian) at their physical
    # agreement levels (mirrors verify_variants, which raises on a failure)
    loose = {"lw_notlev": 0.05, "lw_jacobian": 5e-3}
    try:
        checks = verify_variants(fields, fail_tol=args.fail_tol)
    except AssertionError as e:
        print(f"FAILED checks: {e}")
        return 1
    print(f"{len(fields)} fields, {args.ncol} cols x {args.nlay} layers")
    print("--------")
    failed = []
    for name, v in sorted(checks.items()):
        tol = loose.get(name, args.fail_tol)
        status = "ok" if v < tol else "FAIL"
        if status == "FAIL":
            failed.append(name)
        print(f"  {name:12s} max rel diff {v:12.3e}  (tol {tol:.0e})  {status}")
    print("--------")

    write_fields(args.output, fields)
    print(f"wrote {len(fields)} broadband fields to {args.output}")
    if failed:
        print(f"FAILED checks: {failed}")
        return 1
    print("all verification checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
