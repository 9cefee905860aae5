#!/usr/bin/env python
"""Run the all-sky (gases + clouds) example on the PyTorch port and write a
flux netCDF.

The counterpart of scripts/run_allsky.py, with the same flags, model files,
summary lines and output variables: the Garand atmosphere replicated to
--ncol columns with idealized clouds through ``allsky_lw`` / ``allsky_sw``
on ``--device`` (on CUDA with lookup-table coefficients: one launch of K1
and one of K2 in their ``cld_lut`` mode each loop), then
{lw,sw}_flux_{up,dn}(col, lev) and the reference's summary means.
--nloops repeats the solve (the reference's timing knob). Where the JAX
script defaults to the reference checkout's files, the flags are required
(utils/cli.py).

Usage:
    python scripts/torch_run_allsky.py --input FILE --lw-cloud-coeffs FILE
        --sw-cloud-coeffs FILE --models-dir DIR [--ncol 128] [--nloops 1] [--output FILE]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from rte_rrtmgp_nn_tpu_torch.drivers.allsky import allsky_lw, allsky_sw
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.utils import cli
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_reference_argument(ap, "--input", cli.GARAND_IN_REFERENCE)
    cli.add_reference_argument(ap, "--lw-cloud-coeffs", cli.CLOUD_COEFFS_IN_REFERENCE.format("lw"))
    cli.add_reference_argument(ap, "--sw-cloud-coeffs", cli.CLOUD_COEFFS_IN_REFERENCE.format("sw"))
    cli.add_reference_argument(ap, "--models-dir", cli.MODELS_DIR_IN_REFERENCE, "directory")
    ap.add_argument("--ncol", type=int, default=128)
    ap.add_argument("--nloops", type=int, default=1)
    ap.add_argument("--output", default="rrtmgp-allsky-fluxes.nc")
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)

    lw_models = [load_model_netcdf(os.path.join(args.models_dir, cli.LW_MODEL_FILE), device=dev)]
    sw_models = [load_model_netcdf(os.path.join(args.models_dir, f), device=dev)
                 for f in cli.SW_MODEL_FILES]

    for loop in range(args.nloops):
        t0 = time.perf_counter()
        flw = allsky_lw(args.input, args.lw_cloud_coeffs, lw_models, ncol=args.ncol, device=dev)
        fsw = allsky_sw(args.input, args.sw_cloud_coeffs, sw_models, ncol=args.ncol, device=dev)
        lw_up, lw_dn = flw.flux_up.cpu().numpy(), flw.flux_dn.cpu().numpy()
        sw_up, sw_dn = fsw.flux_up.cpu().numpy(), fsw.flux_dn.cpu().numpy()
        dt = time.perf_counter() - t0
        if loop == 0:
            print(f"ncol = {args.ncol}: LW+SW in {dt:.2f}s (loop {loop + 1})")

    # summary means in the reference driver's format (rrtmgp_allsky.F90:479-489)
    print(f"mean LW flux dn: {lw_dn.mean():10.4f} up: {lw_up.mean():10.4f}")
    print(f"mean SW flux dn: {sw_dn.mean():10.4f} up: {sw_up.mean():10.4f}")

    nlev = lw_up.shape[1]
    write_nc(
        args.output,
        dims={"col": args.ncol, "lev": nlev},
        variables={
            "lw_flux_up": (("col", "lev"), lw_up),
            "lw_flux_dn": (("col", "lev"), lw_dn),
            "sw_flux_up": (("col", "lev"), sw_up),
            "sw_flux_dn": (("col", "lev"), sw_dn),
        },
    )
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
