#!/usr/bin/env python
"""Run the RFMIP clear-sky LW + SW examples on the PyTorch port and write
RFMIP-layout flux files.

The counterpart of scripts/run_rfmip.py, with the same flags, model files
and printed lines: ``read_rfmip``, then ``rfmip_clear_sky_lw`` /
``rfmip_clear_sky_sw`` on ``--device`` (on CUDA the fused kernels, one
launch of K1 and one of K2; with ``--n-gauss-angles`` above 1 the staged
LW route, K3 and K7), then r{l,s}{u,d}_<tag>.nc in --output-dir with
(expt, site, level) layout (drivers/flux_output.write_fluxes_rfmip).
Where the JAX script defaults to the reference checkout's files, the
flags are required (utils/cli.py).

Usage:
    python scripts/torch_run_rfmip.py --input FILE --models-dir DIR
        [--output-dir DIR] [--what lw,sw] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from rte_rrtmgp_nn_tpu_torch.drivers.flux_output import write_fluxes_rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.utils import cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_reference_argument(ap, "--input", cli.RFMIP_INPUT_IN_REFERENCE)
    cli.add_reference_argument(ap, "--models-dir", cli.MODELS_DIR_IN_REFERENCE, "directory")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--what", default="lw,sw", help="comma list: lw, sw")
    ap.add_argument("--tag", default="Efx_RTE-RRTMGP-NN-TPU-181204_rad-irf_r1i1p1f1_gn",
                    help="output filename tag (RFMIP convention)")
    ap.add_argument("--n-gauss-angles", type=int, default=1)
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)

    what = [w.strip() for w in args.what.split(",") if w.strip()]
    unknown = set(what) - {"lw", "sw"}
    if unknown or not what:
        ap.error(f"--what must be a comma list of lw, sw (got {args.what!r})")
    dev = cli.resolve_device(ap, args.device)
    build_note = "; a first CUDA call includes the kernels' build" if dev.type == "cuda" else ""

    data = read_rfmip(args.input)
    os.makedirs(args.output_dir, exist_ok=True)

    def run(band, solve, model_files, names):
        models = [load_model_netcdf(os.path.join(args.models_dir, f), device=dev)
                  for f in model_files]
        t0 = time.perf_counter()
        fb = solve(models)
        up, dn = fb.flux_up.cpu().numpy(), fb.flux_dn.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"{band}: {data.ncol} columns in {dt:.2f}s ({data.ncol / dt:,.0f} cols/s "
              f"on {dev}{build_note})")
        print(f"    mean flux up  : {up.mean():10.4f} W/m2")
        print(f"    mean flux down: {dn.mean():10.4f} W/m2")
        for name, arr in zip(names, (up, dn)):
            path = os.path.join(args.output_dir, f"{name}_{args.tag}.nc")
            write_fluxes_rfmip(path, {name: arr}, data.plev, data.nexp, data.nsites)
            print(f"    wrote {path}")

    if "lw" in what:
        run("LW", lambda m: rfmip_clear_sky_lw(data, m, n_gauss_angles=args.n_gauss_angles,
                                               device=dev),
            [cli.LW_MODEL_FILE], ("rlu", "rld"))
    if "sw" in what:
        run("SW", lambda m: rfmip_clear_sky_sw(data, m, device=dev), cli.SW_MODEL_FILES,
            ("rsu", "rsd"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
