"""RFMIP evaluation CLI with machine-parsable output, on the PyTorch port.

The counterpart of scripts/eval_rfmip.py, with the same arguments and
output (reference parity: ``rrtmgp_lw_eval_nn_rfmip.F90``): run the RFMIP
LW problem with candidate NN model(s) on ``--device`` (on CUDA one lw_both
net is one launch of K1), compute the 8 scalar error metrics against
reference fluxes, and print them between ``--------`` delimiter lines
(:582-603) for consumption by training harnesses. ``--cpu`` is
``--device cpu``. ``--rfmip``, which the JAX script defaults to the
reference checkout's file, is required (utils/cli.py).

Usage:
  python scripts/torch_eval_rfmip.py MODEL.nc [MODEL2.nc] --rfmip FILE --ref-fluxes ref.nc
  python scripts/torch_eval_rfmip.py MODEL.nc --rfmip FILE --save-fluxes out.nc

Without --ref-fluxes, the candidate fluxes are written (if --save-fluxes)
and the metric block reports zeros -- generate a reference flux file first
from a trusted model or the LUT path.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from rte_rrtmgp_nn_tpu_torch.drivers.flux_output import write_fluxes_rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.training.eval_loop import METRIC_NAMES, eval_metrics
from rte_rrtmgp_nn_tpu_torch.utils import cli, ncio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("models", nargs="+", help="NN model netCDF file(s)")
    cli.add_reference_argument(ap, "--rfmip", cli.RFMIP_INPUT_IN_REFERENCE)
    ap.add_argument("--ref-fluxes", default=None, help="reference flux netCDF (rlu, rld)")
    ap.add_argument("--save-fluxes", default=None, help="write candidate fluxes here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    ap.add_argument("--figures", default=None, metavar="DIR",
                    help="write the visual diagnostic figure set (flux/HR "
                         "error profiles, ml_eval_funcs.py parity) here; "
                         "requires --ref-fluxes")
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, "cpu" if args.cpu else args.device)

    data = read_rfmip(args.rfmip)
    models = [load_model_netcdf(p, device=dev) for p in args.models]
    fb = rfmip_clear_sky_lw(data, models, device=dev)
    up = fb.flux_up.cpu().numpy()
    dn = fb.flux_dn.cpu().numpy()
    print(f"mean of flux_down is: {dn.mean():.4f}")
    print(f"mean of flux_up is:   {up.mean():.4f}")

    if args.save_fluxes:
        write_fluxes_rfmip(
            args.save_fluxes, {"rlu": up, "rld": dn}, data.plev, data.nexp, data.nsites
        )
        print(f"fluxes written to {args.save_fluxes}")

    metrics = np.zeros(8)
    if args.ref_fluxes:
        with ncio.NCFile(args.ref_fluxes) as f:
            rlu = f.read("rlu", np.float64).reshape(data.ncol, -1)
            rld = f.read("rld", np.float64).reshape(data.ncol, -1)
        metrics = eval_metrics(fb.flux_up, fb.flux_dn, rlu, rld,
                               np.asarray(data.plev, np.float64), data.nexp,
                               top_at_1=data.top_at_1)
        if args.figures:
            from rte_rrtmgp_nn_tpu_torch.training.diagnostics import save_eval_figures

            name = os.path.splitext(os.path.basename(args.models[0]))[0]
            paths = save_eval_figures(
                args.figures, rlu, rld, up, dn, np.asarray(data.plev), prefix=name,
            )
            for p in paths:
                print(f"figure written to {p}")

    # the reference's '--------'-delimited machine-parsable block
    print("--------")
    print(", ".join(METRIC_NAMES))
    print("--------")
    print(", ".join(f"{m:8.4f}" for m in metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
