"""Train a fresh SW absorption emulator end to end (demonstration), on the
PyTorch port.

The counterpart of scripts/train_demo_sw.py, with its flags, output lines
and file name: distil the g-112 SW absorption teacher net into a smaller
net on the atmospheres of an RFMIP file with the hybrid expdiff loss, score
each epoch with the SW radiation of the whole problem against the
teacher's own fluxes (radiation-in-the-loop early stopping), and save the
best net in the reference netCDF format (score-encoded file name). The
teacher's Rayleigh net is kept, as the reference trains the two nets as
separate models. The boundary conditions are rrtmgp_rfmip_sw.F90's: night
columns (sza >= 90 deg) take mu0 = 1 and their fluxes are zeroed, the
solar source is renormalized to each column's TSI, the albedo is the same
on every g-point. On CUDA the teacher's reference and each epoch's eval are
one launch of K5 (``predict_nn_sw``) each, then ``rte_sw`` (PyTorch). The
steps shared with the LW demo are in training/distill.py. ``--models-dir``
(the teachers under the reference's file names, utils/cli.py) and
``--rfmip`` are required.

Run:  python scripts/torch_train_demo_sw.py --models-dir DIR --rfmip FILE [--epochs N]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import predict_nn_sw
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalProps2str
from rte_rrtmgp_nn_tpu_torch.rte import rte_sw
from rte_rrtmgp_nn_tpu_torch.training import distill
from rte_rrtmgp_nn_tpu_torch.training.eval_loop import EarlyStopResult
from rte_rrtmgp_nn_tpu_torch.utils import cli


def run(argv=None) -> EarlyStopResult:
    """The demo with the command line ``argv``; returns the training loop's
    result (each epoch's loss, score and metrics; the best net)."""
    ap = argparse.ArgumentParser()
    distill.add_arguments(ap, hidden=48)
    cli.add_reference_argument(ap, "--models-dir", cli.MODELS_DIR_IN_REFERENCE, "directory")
    cli.add_reference_argument(ap, "--rfmip", cli.RFMIP_INPUT_IN_REFERENCE)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    t_abs, t_ray = (load_model_netcdf(os.path.join(args.models_dir, f), device=dev)
                    for f in cli.SW_MODEL_FILES)
    data = read_rfmip(args.rfmip)
    spec = sw_spectral_g112()
    ncol, ngpt = data.ncol, t_abs.n_outputs

    play, plev, tlay, sfc_alb, _, _, tsi, concs = rfmip.sw_staged_inputs(data, dev)
    x, y, col_dry = distill.teacher_targets(t_abs, play, plev, tlay, GasConcs(concs))

    # SW boundary conditions (rrtmgp_rfmip_sw.F90): day-column masking,
    # TSI renormalization, band albedo expanded to g-points
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    mu0 = f32(np.cos(np.deg2rad(data.sza)))
    usecol = torch.as_tensor(np.asarray(data.sza) < 90.0, device=dev)
    mu0_safe = torch.where(usecol, mu0, 1.0)
    toa = f32(rfmip.default_solar_source(spec))[None, :].expand(ncol, spec.ngpt)
    toa = toa * (tsi / toa.sum(-1))[:, None]
    alb = sfc_alb[:, None].expand(ncol, ngpt).contiguous()
    mask = usecol[:, None]

    def flux_of(model_abs):
        tau, ssa = predict_nn_sw([model_abs, t_ray], x, col_dry)
        atmos = OpticalProps2str(tau, ssa, torch.zeros_like(tau), spec)
        sol = rte_sw(atmos, data.top_at_1, mu0_safe, toa, alb, alb, broadband=True)
        return sol.flux_up * mask, sol.flux_dn * mask

    with torch.no_grad():
        ref = flux_of(t_abs)
    student = distill.student(t_abs, args.hidden, args.init_from, dev)
    save_tmpl = os.path.join(args.out_dir, f"sw-g112-demo_absorption_{args.hidden}_{args.hidden}"
                             + "_HR_{hr}_FRC_{frc}.nc")
    return distill.train(student, x, y, data, flux_of, ref, args, save_tmpl)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
