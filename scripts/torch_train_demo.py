"""Train a fresh LW gas-optics emulator end to end (demonstration), on the
PyTorch port.

The counterpart of scripts/train_demo.py, with its flags, output lines and
file name: distil a LW "both" teacher net into a smaller net on the
atmospheres of an RFMIP file, with radiation-in-the-loop early stopping
scored against the teacher's own fluxes, and save the best net in the
reference netCDF format (score-encoded file name). On CUDA the teacher's
fluxes are one launch of K1 (``rfmip_clear_sky_lw``) and each epoch's eval
one launch of K3 (``predict_nn_lw``) and one of K7 (``rte_lw``, broadband);
the teacher's raw outputs, the training targets, are plain matrix
products, as in the JAX script. The steps shared with the SW demo are in
training/distill.py. ``--teacher`` and ``--rfmip``, which the JAX script
takes from the reference checkout, are required (utils/cli.py).

Run:  python scripts/torch_train_demo.py --teacher MODEL_NC --rfmip FILE [--epochs N]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import predict_nn_lw
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
    PlanckTable, compute_planck_source_nn, lw_spectral_g128)
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalProps1scl
from rte_rrtmgp_nn_tpu_torch.rte import rte_lw
from rte_rrtmgp_nn_tpu_torch.sources import SourceFuncLW
from rte_rrtmgp_nn_tpu_torch.training import distill
from rte_rrtmgp_nn_tpu_torch.training.eval_loop import EarlyStopResult
from rte_rrtmgp_nn_tpu_torch.utils import cli


def run(argv=None) -> EarlyStopResult:
    """The demo with the command line ``argv``; returns the training loop's
    result (each epoch's loss, score and metrics; the best net)."""
    ap = argparse.ArgumentParser()
    distill.add_arguments(ap, hidden=64)
    cli.add_reference_argument(ap, "--teacher",
                               f"{cli.MODELS_DIR_IN_REFERENCE}/{cli.LW_MODEL_FILE}")
    cli.add_reference_argument(ap, "--rfmip", cli.RFMIP_INPUT_IN_REFERENCE)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    teacher = load_model_netcdf(args.teacher, device=dev)
    data = read_rfmip(args.rfmip)
    spec = lw_spectral_g128()
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=dev)

    # training set: the teacher's raw outputs on the RFMIP atmospheres
    play, plev, tlay, tlev, tsfc, emis, concs = rfmip.lw_staged_inputs(data, spec, dev)
    x, y, col_dry = distill.teacher_targets(teacher, play, plev, tlay, GasConcs(concs))
    emis = emis.contiguous()
    student = distill.student(teacher, args.hidden, args.init_from, dev)
    if args.init_from and student.weights[0].shape != (18, args.hidden):
        ap.error(f"--init-from hidden size {student.weights[0].shape[1]} != "
                 f"--hidden {args.hidden}")

    # teacher fluxes = the evaluation reference
    ref = rfmip.rfmip_clear_sky_lw(data, [teacher], spectral=spec, planck_table=table,
                                   device=dev)

    def flux_of(model):
        tau, pfrac = predict_nn_lw([model], x, col_dry)
        lay, lev, sfc, jac = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, spec, table,
                                                      top_at_1=data.top_at_1)
        sources = SourceFuncLW(lay, lev, sfc, jac, spec)
        sol = rte_lw(OpticalProps1scl(tau, spec), data.top_at_1, sources, emis, broadband=True)
        return sol.flux_up, sol.flux_dn

    save_tmpl = os.path.join(args.out_dir, f"lw-g128-demo_both_{args.hidden}_{args.hidden}"
                             + "_HR_{hr}_FRC_{frc}.nc")
    return distill.train(student, x, y, data, flux_of, (ref.flux_up, ref.flux_dn), args,
                         save_tmpl)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
