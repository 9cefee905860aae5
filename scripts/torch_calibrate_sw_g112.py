"""Regenerate the g-112 SW quadrature weights, on the PyTorch port.

The counterpart of scripts/calibrate_sw_g112.py. The reduced g-112 SW
k-distribution's per-g-point quadrature weights are not shipped with the NN
models; this script recovers them by matching band transmissions against
the unreduced g-224 SW net (16 canonical RRTM quadrature points per band)
over every 7th column of an RFMIP file, partial columns at every 10th layer
and four airmasses: a nonnegative least-squares fit per band with a
sum-to-one row (scipy's NNLS, on the host). On CUDA each net's optical
depths are one launch of K4 (``predict_tau``), brought to the host once.
It writes a module in the JAX script's format, by default the port's own
``rte_rrtmgp_nn_tpu_torch/gasoptics/sw_g112_weights.py`` (``--out``). The
shipped weights were fitted on the reference's files; only those files
regenerate them. ``--rfmip`` and ``--models-dir`` (the g-112 absorption
net and the g-224 net under the reference's file names, utils/cli.py) are
required.

Run:  python scripts/torch_calibrate_sw_g112.py --rfmip FILE --models-dir DIR [--out PATH]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
from scipy.optimize import nnls

from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import RFMIPData, read_rfmip
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import (
    compute_nn_inputs, get_col_dry, predict_tau)
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import SW_G112_GPT_PER_BAND, W16_CANONICAL
from rte_rrtmgp_nn_tpu_torch.models.network import NNModel, load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.utils import cli

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "rte_rrtmgp_nn_tpu_torch",
                   "gasoptics", "sw_g112_weights.py")
AIRMASSES = [1.0, 1.5, 2.5, 4.0]
BAND_ENDS = np.cumsum(SW_G112_GPT_PER_BAND)
BAND_STARTS = BAND_ENDS - np.asarray(SW_G112_GPT_PER_BAND)


def every_7th_column(data: RFMIPData) -> RFMIPData:
    """Every 7th column of ``data`` as a one-experiment problem."""
    idx = np.arange(0, data.ncol, 7)
    return dataclasses.replace(
        data,
        play=data.play[idx], plev=data.plev[idx], tlay=data.tlay[idx],
        tlev=data.tlev[idx], tsfc=data.tsfc[idx], sfc_emis=data.sfc_emis[idx],
        sfc_alb=data.sfc_alb[idx], sza=data.sza[idx], tsi=data.tsi[idx],
        gas_concs=GasConcs({k: (v[idx] if v.ndim == 2 else v)
                            for k, v in data.gas_concs.concs.items()}),
        nexp=1, nsites=len(idx))


def optical_depths(block: RFMIPData, models: list[NNModel], device) -> list[np.ndarray]:
    """Each net's absorption optical depth on ``block`` (K4 on CUDA), as
    float32 (ncol, nlay, ngpt) host arrays: one copy to the host a net."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    play, plev, tlay = f32(block.play), f32(block.plev), f32(block.tlay)
    gases = GasConcs({k: f32(v) for k, v in block.gas_concs.concs.items()})
    ncol, nlay = play.shape
    cd = get_col_dry(gases.get_vmr("h2o", ncol, nlay), plev)
    return [predict_tau(m, compute_nn_inputs(play, tlay, gases, m), cd).cpu().numpy()
            for m in models]


def fit_weights(c112: np.ndarray, c224: np.ndarray) -> tuple[np.ndarray, list]:
    """Per band, the nonnegative weights (summing to 1) of the g-112
    points whose transmissions exp(-m tau) over the partial columns ``c112``
    best match the canonical 16-point quadrature of the g-224 columns
    ``c224`` at every airmass m; and each band's rms residual."""
    weights = np.zeros(112)
    resids = []
    for ib, (s, e) in enumerate(zip(BAND_STARTS, BAND_ENDS)):
        A_rows, b_rows = [], []
        for m in AIRMASSES:
            A_rows.append(np.exp(-np.minimum(m * c112[:, s:e], 60.0)))
            b_rows.append(
                (np.exp(-np.minimum(m * c224[:, ib * 16:(ib + 1) * 16], 60.0))
                 * W16_CANONICAL).sum(-1))
        A, b = np.concatenate(A_rows), np.concatenate(b_rows)
        lam = 10.0
        w, _ = nnls(np.vstack([A, lam * np.ones((1, e - s))]), np.concatenate([b, [lam]]))
        w = w / w.sum()
        weights[s:e] = w
        resids.append(float(np.sqrt(np.mean((A @ w - b) ** 2))))
        print(f"band {ib+1:2d}: rms transmission residual {resids[-1]:.5f}")
    return weights, resids


def write_module(path: str, weights: np.ndarray, resids: list) -> None:
    """The weights as a Python module, in the JAX script's format."""
    with open(path, "w") as f:
        f.write('"""Calibrated per-g-point quadrature weights for the g-112 SW\n')
        f.write("k-distribution. GENERATED by scripts/torch_calibrate_sw_g112.py -- do not edit.\n")
        f.write(f'Per-band rms transmission residuals vs g-224: {[round(r,5) for r in resids]}\n"""\n')
        f.write("import numpy as np\n\n")
        f.write("SW_G112_WEIGHTS = np.array([\n")
        for s, e in zip(BAND_STARTS, BAND_ENDS):
            f.write("    " + ", ".join(f"{x:.6e}" for x in weights[s:e]) + ",\n")
        f.write("])\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    cli.add_reference_argument(ap, "--rfmip", cli.RFMIP_INPUT_IN_REFERENCE)
    cli.add_reference_argument(ap, "--models-dir", cli.MODELS_DIR_IN_REFERENCE, "directory")
    ap.add_argument("--out", default=os.path.normpath(OUT),
                    help="the module to write (default: the port's gasoptics/sw_g112_weights.py)")
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)

    block = every_7th_column(read_rfmip(args.rfmip))
    models = [load_model_netcdf(os.path.join(args.models_dir, f), device=dev)
              for f in (cli.SW_MODEL_FILES[0], cli.SW_G224_MODEL_FILE)]
    tau112, tau224 = optical_depths(block, models, dev)
    if not block.top_at_1:
        tau112, tau224 = tau112[:, ::-1], tau224[:, ::-1]
    # partial columns at several depths add vertical diversity
    c112 = np.cumsum(tau112, axis=1)[:, 9::10, :].reshape(-1, 112)
    c224 = np.cumsum(tau224, axis=1)[:, 9::10, :].reshape(-1, 224)
    weights, resids = fit_weights(c112, c224)
    out = os.path.abspath(args.out)
    write_module(out, weights, resids)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
