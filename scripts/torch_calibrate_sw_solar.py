"""Calibrate the per-band SW solar fractions against the all-sky smoke
fluxes, on the PyTorch port (produces gasoptics.planck.SW_SOLAR_BAND_FRAC_CAL).

The counterpart of scripts/calibrate_sw_solar.py, with its lines. Without a
k-distribution file the NRLSSI2 per-g-point solar source is unavailable;
the default TOA source distributes the TSI across bands by a
brightness-temperature solar spectrum (gasoptics.planck.
solar_band_fractions(calibrated=False)). Broadband fluxes are linear in the
per-g-point TOA source, so the calibration is closed-form:
  1. run the g-112 all-sky SW driver 14 times, once per band (the full
     quadrature-weighted source in that band only, zero in the others) ->
     per-band (dn, up) mean-flux responses; on CUDA each run is one launch
     of K2 in its lookup-table cloud mode;
  2. solve the equality-constrained least squares
        min ||f - f_brightT||^2   s.t.  R^T f = (TARGET_DN, TARGET_UP),  sum f = 1
     through its normal equations (3 Lagrange multipliers), and refuse a
     solution with a fraction that is not positive.
TARGET_DN / TARGET_UP are the reference all-sky driver's printout
(rrtmgp_allsky.F90:487); the shipped fractions were solved on the
reference's files, and only those files regenerate them. ``--garand``,
``--sw-cloud-coeffs`` and ``--models-dir`` (the g-112 SW nets under the
reference's file names, utils/cli.py) are required.

Run:  python scripts/torch_calibrate_sw_solar.py --garand FILE --sw-cloud-coeffs FILE
          --models-dir DIR [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from rte_rrtmgp_nn_tpu_torch.drivers.allsky import allsky_sw
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
    gpt_weights_for, solar_band_fractions, spectral_for, sw_spectral_g112)
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.utils import cli

TSI = 1360.85
TARGET_DN, TARGET_UP = 946.975098, 325.290985  # rrtmgp_allsky.F90:487
NCOL = 24


def band_responses(garand: str, cloud_coeffs: str, models, spec, device) -> np.ndarray:
    """(nband, 2): the mean all-sky (dn, up) fluxes of ``NCOL`` columns of
    the Garand file under a source of TSI in one band only, a band a row."""
    w = gpt_weights_for(spec)
    resp = np.zeros((spec.nband, 2))
    for ib, (s, e) in enumerate(spec.band_lims_gpt):
        src = np.zeros(spec.ngpt)
        src[s:e] = TSI * w[s:e]
        fs = allsky_sw(garand, cloud_coeffs, models, ncol=NCOL, spectral=spec,
                       solar_source=src, device=device)
        resp[ib] = (float(np.mean(fs.flux_dn.cpu().numpy())),
                    float(np.mean(fs.flux_up.cpu().numpy())))
        print(f"band {ib:2d}: dn={resp[ib, 0]:9.3f}  up={resp[ib, 1]:8.3f}", flush=True)
    return resp


def band_fractions(resp: np.ndarray, f0: np.ndarray) -> np.ndarray:
    """The fractions closest to ``f0`` whose responses ``resp`` give
    (TARGET_DN, TARGET_UP) and which sum to 1. Raises AssertionError when
    a fraction is not positive (no physical solar spectrum reaches the
    targets)."""
    a_mat = np.vstack([resp[:, 0], resp[:, 1], np.ones(len(f0))])
    b = np.array([TARGET_DN, TARGET_UP, 1.0])
    lam = np.linalg.solve(a_mat @ a_mat.T, b - a_mat @ f0)
    f = f0 + a_mat.T @ lam
    if not np.all(f > 0):
        raise AssertionError(f)
    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    cli.add_reference_argument(ap, "--garand", cli.GARAND_IN_REFERENCE)
    cli.add_reference_argument(ap, "--sw-cloud-coeffs", cli.CLOUD_COEFFS_IN_REFERENCE.format("sw"))
    cli.add_reference_argument(ap, "--models-dir", cli.MODELS_DIR_IN_REFERENCE, "directory")
    cli.add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = cli.resolve_device(ap, args.device)

    models = [load_model_netcdf(os.path.join(args.models_dir, f), device=dev)
              for f in cli.SW_MODEL_FILES]
    spec = spectral_for("sw", models, entry="torch_calibrate_sw_solar.py",
                        accepts=(sw_spectral_g112,))
    resp = band_responses(args.garand, args.sw_cloud_coeffs, models, spec, dev)
    f0 = solar_band_fractions(spec.band_lims_wvn_array, calibrated=False)
    f = band_fractions(resp, f0)
    print("\ncalibrated fractions (paste into planck.SW_SOLAR_BAND_FRAC_CAL):")
    print(np.array2string(f, precision=8, separator=", "))
    print(f"max |delta| vs brightness-temp: {np.abs(f - f0).max():.2e}")
    print(f"achieved dn/up: {f @ resp[:, 0]:.6f} / {f @ resp[:, 1]:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
