#!/usr/bin/env python3
"""Would the fused SW kernel keep its accuracy with float64 two-stream
coefficients only near the resonance k*mu0 = 1?

    python3 scripts/probe_sw_float64_guard.py

The kernel (csrc/sw_megakernel.cu) and its plain twin evaluate the PIFM
coefficients in float64 in every cell, which is most of the kernel's
arithmetic. This probe runs the twin's function in PyTorch on one NVIDIA GPU
with the coefficients in float32 except where |1 - (k*mu0)**2| is below a
threshold, and holds the fluxes per column against the twin in float64
throughout, on two inputs: chip_smoke.py's 1800 x 60 atmosphere, and 6
columns x 20 layers whose mu0 lies within 2e-4 of 1/k in every layer (the
input of tests/test_torch_megakernels.py::test_sw_resonance_gap_to_jax_kernel).
The rule for a guarded kernel: every column of both within 2e-2 W/m2 of
float64. Prints, per threshold, the share of cells that take float64, the
largest column error and the columns beyond 2e-2.
"""
from __future__ import annotations

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import NCOL, NLAY, SEED, SW_ATOL, SW_MODEL, gpu_line  # noqa: E402

THRESHOLDS = (0.0, 1e-3, 1e-2, 3e-2, 1e-1, 3e-1, math.inf)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sw_float64_guard: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.config import config
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.ops.sw_solver import sw_adding_broadband, sw_two_stream_coeffs
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy, synthesize_rfmip

    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev, f64 = torch.device("cuda", 0), torch.float64
    model = load_model_netcdf(SW_MODEL, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spectral_g112()), dtype=torch.float32,
                            device=dev)

    def sw_args(ncol, nlay, seed):
        data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
        sw_in = rfmip.sw_canonical_inputs(data, dev)
        args, _ = fused.sw_args([model, model], None, *rfmip.sw_fused_inputs(solar, *sw_in))
        return list(args)

    resonance = sw_args(6, 20, 3)
    resonance[6] = (1.0 / math.sqrt(1.75) + torch.linspace(-2e-4, 2e-4, 6, device=dev)).float()
    inputs = {f"{NCOL}x{NLAY}": sw_args(NCOL, NLAY, SEED), "resonance 6x20": resonance}

    def fluxes(args, threshold):
        """The twin's function with float64 coefficients where |1 - (k*mu0)**2|
        < threshold; returns (fluxes, share of cells in float64)."""
        ma, mr, x2d, cf, perm, col_dry, mu0, inc, alb_dir, alb_dif = args
        tau_ray = k2._net_tau(mr, x2d, cf, perm, col_dry)
        tau = k2._net_tau(ma, x2d, cf, perm, col_dry) + tau_ray
        pos = tau > 0
        ssa = torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)
        g = torch.zeros_like(tau)
        c32 = sw_two_stream_coeffs(tau, ssa, g, mu0[:, None], fast_exp=False)[:4]
        c64 = sw_two_stream_coeffs(tau.to(f64), ssa.to(f64), g.to(f64), mu0.to(f64)[:, None],
                                   fast_exp=False)[:4]
        g1, g2 = (8.0 - 5.0 * ssa.to(f64)) * 0.25, 0.75 * ssa.to(f64)  # PIFM gammas, g = 0
        k = torch.sqrt(torch.clamp_min((g1 - g2) * (g1 + g2), config.k_min))
        near = (1.0 - (k * mu0.to(f64)[:, None]) ** 2).abs() < threshold
        coeffs = [torch.where(near, b.to(tau.dtype), a) for a, b in zip(c32, c64)]
        out = sw_adding_broadband(*coeffs, tau, mu0, inc, alb_dir, alb_dif, torch.zeros_like(inc),
                                  fast_exp=False)
        return out, float(near.float().mean())

    worst = {}
    for name, args in inputs.items():
        a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
        a64[0] = a64[1] = float64_copy(model)
        ref = k2.sw_clearsky_megakernel_plain(*a64)
        for thr in THRESHOLDS:
            got, share = fluxes(args, thr)
            col_err = torch.stack([(a.double() - b).abs().amax(1) for a, b in zip(got, ref)]).amax(0)
            over = int((col_err > SW_ATOL).sum())
            worst[(name, thr)] = float(col_err.max())
            print(f"{name}: float64 where |1 - (k*mu0)^2| < {thr:g} ({share:.4f} of the cells): "
                  f"max column |flux - float64| {float(col_err.max()):.3e} W/m2, {over} column(s) "
                  f"beyond {SW_ATOL}", flush=True)
    for thr in THRESHOLDS:
        ok = all(worst[(name, thr)] <= SW_ATOL for name in inputs)
        print(f"threshold {thr:g}: {'within' if ok else 'NOT within'} {SW_ATOL} W/m2 of float64 on "
              f"every column of both inputs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
