#!/usr/bin/env python3
"""Time the LW front-end kernel (csrc/lw_prep.cu) at several stated
residencies on one NVIDIA GPU.

    python3 scripts/tune_lw_prep_residency.py

For each blocks-per-SM value in __launch_bounds__ an edited copy of the
source is built into a temporary directory and loaded in place of the
package's library; the kernel is timed at chip_smoke.py's size (1800 x 60,
the g-128 demo net) with chip_smoke.cuda_ms, in one order and then in the
reverse order, so that a drift of the card shows. Prints the card, and per
build the registers ptxas reports, the spill and the time.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import LW_MODEL, NCOL, NLAY, SEED, cuda_ms, gpu_line  # noqa: E402

RESIDENCIES = (4, 2, 3, 6, 8, 1)
STATED = "constexpr int kBlocksPerSm = 4;"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_lw_prep_residency: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    print(gpu_line())
    dev = torch.device("cuda", 0)
    spec = lw_spectral_g128()
    model = load_model_netcdf(LW_MODEL, device=dev)
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    data = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, SEED))
    play_t, plev_t, tlay_t, tlev_t, tsfc, _, concs_t = rfmip.lw_canonical_inputs(data, spec, dev)
    gases = GasConcs(concs_t)
    col_dry = go.get_col_dry_lay_major(gases.get_vmr("h2o", NLAY, NCOL), plev_t).contiguous()
    x = go.compute_nn_inputs(play_t, tlay_t, gases, model).contiguous()
    args = (model, x, col_dry, table.interpolate(tlay_t), table.interpolate(tlev_t),
            table.interpolate(tsfc), spec.gpt2band_tensor(dev))
    source = (build.CSRC_DIR / "lw_prep.cu").read_text()
    if STATED not in source:
        print(f"tune_lw_prep_residency: {STATED!r} not found in lw_prep.cu", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        for order in (RESIDENCIES, RESIDENCIES[::-1]):
            for n in order:
                cu = os.path.join(tmp, f"lw_prep_{n}.cu")
                with open(cu, "w") as f:
                    f.write(source.replace(STATED, f"constexpr int kBlocksPerSm = {n};"))
                so = os.path.join(tmp, f"lw_prep_{n}.so")
                r = subprocess.run(
                    [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared", "-o", so,
                     cu, str(build.CSRC_DIR / "errors.cu")], capture_output=True, text=True)
                if r.returncode != 0:
                    print(r.stdout + r.stderr, file=sys.stderr)
                    return 1
                log = r.stdout + r.stderr
                lib = ctypes.CDLL(so)
                lib.lw_prep_launch.argtypes = [build.P, build.P, build.I, build.P]
                lib.lw_prep_launch.restype = build.I
                lib.rte_cuda_error_string.argtypes = [build.I]
                lib.rte_cuda_error_string.restype = ctypes.c_char_p
                build._lib = lib  # the wrapper launches from this library from here on
                k6.lw_prep(*args)
                torch.cuda.synchronize()
                print(f"kBlocksPerSm {n}: registers {re.findall(r'Used (\d+) registers', log)} "
                      f"spill {re.findall(r'(\d+) bytes spill stores', log)} "
                      f"ms {cuda_ms(lambda: k6.lw_prep(*args)):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
