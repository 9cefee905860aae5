#!/usr/bin/env python3
"""The LW transmittance in double (the shipped K1, K6 and K7:
csrc/lw_megakernel.cu, lw_prep.cu, lw_noscat.cu) against the same kernels
with float32 expf, on one NVIDIA GPU.

    python3 scripts/ab_transmittance_exp.py

Builds the package's sources twice into a temporary directory, once as
shipped and once with rte::transmittance (csrc/common.cuh) put back from
``(float)exp(-(double)tl)`` to ``expf(-tl)``, and loads each in turn in place of the package's
library. For each build, in the order shipped, expf, expf, shipped, timed
with chip_smoke.cuda_ms: K1 in its clear-sky and lookup-table cloud modes
(chip_smoke.mode_cases) at 1800 x 60 and at one GCM block (57,600 x 60), K6
at 1800 and 7200 columns, K7 for one and three angles at 7200 columns
(tune_megakernel_tiles.k7_cases); and K1 clear-sky's largest |flux -
float64| on 3000 GCM columns at 20 and 60 layers (the twin in float64 on
the card decides). Prints the card, then one line per build and reading.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    LW_MODEL, NLAY, SEED, SW_MODEL, cuda_ms, gpu_line, k6_args, mode_cases)
from tune_megakernel_tiles import SOURCES, compile_dir, k7_cases  # noqa: E402

# the body of rte::transmittance (csrc/common.cuh) as shipped and with expf
SHIPPED, EXPF = "{ return (float)exp(-(double)tl); }", "{ return expf(-tl); }"
SIZES = ((1800, 60), (57_600, 60))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_k1_exp: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, gcm, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy, synthesize_rfmip

    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev = torch.device("cuda", 0)
    lw_spec, sw_spec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    table = planck.PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    cases = {}
    for ncol, nlay in SIZES:
        every = mode_cases(dev, ncol, nlay, lw_model, sw_model, table, lw_spec, sw_spec, solar)
        for k in ("k1", "k1_cld_lut"):
            cases[f"K1 {k[3:] or 'clear'} {ncol}x{nlay}"] = (every[k][0], every[k][2], every[k][3])
    for ncol in (1800, 7200):
        data = rfmip_data_from_arrays(synthesize_rfmip(ncol, NLAY, SEED, top_at_1=True))
        cases[f"K6 {ncol}x{NLAY}"] = (k6.lw_prep, k6_args(dev, data, lw_model, table, lw_spec), {})
    for name, (_, _, call, _) in k7_cases(dev, lw_model, table, lw_spec, 7200).items():
        if "128 g-points" in name and "fields" not in name:
            cases[f"{name} 7200x{NLAY}"] = (lambda *a, call=call: call(), (), {})

    def gcm_args(nlay):
        host = gcm.synthesize_gcm_columns(rfmip_data_from_arrays(synthesize_rfmip(64, nlay, 57)),
                                          3000, seed=58)
        arrays = {k: host[k] for k in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis",
                                       "sfc_alb", "sza", "tsi")}
        arrays["gases"] = {k[4:]: v if v.ndim == 2 else np.repeat(v[:, None], nlay, axis=1)
                           for k, v in host.items() if k.startswith("gas:")}
        arrays["top_at_1"] = True
        args, _ = fused.lw_args([lw_model], table, lw_spec, *rfmip.lw_canonical_inputs(
            rfmip_data_from_arrays(arrays), lw_spec, dev))
        args = list(args)
        a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
        a64[0] = float64_copy(lw_model)
        a64[9] = planck.PlanckTable(table.totplnk.double(), table.totplnk_diff.double(),
                                    table.temp_ref_min, table.totplnk_delta)
        return args, k1.lw_clearsky_mega4_plain(*a64)

    accuracy = {nlay: gcm_args(nlay) for nlay in (20, 60)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag in ("shipped (double exp)", "float32 expf"):
            d = os.path.join(tmp, tag.split()[0])
            os.makedirs(d)
            for name in ("common.cuh",) + tuple(f"{n}.cu" for n in SOURCES):
                shutil.copy(build.CSRC_DIR / name, d)
            if tag == "float32 expf":
                path = os.path.join(d, "common.cuh")
                text = open(path).read()
                if text.count(SHIPPED) != 1:
                    raise RuntimeError("rte::transmittance's body is not in common.cuh once")
                open(path, "w").write(text.replace(SHIPPED, EXPF))
            libs[tag] = compile_dir(build, d)
        order = list(libs)
        for tag in order + order[::-1]:
            build._lib = libs[tag]
            for name, (fn, args, kw) in cases.items():
                print(f"{tag}: {name}: {cuda_ms(lambda: fn(*args, **kw)):.4f} ms", flush=True)
            for nlay, (args, ref) in accuracy.items():
                got = k1.lw_clearsky_mega4(*args)
                up, dn = (float((g.double() - r).abs().max()) for g, r in zip(got, ref))
                print(f"{tag}: K1 3000 GCM columns x {nlay}: |flux - float64| up {up:.3e} "
                      f"dn {dn:.3e} W/m2", flush=True)
        build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
