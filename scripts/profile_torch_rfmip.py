#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's RFMIP clear-sky path on
one NVIDIA GPU.

    python3 scripts/profile_torch_rfmip.py

At chip_smoke.py's size, seed and models, prints, with the card's name and
power limit:
  - the host-side stages of one driver call (Planck table, canonicalization,
    host-to-device copies) on the host clock, each ended by a synchronize;
  - a torch.profiler window over ITERS calls of the LW and SW kernel cores
    on device-resident inputs: the window per call (CUDA events), the device
    time per call summed over kernels, the device's idle share (1 - busy /
    window, unclamped: a negative share means the busy total is wrong), and
    the kernels that take the most device time.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import LW_MODEL, NCOL, NLAY, SEED, SW_MODEL, gpu_line  # noqa: E402

ITERS = 20


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_rfmip: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = f"{NCOL}x{NLAY} | {gpu_line()}"
    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    data = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, SEED))

    # ---- host stages of one driver call ------------------------------------
    def host(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"host {name}: {(time.perf_counter() - t0) * 1e3:.3f} ms | {tag}")
        return out

    for _ in range(2):  # the second pass is the steady state
        table = host("PlanckTable.compute",
                     lambda: PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev))
        host("canonicalize_rfmip_inputs", lambda: rfmip.canonicalize_rfmip_inputs(data))
        lw_in = host("lw_canonical_inputs (canonicalize + H2D)",
                     lambda: rfmip.lw_canonical_inputs(data, lw_spec, dev))
        sw_in = host("sw_canonical_inputs (canonicalize + H2D)",
                     lambda: rfmip.sw_canonical_inputs(data, dev))
        host("rfmip_clear_sky_lw", lambda: rfmip.rfmip_clear_sky_lw(data, [lw_model], device=dev))
        host("rfmip_clear_sky_sw",
             lambda: rfmip.rfmip_clear_sky_sw(data, [sw_model, sw_model], device=dev))

    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)

    def cores():
        rfmip._lw_core_mega4_canon([lw_model], table, lw_spec, *lw_in, top_at_1=True)
        rfmip._sw_core_mega_canon([sw_model, sw_model], solar, *sw_in, top_at_1=True)

    for _ in range(3):
        cores()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(ITERS):
            cores()
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / ITERS

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device-side entries only: the operator entries on the host carry the
    # device time of their kernels too, and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3 / ITERS
    print(f"profile LW+SW cores: window {window:.4f} ms/call, device busy {busy:.4f} ms/call, "
          f"idle share {1 - busy / window:.4f} | {tag}")
    if not events:
        print("profile: the trace holds no device time; the window above is from CUDA events")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile kernel {e.key[:60]!r}: {dev_us(e) / 1e3 / ITERS:.4f} ms/call, "
              f"{e.count / ITERS:.1f} launches/call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
