#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's RFMIP clear-sky and
all-sky paths on one NVIDIA GPU.

    python3 scripts/profile_torch_rfmip.py

At chip_smoke.py's size, seed and models, prints, with the card's name and
power limit:
  - the host-side stages of one driver call (Planck table, canonicalization,
    host-to-device copies) on the host clock, each ended by a synchronize;
  - a torch.profiler window over ITERS calls of the fused LW and SW cores
    (K1, K2), one over the general cores (LW with N_ANGLES Gauss angles:
    K3 + K7 once for all angles; staged SW: K5 + the PyTorch sweeps), one over the
    fused all-sky cores (K1 and K2 in their lookup-table cloud mode, on
    chip_smoke.py's synthetic Garand and coefficient files), one over
    the staged all-sky cores (K3 + K7; K5 + the PyTorch sweeps), one over
    the prep LW core (K6 + K7's fields mode) and one each over the
    lookup-table LW path (gas_optics_lw_lut -> rte_lw, one angle: K7) and SW
    path (gas_optics_sw_lut -> rte_sw) on chip_smoke.py's synthetic
    k-distributions, on device-resident inputs: the window per call (CUDA events), the device
    time per call summed over kernels, the device's idle share (1 - busy /
    window, unclamped: a negative share means the busy total is wrong), the
    kernel launches per call, and the kernels that take the most device
    time.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    LUT_GPTS_PER_BAND, LW_MODEL, N_ANGLES, NCOL, NLAY, SEED, SW_MODEL, allsky_core_closures,
    gpu_line, write_allsky_files)

ITERS = 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_rfmip: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
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
        lw_in = host("lw_canonical_inputs (H2D + layout on the device)",
                     lambda: rfmip.lw_canonical_inputs(data, lw_spec, dev))
        sw_in = host("sw_canonical_inputs (H2D + layout on the device)",
                     lambda: rfmip.sw_canonical_inputs(data, dev))
        host("rfmip_clear_sky_lw", lambda: rfmip.rfmip_clear_sky_lw(data, [lw_model], device=dev))
        host("rfmip_clear_sky_sw",
             lambda: rfmip.rfmip_clear_sky_sw(data, [sw_model, sw_model], device=dev))

    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    lw_gen_in = rfmip.lw_staged_inputs(data, lw_spec, dev)
    sw_gen_in = rfmip.sw_staged_inputs(data, dev)

    def fused_cores():
        fused.lw_core([lw_model], table, lw_spec, *lw_in, top_at_1=True)
        rfmip._sw_core_mega_canon([sw_model, sw_model], solar, *sw_in, top_at_1=True)

    def general_cores():
        rfmip._lw_core([lw_model], table, lw_spec, *lw_gen_in, top_at_1=True,
                       n_gauss_angles=N_ANGLES)
        rfmip._sw_core_lay_major([sw_model, sw_model], solar, *sw_gen_in, top_at_1=True)

    window("fused LW+SW cores", fused_cores, tag)
    window(f"general cores (LW {N_ANGLES} angles + staged SW)", general_cores, tag)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cores = allsky_core_closures(dev, lw_model, [sw_model, sw_model], write_allsky_files(tmp))

    def both(route):
        return lambda: (cores[f"allsky_lw_core_{route}"](), cores[f"allsky_sw_core_{route}"]())

    window("fused all-sky LW+SW cores (lookup-table clouds)", both("fused"), tag)
    window("staged all-sky LW+SW cores (LW 1 angle)", both("staged"), tag)

    window("prep LW core (K6 + K7 fields mode)", lambda: rfmip._lw_core_prep(
        [lw_model], table, lw_spec, *lw_gen_in, top_at_1=True), tag)

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.gasoptics.lut_gas_optics import (
        gas_optics_lw_lut, gas_optics_sw_lut)
    from rte_rrtmgp_nn_tpu_torch.rte import rte_lw, rte_sw

    with tempfile.TemporaryDirectory() as tmp:
        kd = {k: load_kdist(p, testing.LUT_GASES, device=dev)
              for k, p in testing.write_lut_files(tmp, LUT_GPTS_PER_BAND, SEED).items()}
    play, plev, tlay, tlev, tsfc, mu0, gases = testing.lut_inputs(
        synthesize_rfmip(NCOL, NLAY, SEED), dev, torch.float32)
    emis = torch.full((NCOL, kd["lw"].nband), 0.97, device=dev)
    alb = torch.full((NCOL, kd["sw"].ngpt), 0.1, device=dev)

    def lut_lw():
        props, src = gas_optics_lw_lut(kd["lw"], play, plev, tlay, tsfc, gases, tlev=tlev)
        rte_lw(props, True, src, emis, broadband=True)

    def lut_sw():
        props, src = gas_optics_sw_lut(kd["sw"], play, plev, tlay, gases)
        rte_sw(props, True, mu0, src.toa_source, alb, alb, broadband=True)

    window(f"LUT LW path ({kd['lw'].ngpt} g-points, 1 angle)", lut_lw, tag)
    window(f"LUT SW path ({kd['sw'].ngpt} g-points)", lut_sw, tag)
    return 0


def window(name, cores, tag) -> None:
    """A torch.profiler window over ITERS calls of ``cores``: print the
    window per call (CUDA events), the device busy time per call summed
    over kernels, the idle share, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    ms = start.elapsed_time(end) / ITERS

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
    launches = sum(e.count for e in events) / ITERS
    print(f"profile {name}: window {ms:.4f} ms/call, device busy {busy:.4f} ms/call, "
          f"idle share {1 - busy / ms:.4f}, {launches:.1f} kernel launches/call | {tag}")
    if not events:
        print("profile: the trace holds no device time; the window above is from CUDA events")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile {name} kernel {e.key[:60]!r}: {dev_us(e) / 1e3 / ITERS:.4f} ms/call, "
              f"{e.count / ITERS:.1f} launches/call")


if __name__ == "__main__":
    sys.exit(main())
