#!/usr/bin/env python3
"""What the staged SW route costs on one NVIDIA GPU, for one tree of this
repository: time, kernel launches and peak device memory.

    python3 scripts/torch_sw_staged_cost.py [--tree DIR] [--device cpu --ncol 64 --block 32]

``--tree`` is the root of the checkout whose package is imported and built
(default: this one), so that the same command measures another commit (a
``git archive`` of it unpacked into a directory) in the same process
layout; run the two trees in one call as parent, change, change, parent.
``--device cpu`` with small ``--ncol`` / ``--block`` is a dry run of the
script.

Measured, at ``--ncol`` (default 1800) x 60 layers from seed 0:
  - ``staged SW core``: drivers.rfmip._sw_core_lay_major (on CUDA K5, then
    the two-stream coefficients and the adding sweeps in PyTorch) with the
    g-112 demo net as both nets and with the matched sw-synth56-lut 128_128
    pair on the synthetic 56-g-point k-distribution it was trained on: the
    median of 25 samples of 10 back-to-back calls (CUDA events), the kernel
    launches and the device busy time a call (torch.profiler over 3 calls);
  - ``staged SW core at a GCM block``: the stand-in core at ``--block``
    (default 57,600) columns: its time (median of 5 single calls) and
    torch.cuda.max_memory_allocated over the call, less what was allocated
    before it;
  - ``staged GCM block``: drivers.gcm.gcm_sweep_allsky with
    use_megakernel=False (K3 + K7, K5) over one block of ``--block`` columns
    (synthesize_gcm_columns over the RFMIP-size atmosphere, lookup-table
    clouds): its elapsed seconds and peak allocated memory likewise.
Every line ends with the card's name and power limit. The last line is one
JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

NLAY, SEED = 60, 0
LW_MODEL = "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc"
SW_MODEL = "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc"
SW_PAIR = [f"sw-synth56-lut_{k}_128_128_HR_4.22e-02_FRC_1.44e-01.nc"
           for k in ("absorption", "rayleigh")]


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def launches(fn, dev, calls=3) -> tuple[float, float]:
    """(kernel launches a call, device busy ms a call) by torch.profiler,
    memory copies and sets left out; (nan, nan) off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return float("nan"), float("nan")
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync(dev)

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
          and dev_us(e) > 0 and not e.key.startswith(("Memcpy", "Memset"))]
    return sum(e.count for e in ev) / calls, sum(dev_us(e) for e in ev) / 1e3 / calls


def peak(fn, dev, reps=5) -> tuple[float, float]:
    """(median ms of single calls on the host clock after a synchronize,
    peak bytes allocated over a call less those allocated before it)."""
    import torch

    fn()
    sync(dev)
    times, peaks = [], []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if dev.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(dev) - before)
    return statistics.median(times), float(max(peaks)) if peaks else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ncol", type=int, default=1800)
    ap.add_argument("--block", type=int, default=57_600)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_sw_staged_cost: no CUDA device (--device cpu for a dry run)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import rte_rrtmgp_nn_tpu_torch as pkg
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, gcm, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky_io import GARAND_GASES
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        lw_spectral_g128, spectral_for, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.utils import bench
    from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

    assert os.path.abspath(pkg.__file__).startswith(tree), f"imported {pkg.__file__}, not {tree}"
    card = bench.card_line() if dev.type == "cuda" else "cpu"
    art = os.path.join(tree, "artifacts")
    print(f"torch_sw_staged_cost: tree {tree}; {card}; torch {torch.__version__}")
    if dev.type == "cuda":
        from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

        build.library()
    out = {"tree": tree, "card": card}
    f32 = torch.float32
    data = rfmip_data_from_arrays(testing.synthesize_rfmip(args.ncol, NLAY, SEED))
    sw_in = rfmip.sw_staged_inputs(data, dev)
    stand = load_model_netcdf(os.path.join(art, SW_MODEL), device=dev)
    sw_spec = spectral_for("sw", [stand, stand], entry="torch_sw_staged_cost.py",
                           accepts=(sw_spectral_g112,))
    stand_solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=f32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        kpath = os.path.join(tmp, "kdist-synthetic-sw-g4-nband14.nc")
        generate_kdist_nc(kpath, kind="sw", gases=testing.LUT_GASES, gpts_per_band=4, nband=14)
        kd = load_kdist(kpath, testing.LUT_GASES, device=dev)
        pair_solar = torch.as_tensor(np.asarray(rfmip.resolve_solar_source(kd.spectral, kd)),
                                     dtype=f32, device=dev)
        pair = [load_model_netcdf(os.path.join(art, p), device=dev) for p in SW_PAIR]
        cores = {"stand-in": lambda: rfmip._sw_core_lay_major(
                     [stand, stand], stand_solar, *sw_in, top_at_1=True),
                 "pair": lambda: rfmip._sw_core_lay_major(pair, pair_solar, *sw_in,
                                                          top_at_1=True)}
        for name, core in cores.items():
            ms = bench.cuda_ms(core, device=dev)["median"]
            n, busy = launches(core, dev)
            out[f"staged_sw_core_{name}"] = {"ms": ms, "launches": n, "busy_ms": busy}
            print(f"staged SW core, {name}, {args.ncol}x{NLAY}: {ms:.4f} ms, {n:.1f} kernel "
                  f"launches a call, device busy {busy:.4f} ms a call | {card}")

        big = rfmip_data_from_arrays(testing.synthesize_rfmip(args.block, NLAY, SEED))
        big_in = rfmip.sw_staged_inputs(big, dev)
        ms, nbytes = peak(lambda: rfmip._sw_core_lay_major([stand, stand], stand_solar, *big_in,
                                                           top_at_1=True), dev)
        out["staged_sw_core_block"] = {"ncol": args.block, "ms": ms, "peak_bytes": nbytes}
        print(f"staged SW core at a GCM block, stand-in, {args.block}x{NLAY}: {ms:.1f} ms, peak "
              f"allocated {nbytes / 2**30:.3f} GiB over the call | {card}")
        del big_in

        base = testing.synthesize_rfmip(args.ncol, NLAY, SEED)
        base["gases"] = {g: v for g, v in base["gases"].items() if g in GARAND_GASES}
        host = gcm.synthesize_gcm_columns(rfmip_data_from_arrays(base), args.block, seed=SEED)
        co = {}
        lw = load_model_netcdf(os.path.join(art, LW_MODEL), device=dev)
        lw_spec = spectral_for("lw", [lw], entry="torch_sw_staged_cost.py",
                               accepts=(lw_spectral_g128,))
        for band, spec in (("lw", lw_spec), ("sw", sw_spec)):
            path = os.path.join(tmp, f"{band}-lut.nc")
            write_nc(path, *testing.cloud_optics_nc_variables(
                testing.synthesize_cloud_optics(spec, SEED, "lut")))
            co[band] = allsky.load_cloud_optics_checked(path, device=dev)
        with config_override(use_megakernel=False):
            ms, nbytes = peak(lambda: gcm.gcm_sweep_allsky(
                host, [lw], [stand, stand], co["lw"], co["sw"], block_size=args.block,
                device=dev), dev, reps=3)
        out["staged_gcm_block"] = {"ncol": args.block, "ms": ms, "peak_bytes": nbytes}
        print(f"staged GCM block (K3 + K7, K5), {args.block}x{NLAY}: {ms:.1f} ms, peak allocated "
              f"{nbytes / 2**30:.3f} GiB over the sweep | {card}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
