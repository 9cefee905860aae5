"""Multi-card scaling benchmark of the PyTorch port: columns/s per card and
weak-scaling efficiency.

The counterpart of ``bench_multichip.py`` on ``torch.distributed``: for
each device count N it runs N ranks (one per card, NCCL; gloo on the CPU),
each holding ``--cols-per-device`` columns of an RFMIP-like batch, and times
the LW + SW cores at that FIXED per-card column count. Weak-scaling
efficiency = per-card throughput at N / per-card throughput at the first
count. ``--core mega``: the fused cores split over 'col'
(drivers.rfmip ``lw_mega_core_sharded`` / ``sw_mega_core_sharded``: one K1
and one K2 launch a rank a call); ``--core staged``: the staged cores
(``_lw_core``: K3 + K7; ``_sw_core_lay_major``: K5 and the PyTorch sweeps).
Either way a rank holds only its own block of columns on its card.
``--profile`` adds, for every rank, a torch.profiler window over ``--iters``
calls: device busy and idle share, launches, and the host's time in
PyTorch operators per call.

The inputs are synthetic (``testing.synthesize_rfmip(1800, 60, 0)`` tiled
to the column count as ``bench_multichip._replicate_block`` tiles the RFMIP
file) with the in-repo demo nets, and the JSON says so. Each timed sample:
a barrier, CUDA events around ``--iters`` back-to-back LW + SW calls, the
best of ``--reps`` samples, the slowest rank's. A count of 1 runs in this
process; larger counts spawn their ranks.

    python scripts/torch_bench_multichip.py --device-counts 1 --core mega
    python scripts/torch_bench_multichip.py --device-counts 1,2,4 --core mega --profile
    python scripts/torch_bench_multichip.py --device cpu --device-counts 1,2 --cols-per-device 64 --iters 2

Prints one JSON line per count and a summary line (metric
multichip_cols_per_s_per_chip, with the efficiency table inside).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
import torch.distributed as dist

from rte_rrtmgp_nn_tpu_torch.parallel import distributed

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(HERE, "..", "artifacts")
LW_MODEL = os.path.join(ARTIFACTS, "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_MODEL = os.path.join(ARTIFACTS, "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")


def _replicate_block(data, ncol_target: int):
    """Tile the base batch up or down to exactly ``ncol_target`` columns."""
    reps = -(-ncol_target // data.ncol)

    def rep(a):
        return np.concatenate([np.asarray(a)] * reps, axis=0)[:ncol_target]

    return dataclasses.replace(
        data, play=rep(data.play), plev=rep(data.plev), tlay=rep(data.tlay),
        tlev=rep(data.tlev), tsfc=rep(data.tsfc), sfc_emis=rep(data.sfc_emis),
        sfc_alb=rep(data.sfc_alb), sza=rep(data.sza), tsi=rep(data.tsi),
        gas_concs=type(data.gas_concs)({k: (rep(v) if np.ndim(v) == 2 else v)
                                        for k, v in data.gas_concs.concs.items()}),
        nexp=1, nsites=ncol_target)


def _clock(dev):
    """(start, stop -> seconds) on CUDA events, or the host clock on the CPU."""
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return stop
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def rank_bench(core: str, cols_per_device: int, iters: int, reps: int,
               profile: bool = False) -> dict:
    """This rank's part of one device count: build the inputs, warm up, and
    time; returns the slowest rank's best seconds per LW + SW call, and
    with ``profile`` every rank's profiler window (``profile_window``)."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding, make_mesh
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    ndev = dist.get_world_size()
    mesh = make_mesh(n_col=ndev)
    dev = mesh.devices[0]
    ncol = cols_per_device * ndev
    data = _replicate_block(rfmip_data_from_arrays(synthesize_rfmip(1800, 60, 0)), ncol)
    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    lw_models = [load_model_netcdf(LW_MODEL, device=dev)]
    sw = load_model_netcdf(SW_MODEL, device=dev)
    sw_models = [sw, sw]
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    ((_, c0, n),) = column_sharding(mesh, 2).split(ncol)
    block = data.block(c0, n)
    if core == "mega":
        lw_fn = rfmip.lw_mega_core_sharded(mesh, lw_models, table, lw_spec, data.top_at_1)
        sw_fn = rfmip.sw_mega_core_sharded(mesh, sw_models, sw_spec, solar, data.top_at_1)
        lw_args = rfmip.lw_canonical_inputs(block, lw_spec, dev)
        sw_args = rfmip.sw_canonical_inputs(block, dev)
    else:
        def lw_fn(*a):
            return rfmip._lw_core(lw_models, table, lw_spec, *a, top_at_1=data.top_at_1,
                                  n_gauss_angles=1, scan_mode="sequential")

        def sw_fn(*a):
            return rfmip._sw_core_lay_major(sw_models, solar, *a, top_at_1=data.top_at_1)

        lw_args = rfmip.lw_staged_inputs(block, lw_spec, dev)
        sw_args = rfmip.sw_staged_inputs(block, dev)

    def call():
        return lw_fn(*lw_args), sw_fn(*sw_args)

    with torch.no_grad():
        call()  # the first call builds or loads the kernels
        best = float("inf")
        for _ in range(reps):
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stop = _clock(dev)
            for _ in range(iters):
                call()
            best = min(best, stop() / iters)
    slowest = torch.tensor([best], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    out = {"n_devices": ndev, "ncol": ncol, "s_per_iter": float(slowest)}
    if profile:
        window = profile_window(call, iters, dev)
        windows = [None] * ndev
        dist.all_gather_object(windows, window)
        out["profile"] = windows
    return out


def profile_window(call, iters: int, dev) -> dict:
    """A torch.profiler window over ``iters`` calls on this rank: the
    window per call (CUDA events), the device busy time per call summed
    over kernels, the idle share, the kernel launches per call, the host
    time per call inside PyTorch operators (self CPU time summed) and the
    three host operators that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(iters):
            call()
        b.record()
        torch.cuda.synchronize(dev)
    ms = a.elapsed_time(b) / iters
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy = sum(dev_us(e) for e in kernels) / 1e3 / iters
    top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:3]
    return {"rank": dist.get_rank(), "window_ms": ms, "busy_ms": busy,
            "idle_share": 1 - busy / ms,
            "launches": sum(e.count for e in kernels) / iters,
            "host_op_ms": sum(e.self_cpu_time_total for e in host) / 1e3 / iters,
            "top_host_ops": [(e.key[:40], e.self_cpu_time_total / 1e3 / iters) for e in top]}


def bench_count(ndev: int, device: str, core: str, cols_per_device: int, iters: int,
                reps: int, profile: bool = False) -> dict:
    """One device count: in this process for 1, else ``ndev`` spawned ranks."""
    args = (core, cols_per_device, iters, reps, profile)
    if ndev == 1 and not dist.is_initialized():
        distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=device)
        try:
            return rank_bench(*args)
        finally:
            dist.destroy_process_group()
    return distributed.launch(rank_bench, ndev, *args, device=device, timeout_s=900)[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cols-per-device", type=int, default=1824)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device-counts", type=str, default="",
                    help="comma list; default 1,2,4,...,N")
    ap.add_argument("--core", choices=["staged", "mega"], default="staged",
                    help="mega = the fused cores (K1, K2) split over 'col'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (gloo ranks)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timing, a torch.profiler window on every rank (CUDA only)")
    args = ap.parse_args(argv)
    if args.profile and args.device == "cpu":
        raise SystemExit("--profile reads the card's kernels: CUDA only")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for gloo ranks on the CPU")
    ndev_all = torch.cuda.device_count() if args.device != "cpu" else os.cpu_count()
    if args.device_counts:
        counts = [int(c) for c in args.device_counts.split(",")]
    else:
        counts = [1]
        while counts[-1] * 2 <= ndev_all:
            counts.append(counts[-1] * 2)
        if counts[-1] != ndev_all:
            counts.append(ndev_all)
    if args.device != "cpu" and max(counts) > ndev_all:
        raise SystemExit(f"--device-counts {max(counts)}: this host has {ndev_all} cards")

    rows, per_chip = [], {}
    for ndev in counts:
        r = bench_count(ndev, args.device, args.core, args.cols_per_device, args.iters,
                        args.reps, args.profile)
        cols_s = r["ncol"] / r["s_per_iter"]
        per_chip[ndev] = cols_s / ndev
        row = {**r, "cols_per_s": cols_s, "cols_per_s_per_chip": per_chip[ndev],
               "core": args.core, "inputs": "synthetic"}
        rows.append(row)
        print(json.dumps(row), flush=True)
    eff = {str(n): per_chip[n] / per_chip[counts[0]] for n in counts}
    summary = {
        "metric": "multichip_cols_per_s_per_chip", "value": per_chip[counts[-1]],
        "unit": "cols/s/chip (LW+SW)", "n_devices": counts[-1], "core": args.core,
        "weak_scaling_efficiency": eff, "inputs": "synthetic",
        "backend": "cuda" if args.device != "cpu" else "cpu",
        "device": torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu",
    }
    rows.append(summary)
    print(json.dumps(summary), flush=True)
    return rows


if __name__ == "__main__":
    main()
