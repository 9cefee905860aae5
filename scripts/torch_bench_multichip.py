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
PyTorch operators per call; beside it the weak-scaling efficiency on the
slowest rank's device-busy time (busy at the first count over busy at N),
which host noise does not reach.

The inputs are synthetic (``testing.synthesize_rfmip(1800, 60, 0)`` tiled
to the column count as ``bench_multichip._replicate_block`` tiles the RFMIP
file) with the in-repo demo nets, and the JSON says so; ``--lw-model`` and
``--sw-models`` take other nets of the g-128 LW and g-112 SW mappings (as
bench_multichip.py fixes them): nets that fit neither are refused with a
ValueError before any rank is spawned (utils/bench.load_nets). Each rank
is pinned to its own disjoint set of host cores (``os.sched_setaffinity``,
the host's cores split evenly over the largest count's ranks, the same
share at every count; ``torch.set_num_threads`` to match). One pass: a barrier,
CUDA events around ``--iters`` back-to-back LW + SW calls, the best of
``--reps`` samples, the slowest rank's. Each count runs ``--passes``
passes in one launch of its ranks; every pass's per-card rate and
efficiency (its per-card rate over the first count's median) is reported
with the median and quartiles over the passes. Every count, 1 included,
spawns its ranks, so that every count is timed in processes of one kind.

    python scripts/torch_bench_multichip.py --device-counts 1 --core mega
    python scripts/torch_bench_multichip.py --device-counts 1,2,4 --core mega --profile
    python scripts/torch_bench_multichip.py --device cpu --device-counts 1,2 --cols-per-device 64 --iters 2

Prints one JSON line per count and a summary line (metric
multichip_cols_per_s_per_chip, the median over the passes at the last
count, with the efficiency table inside).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
import torch.distributed as dist

from rte_rrtmgp_nn_tpu_torch.parallel import distributed
from rte_rrtmgp_nn_tpu_torch.utils import bench

ENTRY = "torch_bench_multichip.py"

def _replicate_block(data, ncol_target: int):
    """Tile the base batch up or down to exactly ``ncol_target`` columns."""
    return bench.replicate_rfmip(data, -(-ncol_target // data.ncol)).block(0, ncol_target)


def core_sets(ndev_max: int) -> list[list[int]]:
    """The host's cores (this process's affinity) split into ``ndev_max``
    disjoint, equal, contiguous sets: rank r of any count takes set r."""
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // ndev_max)
    return [cores[r * k:(r + 1) * k] or cores[-k:] for r in range(ndev_max)]


def pin(cores: list[int]) -> None:
    """Pin this process to ``cores`` and give PyTorch's CPU ops as many
    threads."""
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))


def pass_stats(rates: dict) -> dict:
    """Weak-scaling statistics of per-card rates ``rates`` ({device count:
    [one rate a pass]}, the first count first): per count the per-card rate
    and the efficiency of each pass (its rate over the first count's
    median rate), each with quartiles() beside the passes."""
    first = bench.quartiles(rates[next(iter(rates))])["median"]
    out = {}
    for n, rs in rates.items():
        eff = [r / first for r in rs]
        out[n] = {"per_chip": {"passes": list(rs), **bench.quartiles(rs)},
                  "efficiency": {"passes": eff, **bench.quartiles(eff)}}
    return out


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


def rank_bench(core: str, cols_per_device: int, iters: int, reps: int, nets: tuple,
               profile: bool = False, passes: int = 1, cores=None) -> dict:
    """This rank's part of one device count: pin to ``cores[rank]`` (when
    given), build the inputs, warm up, and time ``passes`` passes; returns
    each pass's slowest-rank best seconds per LW + SW call, and with
    ``profile`` every rank's profiler window (``profile_window``). ``nets``:
    (the LW net's file, the two SW nets' files)."""
    if cores is not None:
        pin(cores[dist.get_rank()])
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding, make_mesh
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    ndev = dist.get_world_size()
    mesh = make_mesh(n_col=ndev)
    dev = mesh.devices[0]
    ncol = cols_per_device * ndev
    data = _replicate_block(rfmip_data_from_arrays(synthesize_rfmip(1800, 60, 0)), ncol)
    lw_models, sw_models, specs = bench.load_nets(ENTRY, *nets, dev)
    lw_spec, sw_spec = specs["lw"], specs["sw"]
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
        bests = []
        for _ in range(passes):
            best = float("inf")
            for _ in range(reps):
                dist.barrier()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stop = _clock(dev)
                for _ in range(iters):
                    call()
                best = min(best, stop() / iters)
            bests.append(best)
    slowest = torch.tensor(bests, dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    out = {"n_devices": ndev, "ncol": ncol, "s_per_iter": slowest.tolist(),
           "cores": len(os.sched_getaffinity(0))}
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
                reps: int, nets: tuple, profile: bool = False, passes: int = 1,
                cores=None) -> dict:
    """One device count on ``ndev`` spawned ranks (one as well: every count
    is timed in processes of the same kind)."""
    return distributed.launch(rank_bench, ndev, core, cols_per_device, iters, reps, nets,
                              profile, passes, cores, device=device, timeout_s=900)[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cols-per-device", type=int, default=1824)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--passes", type=int, default=5,
                    help="timed passes a device count, in one launch of its ranks")
    ap.add_argument("--device-counts", type=str, default="",
                    help="comma list; default 1,2,4,...,N")
    ap.add_argument("--core", choices=["staged", "mega"], default="staged",
                    help="mega = the fused cores (K1, K2) split over 'col'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (gloo ranks)")
    ap.add_argument("--lw-model", default=bench.LW_MODEL,
                    help="LW net, a g-128 one (default the demo net)")
    ap.add_argument("--sw-models", nargs=2, default=[bench.SW_MODEL, bench.SW_MODEL],
                    metavar=("ABSORPTION", "RAYLEIGH"),
                    help="SW nets, a g-112 pair (default the SW demo net as both)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timing, a torch.profiler window on every rank (CUDA only)")
    args = ap.parse_args(argv)
    # the nets are checked against the mappings here, before any rank is spawned
    bench.load_nets(ENTRY, args.lw_model, args.sw_models, "cpu")
    nets = (args.lw_model, tuple(args.sw_models))
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

    cores = core_sets(max(counts))
    rows, rates, busy = [], {}, {}
    for ndev in counts:
        r = bench_count(ndev, args.device, args.core, args.cols_per_device, args.iters,
                        args.reps, nets, args.profile, args.passes, cores)
        rates[ndev] = [args.cols_per_device / s for s in r["s_per_iter"]]
        row = {**r, "cols_per_s_per_chip": rates[ndev], "core": args.core,
               "inputs": "synthetic"}
        if args.profile:
            busy[ndev] = max(w["busy_ms"] for w in r["profile"])
            row["busy_ms_slowest_rank"] = busy[ndev]
        rows.append(row)
        print(json.dumps(row), flush=True)
    stats = pass_stats(rates)
    eff = {str(n): st["efficiency"] for n, st in stats.items()}
    summary = {
        "metric": "multichip_cols_per_s_per_chip",
        "value": stats[counts[-1]]["per_chip"]["median"],
        "unit": "cols/s/chip (LW+SW)", "n_devices": counts[-1], "core": args.core,
        "passes": args.passes, "per_chip": {str(n): st["per_chip"] for n, st in stats.items()},
        "weak_scaling_efficiency": eff, "inputs": "synthetic",
        "cores_per_rank": len(cores[0]),
        "backend": "cuda" if args.device != "cpu" else "cpu",
        "device": torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu",
    }
    if args.profile:
        summary["device_time_efficiency"] = {str(n): busy[counts[0]] / b
                                             for n, b in busy.items()}
    rows.append(summary)
    print(json.dumps(summary), flush=True)
    return rows


if __name__ == "__main__":
    main()
