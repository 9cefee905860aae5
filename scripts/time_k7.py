#!/usr/bin/env python3
"""Time the LW no-scattering transport (K7, csrc/lw_noscat.cu) of one tree
of this repository on one NVIDIA GPU, as its callers reach it.

    python3 scripts/time_k7.py [--tree DIR]

``--tree`` is the root of the checkout whose package is imported and built
(default: this one), so that the same command times another commit (a
``git archive`` of it unpacked into a directory) in the same process
layout. On seeded random fields at 60 layers, 1800 and 7200 columns, 128 and
256 g-points it times, with chip_smoke.cuda_ms's rule (median of 25 samples
of 10 back-to-back calls, CUDA events):
  - ``k7 1 angle``: the one-angle wrapper ``lw_noscat_broadband`` with a
    (column, g-point) tensor of secants, as chip_smoke.py phase 8 calls it;
  - ``solver N angles``: ``ops.lw_solver.lw_solver_noscat(...,
    n_gauss_angles=N, broadband=True)``, the call of the general LW core and
    the lookup-table ``rte_lw``, host prep included (N = 1, 3);
  - ``sweeps``: the two sweeps on layer-major (trans, src_dn, src_up)
    fields, the prep core's second half, by the tree's route (the kernel's
    fields mode where the tree has it, else PyTorch ops; 128 g-points).
Beside each: its largest difference from the plain twin on the same
inputs (W/m2), the least time the card could take (every input read and
output written once at 3.35 TB/s, or chip_smoke.ELEMENT_FLOPS["k7"] per
(cell, g-point, angle) at 67 TFLOP/s) and the share of it. Then the K7
kernels' registers and spill from the build's ptxas output and, for the
tree's launch plans, the blocks per SM of the runtime's occupancy call
(where the tree has it; else the occupancy rule on threads and registers).
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

import numpy as np

PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12  # NVIDIA H100 SXM data sheet
K7_FLOPS = 20  # per (cell, g-point, angle): chip_smoke.ELEMENT_FLOPS["k7"]
NLAY, SEED = 60, 0


def cuda_ms(fn, reps=25, batch=10, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / batch)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3


def angles_plain(k7, args, n):
    """The plain twin of an n-angle broadband solve: the one-angle twin per
    Gauss angle, summed in angle order (both trees have it)."""
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import GAUSS_DS, GAUSS_WTS

    up = dn = 0
    for i in range(n):
        u, v = k7.lw_noscat_broadband_plain(*args, float(GAUSS_DS[n - 1, i]),
                                            float(GAUSS_WTS[n - 1, i]))
        up, dn = up + u, dn + v
    return up, dn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("time_k7: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    assert str(build.PKG_DIR).startswith(tree), f"imported {build.PKG_DIR}, not from {tree}"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"time_k7: tree {tree}; {card}; torch {torch.__version__}")
    build.library()
    dev, f32 = torch.device("cuda", 0), torch.float32
    has_fields = hasattr(k7, "lw_broadband_sweeps_kernel")
    rng = np.random.default_rng(SEED)
    for ncol in (1800, 7200):
        for ngpt in (128, 256):
            t = lambda *shape, lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=f32,
                                                       device=dev)
            args = (t(ncol, NLAY, ngpt, lo=1e-4, hi=3.0), t(ncol, NLAY, ngpt, lo=0.1, hi=1.0),
                    t(ncol, NLAY + 1, ngpt, lo=0.1, hi=1.0), t(ncol, ngpt, lo=0.8, hi=1.0),
                    t(ncol, ngpt, lo=0.1, hi=1.0))
            field_bytes = sum(a.numel() * 4 for a in args) + 2 * ncol * (NLAY + 1) * 4
            cells = ncol * NLAY * ngpt
            d = torch.full((ncol, ngpt), plw.LW_DIFFUSIVITY, dtype=f32, device=dev)
            calls = {"k7 1 angle": (lambda: k7.lw_noscat_broadband(*args, d, plw.LW_WEIGHT),
                                    lambda: k7.lw_noscat_broadband_plain(*args, d, plw.LW_WEIGHT),
                                    field_bytes + d.numel() * 4, 1)}
            for n in (1, 3):
                solve = lambda n=n: plw.lw_solver_noscat(*args, n_gauss_angles=n, broadband=True)
                calls[f"solver {n} angle(s)"] = (
                    lambda s=solve: tuple(s()[:2]),
                    lambda n=n: angles_plain(k7, args, n), field_bytes, n)
            if ngpt == 128:
                lay = lambda *shape: t(NLAY, *shape, lo=0.0, hi=1.0)
                fields = (lay(ncol, ngpt), lay(ncol, ngpt), lay(ncol, ngpt), args[3], args[4])
                sweeps = k7.lw_broadband_sweeps_kernel if has_fields else plw.lw_broadband_sweeps
                calls["sweeps"] = (lambda: tuple(sweeps(*fields)[:2]),
                                   lambda: tuple(plw.lw_broadband_sweeps(*fields)[:2]),
                                   sum(a.numel() * 4 for a in fields) + 2 * ncol * (NLAY + 1) * 4,
                                   0)
            for name, (fn, twin, nbytes, nang) in calls.items():
                got = fn()
                torch.cuda.synchronize()
                ref = twin()
                err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
                ms = cuda_ms(fn)
                b = bound_ms(nbytes, K7_FLOPS * cells * max(nang, 1))
                print(f"time_k7 {name} {ncol}x{NLAY}x{ngpt}: {ms:.4f} ms, bound {b:.4f} ms "
                      f"(share {b / ms:.3f}), max|call-twin| {err:.3e} W/m2 | {card}")
            del args, d, calls
    log = build.BUILD_INFO.get("log", "")
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name, _, rest = block.partition("'")
        if "noscat" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rest)
        print(f"time_k7 ptxas {name}: {regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} B spill stores/loads")
    if hasattr(k7, "lw_noscat_plan"):
        smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        for mode, nang, ngpt in (("angles", 1, 128), ("angles", 3, 128), ("angles", 1, 256),
                                 ("angles", 3, 256), ("fields", 1, 128)):
            plan = k7.lw_noscat_plan(NLAY, ngpt, nang, smem)
            blocks = build.blocks_per_sm("lw_noscat_broadband", plan, k7.MODE_CODES[mode], 0)
            print(f"time_k7 geometry {mode} {nang} angle(s) {NLAY}x{ngpt}: {plan}, {blocks} "
                  f"block(s) per SM by the occupancy call")
    else:
        res = build.kernel_resources("lw_noscat_kernel")
        for ngpt in (128, 256):
            threads, smem = ngpt, 4 * 2 * (NLAY + 1) * (ngpt // 32)
            regs = res.get("registers", 0)
            by_regs = 65536 // (-(-regs * 32 // 256) * 256 * (threads // 32)) if regs else 0
            blocks = min(2048 // threads, 32, by_regs, 233472 // (smem + 1024))
            print(f"time_k7 geometry (one block per column) {NLAY}x{ngpt}: {threads} threads, "
                  f"{smem} B shared memory, {regs} registers, {blocks} block(s) per SM by the "
                  "occupancy rule (threads, registers, shared memory)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
