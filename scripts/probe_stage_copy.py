#!/usr/bin/env python3
"""How fast the host fills one staging slot of a GCM block, by the number of
copy threads: the rate that sets ``parallel/streaming.py``'s pool.

    python3 scripts/probe_stage_copy.py [--columns 43200] [--fills 24]

The host arrays are the ``gcm-allsky-025deg.step`` cell's f32 fields at its
sizes (1,480 bytes a column: six profiles of 60 or 61 floats, eight
per-column lanes), three blocks of them, so that each fill reads its source
from memory as a sweep does; the slot is pinned where there is a card and
pageable otherwise. For 1, 2, 4 and 8 threads (each no more than the cores
this process may run on) it fills the two slots of a ring in turn,
``--fills`` times, with ``streaming._fill_pooled`` (one thread: the copy on
the calling thread) and prints the median ms a fill and GB/s. Prints one
JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rte_rrtmgp_nn_tpu_torch.parallel import streaming  # noqa: E402

# (columns, width) of each f32 host array of a step's block: play, plev,
# tlay, tlev, h2o, o3 and the eight per-column lanes
WIDTHS = (60, 61, 60, 61, 60, 60) + (None,) * 8


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=False)
    return q.stdout.strip().splitlines()[0] if q.returncode == 0 else torch.cuda.get_device_name()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=43_200)
    ap.add_argument("--fills", type=int, default=24)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    ncol = 3 * args.columns
    arrays = [rng.standard_normal((ncol,) if w is None else (ncol, w)).astype(np.float32)
              for w in WIDTHS]
    layout = streaming._slot_layout(arrays, args.columns)
    pin = torch.cuda.is_available()
    slots = [torch.empty(streaming._slot_bytes(layout), dtype=torch.uint8, pin_memory=pin)
             for _ in range(2)]
    regions = [[v.numpy() for v in streaming._slot_views(b, layout)] for b in slots]
    for r in regions:
        for v in r:
            v.fill(0)  # the pages touched once, as a ring kept across calls has them
    nbytes = sum(a[:args.columns].nbytes for a in arrays)
    cores = len(os.sched_getaffinity(0))
    out = {"card": _card(), "cores": cores, "slot_bytes": nbytes, "pinned": pin, "threads": {}}
    for t in (1, 2, 4, 8):
        if t > cores:
            continue
        pool = ThreadPoolExecutor(t) if t > 1 else None
        times = []
        for i in range(args.fills):
            k = i % 3
            parts = [a[k * args.columns:(k + 1) * args.columns] for a in arrays]
            dst = regions[i % 2]
            t0 = time.perf_counter()
            if pool is None:
                for r, a in zip(dst, parts):
                    np.copyto(r, a)
            else:
                streaming._fill_pooled(dst, parts, pool, t)
            times.append(time.perf_counter() - t0)
        if pool is not None:
            pool.shutdown()
        ms = statistics.median(times[2:]) * 1e3
        out["threads"][t] = {"ms": ms, "gb_per_s": nbytes / ms * 1e-6,
                             "ms_min": min(times[2:]) * 1e3, "ms_max": max(times[2:]) * 1e3}
        print(f"threads {t}: {ms:.3f} ms a fill, {nbytes / ms * 1e-6:.2f} GB/s", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
