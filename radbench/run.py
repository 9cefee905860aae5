#!/usr/bin/env python3
"""The benchmark of rte_rrtmgp_nn_tpu_torch: one run of one cell on the card.

    python3 radbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (calls in the window), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
profiled window), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number the output check compared, beside its limit. The same
numbers end standard error. Exits 2 without enough cards, and with another
code than 0, printing no result, where a forbidden module was loaded or the
program is missing. See harness.py for what runs.
"""
from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
# the program's build and kernel caches stay in the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def main(argv=None) -> int:
    import argparse
    import json
    import subprocess

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from radbench import harness

    cell, _, _, _ = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); {have} found", file=sys.stderr)
        return 2
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not measured"
    print(f"card: {card}", file=sys.stderr)
    # one intra-op thread: the load comes from one process; with the default
    # pool of a thread a core, runs of rfmip-clearsky.c1800 on an H100 host
    # shared with others spread 7.5% in columns_per_s, with one 1.6%
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              T_START)
    result["device"]["power_limit"] = card.split(", ")[-1] if ", " in card else card
    check = result.pop("check")
    result["check"] = check  # the last key
    for line in harness.summary_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
