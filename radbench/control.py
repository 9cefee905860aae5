#!/usr/bin/env python3
"""The readings the output check's limits are set from, on the card at a
cell's own size:

  - the program's: per seed, one call of the timed path on every input
    state after a warm-up, each compared with the float64 reference as a run
    compares its window's calls (the lower readings);
  - the control's: the reference put in the program's place, computed in
    float32 with TF32 products, compared alike (the upper readings; the
    configurations state float32 with TF32 off).

    python3 radbench/control.py --workload <cell> --seeds 1 2 3 [--control-seeds 1 2 3]

One JSON line a seed and side; the last line the largest reading of each
number over the seeds, by side. The benchmark's runs do not run it.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def readings(name: str, seeds, control_seeds, device, overrides=None, out=print) -> dict:
    """{"program": {check: largest over seeds}, "control": {...}} for the
    cell ``name`` (``overrides`` as harness.run_cell)."""
    import json

    import numpy as np
    import torch

    from radbench import harness
    from radbench.reference import physics as P

    _, config, workload, _ = harness.find_cell(name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    workload = {**workload, **overrides.get("workload", {})}
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = harness.entry_module(config)
    worst = {"program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        with torch.no_grad():
            cell = mod.setup(config, workload, seed, device, ROOT)
            sides = {}
            if seed in seeds:
                log = []
                for k in range(cell.n_states):  # warm-up
                    harness._one(cell, k, log)
                sides["program"] = [(k, harness._one(cell, k, log), 0, 0)
                                    for k in range(cell.n_states)]
                if log:
                    print(log[0], file=sys.stderr)
            cell.free_program()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if seed in control_seeds:
                sides["control"] = [(k, cell.reference(k, P.CONTROL, device), 0, 0)
                                    for k in range(cell.n_states)]
            for side, calls in sides.items():
                got = harness.check(cell, calls, workload["limits"], device)
                for c, v in got.items():
                    worst[side][c] = max(worst[side].get(c, 0.0), v["value"])
                out(json.dumps({"workload": name, "seed": seed, "side": side,
                                **{c: v["value"] for c, v in got.items()}}))
        del cell
    out(json.dumps({"workload": name, "largest": worst,
                    "limits": workload["limits"]}))
    return worst


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.control_seeds, torch.device("cuda", 0),
             out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
