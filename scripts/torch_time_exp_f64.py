"""The CPU cost of the float64 transmittance's exponential.

``ops/lw_solver.transmittance`` takes a float64 tensor on the CPU through
``ops/expfast.exp_rational_f64`` (XLA's rounding of exp, fused
multiply-adds emulated) instead of ``torch.exp``. This times both on
optical paths of the sizes given (elements of an (ncol, nlay, ngpt) field;
the defaults: the float64 parity tests' 3 x 8 columns x 16 layers x 64
g-points, 64 columns x 60 layers x 256 g-points, and 1800 x 60 x 128),
the best of ``--reps`` calls each, and prints the ratio.

    python scripts/torch_time_exp_f64.py [--sizes 24576,983040] [--reps 5]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from rte_rrtmgp_nn_tpu_torch.ops.expfast import exp_rational_f64


def best_ms(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=f"{24 * 16 * 64},{64 * 60 * 256},{1800 * 60 * 128}")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        tl = torch.as_tensor(np.exp(np.random.default_rng(0).uniform(np.log(1e-12), np.log(50.0), n)))
        xla = best_ms(lambda: exp_rational_f64(-tl), args.reps)
        lib = best_ms(lambda: torch.exp(-tl), args.reps)
        rows.append((n, xla, lib))
        print(f"float64 exp of {n} elements on the CPU ({torch.get_num_threads()} threads): "
              f"exp_rational_f64 {xla:.3f} ms, torch.exp {lib:.3f} ms, ratio {xla / lib:.1f}")
    return rows


if __name__ == "__main__":
    main()
