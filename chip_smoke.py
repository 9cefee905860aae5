#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at RFMIP size, 1800 columns x 60 layers, and the
GCM sweep at 1,036,800 columns, through its hand-written CUDA kernels, and
checks them. Phases (any failure exits
non-zero and prints no result line):

  1. environment: torch / CUDA / nvcc versions, the card and its power
     limit; TF32 off for matmuls and convolutions;
  2. build: nvcc compiles rte_rrtmgp_nn_tpu_torch/csrc/*.cu for sm_90a;
  3. K1 (lw_clearsky_mega4) against its plain PyTorch twin on the card,
     and both against the twin in float64;
  4. K2 (sw_clearsky_megakernel) likewise; night columns zero after the core;
  5. the fused main path: rfmip_clear_sky_lw / _sw in both vertical
     orientations (K1, K2), with the kernels' launch counts set to 0 just
     before and read just after; outputs finite, (ncol, nlay+1), SW TOA
     down flux = TSI * mu0 on day columns, the orientations mirror;
  6. timing of the fused path with CUDA events after warm-up (the median
     of 25 samples, each 10 back-to-back calls): K1, K2, their plain twins
     and the fused cores on device-resident inputs; both fused drivers on
     the host clock;
  7. the MLP kernel against its twins on the full-size NN inputs
     (108,000 rows): K3 (fused_predict_lw_both) with the LW demo net and a
     seeded 8-layer net using all seven activations, K4 (fused_predict_tau)
     with the demo net's tau half, K5 (fused_predict_sw) with the SW demo
     net as both nets and with the matched synthetic absorption/Rayleigh
     pair; beyond the bound float64 decides (testing.hold_kernel);
  8. K7 (lw_noscat_broadband) against its twins on the optical depths and
     sources gas_optics_lw_nn makes at 1800 x 60 x 128: the angles mode for
     1-4 Gauss angles in one launch each, with and without an incident
     flux; one angle with per-(column, g-point) secants and an incident
     radiance; the fields mode on the layer-major transmittance and
     sources of the same fields;
  9. the general main path, each call driven with the kernels' launch
     counts set to 0 just before and read just after:
     rfmip_clear_sky_lw with 3 Gauss angles in both orientations (K3 once
     and K7 once for all three angles per call); single-angle LW without the megakernel,
     two-model (K4, then K7) and one-model (K3, then K7), equal to each
     other and to the K1 path; rfmip_clear_sky_sw without the megakernel
     (K5) held against the same path in float64 within 2e-2 W/m2 in every
     column (its two-stream coefficients are float64, as K2's: no column
     near the resonance k*mu0 = 1 is excepted); then a small
     input through both paths on CUDA against the same paths in float64
     on the CPU;
 10. timing of K3, K4, K5, K7 (one angle, three angles, fields mode) and
     their twins, the general LW core (3 angles) and the staged SW core,
     and the fused cores once more;
 11. the cloud modes of K1 and K2 (lookup tables inside the kernel; band
     lanes) and their lane input modes (K8: lw_clearsky_mega5 on raw lanes;
     K9: sw_clearsky_megakernel(input_mode="lanes")) against their twins on
     the same atmosphere with the all-sky driver's cloud placement; the
     share of liquid, ice and mixed cells is printed and none may be 0;
     then K8 through its core (_lw_core_mega5) and K9 through its wrapper
     with the counts read around: no driver routes to these two modes;
 12. the all-sky main path: a synthetic Garand file and lookup-table and
     Pade coefficient files for LW and SW are written to a temporary
     directory, then allsky_lw / allsky_sw run on the card for both
     flavours on the fused route (one launch of K1 or K2 in its cloud mode,
     nothing else) and on the staged routes (3 Gauss angles: K3 once, K7
     once; megakernel off: K3 + K7, K5), each with the counts set to
     0 just before and read just after; finite fluxes, fused against staged
     and against float64 on the CPU, more LW down and less direct SW at the
     surface under clouds, SW TOA down = sum(solar) * mu0;
 13. timing of the cloud modes, K8, K9, their twins and the all-sky cores
     on both routes;
 14. K6 (lw_prep) against its twin on the full-size inputs: the
     transmittance and the three sources by the MLP kernel's rule (beyond
     the bound float64 decides), then the broadband sweeps on the kernel's
     and on the twin's fields; its time, its twin's and its bound;
 15. the prep LW core (_lw_core_prep: K6, then K7's fields mode) in both
     orientations with every count set to 0 just before and read just
     after (one K6 launch and one K7 launch, no other kernel), against the fused LW driver
     and, at 64 columns, against float64 on the CPU; no driver routes to
     this core, in the JAX package neither;
 16. parallel scans: rfmip_clear_sky_lw / _sw with scan_mode="parallel"
     against the sequential requests (and, inside phase 12, allsky_lw /
     allsky_sw likewise), launch counts held;
 17. the lookup-table gas optics: synthetic LW (256 g-points) and SW (224)
     k-distribution files are written to a temporary directory and loaded
     onto the card; gas_optics_lw_lut -> rte_lw (1 and 3 Gauss angles and
     the optimal-angle secants: the transport kernel once per solve, counted; the
     two-stream and the rescaled solve after a cloud increment) and
     gas_optics_sw_lut -> rte_sw at 1800 x 60, each stage timed; SW TOA down
     = sum(solar) * mu0; the LW heating rate; then 64 columns on the card
     against the same calls in float64 on the CPU;
 18. the fused kernels' geometry: K1 and K2 in all four modes at two ragged
     sizes (37 columns x 13 and x 61 layers: no layer group and no MLP pass
     of the kernels is full) against their twins; each mode's launch plan
     (threads, shared memory), what ptxas reported for it (registers, spill)
     and the blocks per SM the CUDA runtime's occupancy call gives for the
     loaded function; K2's time at a quarter, half and all of the layers
     (7200 columns, so that the card and not the host is read), for the
     share of its time that grows with the layers (the coefficients, the
     sweeps and the level sums: the nets run one pass at all three);
 19. K3-K7's launch plans, ptxas counts and blocks per SM as in phase 18,
     and their times at 7200 columns (a kernel under 0.3 ms at 1800
     columns reads the host); K7 for one angle, three angles and the
     fields mode, each beside its bound there;
 20. the GCM sweep (drivers/gcm.py): 1,036,800 columns x 60 layers
     (synthesize_gcm_columns over the RFMIP-size atmosphere, the gases a
     Garand file carries) in 18 blocks of 57,600: gcm_sweep_allsky with
     lookup-table clouds streamed (twice: the first sweep also allocates
     its pinned buffers), resident and in mixed precision, gcm_sweep_lw
     streamed and resident, each counted sweep with the launch counts set
     to 0 just before and read just after (one K1 and one K2 launch a
     block on the fused route, nothing else); streamed equal to resident
     bit for bit, mixed within 0.05 W/m2 of f32, night SW exactly 0, the
     first 1800 columns within 1e-4 W/m2 of allsky_lw / allsky_sw on a
     Garand file of the same columns; one block's copy from pinned memory
     (GB/s); one streamed sweep under torch.profiler (the device's idle
     share, K1 + K2 a block against the block's window); at 115,200
     columns Pade clouds (K1 and K2 in the cld_bands mode) and the staged
     route (K3 + K7, K5; its SW within 2e-2 W/m2 of the fused route in
     every column); 100,000 columns with a ragged last block against one block.
     The kernels' calls at the GCM's own shapes are kept (kept_calls) and
     held against their plain twins on the card on the same tensors (the
     twins 14,400 columns a call): K1 and K2 cld_lut on block 0 (57,600
     columns) of the 1,036,800-column sweep and on the ragged last block
     (42,400) of the 100,000-column one, K1 clear on block 0 of the LW
     sweep, K1 and K2 cld_bands on a Pade block, and K3, K7 and K5 on both
     blocks of the staged route's 100,000-column sweep.
     "gcm ..." lines, each with the card's name and power limit;
 21. NN training with radiation-in-the-loop evaluation (training/*, the
     recipe of scripts/torch_train_from_lut.py): the LUT LW gendata on a
     synthetic 64-g-point k-distribution at 18 experiments x 100 sites x
     60 layers on the card (K7 once), against float64 on the CPU; a fresh
     "lw_both" net 7 -> 128 -> 128 -> 128 trained for 3 epochs of 50 steps
     of 1024 experiment pairs (Adam, cosine decay, hybrid loss 0.85, EMA
     0.999) by train_with_radiation_eval, each epoch's eval counted (K3
     once, K7 once); the step time by CUDA events, the eval and gendata
     times; after the last step K3 and K7 on the eval's inputs against
     their twins, K1 through rfmip_clear_sky_lw on the trained net against
     its twin and against the same weights loaded fresh (0 W/m2), the best
     model saved and reloaded (bit-identical fluxes), five float32 steps
     on the card against the CPU's, and K3 refusing trainable weights with
     grad enabled. "training ..." lines;
 22. the column split over ranks (parallel/distributed.py): (a) a process
     group of one on NCCL in this process, lw_mega_core_sharded and
     sw_mega_core_sharded on the main path's inputs against the unsharded
     fused cores (0 W/m2: the launch plans do not depend on the columns),
     K1 and K2 counted once a call, both timed; (b) two ranks spawned on
     the one card (gloo: NCCL takes one rank a card), each rank's block and
     the gathered fluxes against (a), K1 and K2 once a rank a call; (c) the
     dry run's three stages on the same two ranks
     (scripts/torch_dryrun_multichip.py: the training step with the
     gradients averaged by all_reduce, the g-point-split staged forward,
     K3 + K7 a rank, held against the fused core over 'col', K1);
     (d) scripts/torch_bench_multichip.py at one card, --core mega (with
     --profile: device busy and idle share) and --core staged, 1824
     columns a card (its JSON lines). "sharded ...",
     "dryrun ..." lines;
 23. SW training from the lookup table (scripts/torch_train_from_lut_sw.py
     on training/lut_recipe, cut as phase 21): the LUT SW gendata on a
     synthetic 56-g-point k-distribution on the card, fresh absorption and
     Rayleigh nets 7 -> 128 -> 128 -> 56 trained jointly for 3 epochs of 50
     steps, each day-masked eval counted (K5 once), the step, eval and
     gendata times, K5 against its twin after the steps, both best nets
     saved and loaded back (bit-identical fluxes). "training-sw ..." lines;
 24. the command-line entry points (scripts/torch_run_rfmip.py,
     torch_run_allsky.py, torch_eval_rfmip.py, torch_run_regression.py)
     through their main() on the card and with --device cpu, on an RFMIP
     file of 18 experiments x 100 sites x 60 layers (testing.write_rfmip_file),
     phase 12's all-sky files at 1800 columns and the stand-in nets under
     the reference's BEST names: the card's output files against the CPU
     run's (LW 2e-3, SW 2e-2 W/m2, float64 deciding beyond; the CPU's
     SW of both, the regression's too), the eval's
     metric block, every regression check at --fail-tol 1e-5 on the card
     and the regression's 28 fields; the launches around each run
     (K1 1 and K2 1; K1 and K2 cld_lut once a loop; K1 1; K7 once a LUT LW
     solve) and its host seconds; then lw_solver_noscat_lay_major's K7
     route (per-(column, g-point) secants, an incident flux) against its
     PyTorch path on the card, both timed. "cli ..." lines;
 25. the last scripts of the JAX package (scripts/torch_train_demo.py,
     torch_train_demo_sw.py, torch_calibrate_sw_g112.py,
     torch_calibrate_sw_solar.py) through their run() / main() on the card
     and with --device cpu, on phase 24's RFMIP file, the stand-in teachers,
     a 224-output SW net made from the seed as the g-224 net and phase 12's
     Garand and SW lookup-table cloud files: the demos at their default
     widths, cut to 3 epochs of 50 steps, card and CPU from one saved
     student (each epoch's metrics within LW 2e-3 / SW 2e-2, the best epoch,
     the saved file's name), the g-112 weights within 1e-4, the solar
     fractions within 1e-4 at targets positive fractions reach; the
     launches around each (K1 1, K3 and K7 once an eval; K5 once an eval
     and once; K4 2; K2 cld_lut 14) and its host seconds; K4 on the 112-
     and 224-output nets and K2 cld_lut on each single-band source against
     their twins, K2 on a zero source exactly 0 and linear in its source.
     "demos ..." lines;
 26. the benchmark entry points through their main() on the card:
     bench_torch.py (the fused cores, then --core staged),
     scripts/torch_bench_allsky.py at 1800 and 28,800 columns and
     scripts/torch_bench_gcm.py streamed and --resident (cut to 230,400
     columns in 4 blocks of 57,600: phase 20 sweeps all 1,036,800), each
     with the counts set to 0 just before and read just
     after: K1 and K2 once a core or driver call (clear; cld_lut for
     all-sky), K3 + K7 and K5 once a call staged, K1 and K2 cld_lut and K1
     clear once a GCM block (with the warm-up block and the one block of the
     output check); each must exit 0 with "correct": true (the card's
     fluxes against the port's float64 CPU run). Their JSON lines, then
     "bench ..." lines and the phase's seconds; each SW line with
     "sw_f1_columns": 0; then each entry, scripts/torch_bench_multichip.py
     too, handed the 128_128 sw-synth56-lut pair (56 g-points) and
     bench_torch.py the one-net 64-g-point lw-synth64-lut net: each must
     refuse it with the ValueError naming the mapping it takes, no kernel
     launched around the call ("bench refuses ..." lines);
 27. the SW main path on a real absorption + Rayleigh pair ("sw-pair"
     lines): the in-repo sw-synth56-lut nets of hidden widths 128_128 on
     the synthetic 56-g-point SW k-distribution they were trained on
     (testing.sw_pair_setup, written to a temporary directory), 1800 x 60
     from the seed, where ssa spans [0, 1]: its ssa quantiles and the
     cells within 1e-3 of the two-stream resonance k*mu0 = 1;
     rfmip_clear_sky_sw on the fused route (K2 at 56 g-points, once a
     call) and on the staged route (K5 once a call, then the PyTorch
     sweeps), each counted, each within 2e-2 W/m2 of the port's float64 CPU
     run in every column, no resonance column excepted (every SW route
     takes K2's float64 two-stream coefficients,
     ops/sw_solver.pifm_coefficients); K2 against its twin on the same
     tensors; K2's time, its twin's and its bound at 56 g-points; the
     staged SW core's time and kernel launches a call on the pair and on
     the stand-in;
 28. the all-sky path at the net shapes users run ("allsky-pair" lines):
     P1, a GCM step's recipe without the packing (testing.allsky_pair_setup:
     1800 x 60 columns that all differ, every third column clear, mu0
     clipped to [0.05, 1]; SW on the 128_128 pair at 56 g-points, LW on the
     18 -> 64 -> 64 -> 256 net; synthetic cloud coefficients on each
     mapping's bands), in both cloud flavours: the float64 ssa and g
     quantiles and the day cells near k*mu0 = 1; the fused cores (K1, K2
     once each in the cloud mode) and the staged ones (K3 + K7, K5; the
     log-depth adding, K5), counted with every twin raising, each within
     2e-3 (LW) / 2e-2 (SW) W/m2 of the port's float64 CPU run in every
     column; K2 and K1 in both cloud modes against their twins and,
     without clouds, against their clear mode, their times and bounds; P2,
     allsky_lw / allsky_sw on a Garand file with the same nets at 1800 and
     28,800 columns on every route, counted, against float64, and the
     all-sky cores' times at both sizes (the log-depth ones at 1800).

Before the last line one JSON line lists every kernel with its launches and
the call they were counted around ("counted_around": a driver of a main
path, or for K8 and K9 a core or the wrapper, since no driver reaches
them; then the calls of later phases that launch it too, not counted),
its error against the twin, its time, the twin's, and the
least time the card could take (``bound_ms``: bytes moved once over 3.35
TB/s, or operations over 67 TFLOP/s float32, whichever is larger); the
entries of the fused kernels and of K3-K7 also have ``threads``,
``smem_bytes``, ``blocks_per_sm``, ``registers`` and ``spill_bytes``, and
K3-K7's ``ms_wide``, the time of a call at 7200 columns (K7's also
``bound_ms_wide``). K7 has three entries: one angle, three angles in one
launch ("[angles]") and the fields mode ("[fields]").

The models are the repository's in-repo stand-ins (artifacts/): the g-128
LW demo net (and its 64-wide sibling in phase 28); the g-112 SW absorption
demo net, used as both the absorption and the Rayleigh net; the matched
synthetic 56-g-point SW pair. Atmospheres
and the generic net are synthesized from seeds
(rte_rrtmgp_nn_tpu_torch.testing). The last line of standard output is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

T_IMPORT = time.perf_counter()

NCOL, NLAY, SEED = 1800, 60, 0
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the JAX package's kernel-vs-staged bounds
HERE = os.path.dirname(os.path.abspath(__file__))
LW_MODEL = os.path.join(HERE, "artifacts", "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_MODEL = os.path.join(HERE, "artifacts", "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")
SW_PAIR = [os.path.join(HERE, "artifacts", f"sw-synth56-lut_{k}_128_128_HR_4.22e-02_FRC_1.44e-01.nc")
           for k in ("absorption", "rayleigh")]
CLI_METRIC_ATOL = 2e-3  # the eval metrics card vs CPU: the LW flux bound, which they inherit
MLP_RTOL, SSA_ATOL = 2e-5, 2e-5  # the JAX package's MLP kernel bounds (tests/test_pallas_mlp.py)
N_ANGLES = 3  # Gauss angles of the general LW path
# K6's outputs: the transmittance by the MLP kernel's relative bound, plus an
# absolute 1e-7 (under an ulp of a transmittance near 1) for opaque cells,
# where exp(-tl) carries tl's relative error times tl; the sources, which are
# differences of nearly equal Planck terms, by an absolute bound of 2e-5 times
# the largest g-point Planck source of the run
K6_TRANS_ATOL, K6_SRC_REL = 1e-7, 2e-5
LUT_GPTS_PER_BAND = 16  # the unreduced k-distributions' width: 256 LW, 224 SW g-points
# NVIDIA H100 SXM data sheet: device memory rate and float32 rate outside
# the tensor cores (TF32 and bf16 are excluded by the accuracy contract)
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
# arithmetic per (layer, g-point) after the MLPs, counted from the kernels'
# sources: transmittance, source and sweeps (LW); coefficients, direct beam
# and both adding sweeps (SW); the transport alone (K7, per angle); an MLP
# output's postprocessing (mlp)
# K6: the postprocessing, exp, source factor and both sources, no sweep
# K7's fields mode: the two sweeps' multiply-adds and their level sums
ELEMENT_FLOPS = {"lw": 40, "sw": 110, "k7": 20, "mlp": 10, "k6": 25, "k7_fields": 6}
# what the cloud modes add, counted from csrc/ at the resolution the function
# needs it and only for the cells that hold cloud (the others come out 0):
#   lut_phase: one phase's table lookup per (cell, band): radius index and
#     fraction (6), a lerp per table (3 each: ext, ssa[, asy]), the products;
#   lut_band: per (cell, band) after both lookups: the absorption tau (LW);
#     the phase sums and the delta scaling in its subtraction form (SW);
#   gpt: per (cell, g-point), in both cloud modes: the add to the gas tau
#     (LW); the increment (7) and what the general-g gammas cost beyond the
#     g = 0 ones (9) (SW).
# The band-lane modes get their band values from outside and do "gpt" only.
CLOUD_FLOPS = {"lw": {"lut_phase": 14, "lut_band": 3, "gpt": 1},
               "sw": {"lut_phase": 18, "lut_band": 9, "gpt": 16}}
ALLSKY_MU0 = 0.86  # the all-sky driver's cosine of the solar zenith angle


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def maxabs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps=25, batch=10, warmup=3):
    """Milliseconds per fn() call: the median over ``reps`` samples, each the
    CUDA-event time of ``batch`` back-to-back calls divided by ``batch``
    (utils/bench.cuda_ms, the benchmark entries' timer). The host queues
    ahead of the card, so a call reads its device time unless its host-side
    launches are slower than the card."""
    from rte_rrtmgp_nn_tpu_torch.utils import bench

    return bench.cuda_ms(fn, reps, batch, warmup)["median"]


def adjudicate(name, err, tol, kernel, plain, ref64):
    """Pass when the kernel is within tol of its float32 plain twin; beyond
    it, the float64 twin decides: the kernel passes only if it is at least
    as close to float64 as the float32 twin is (the repository's rule)."""
    if err <= tol:
        return
    ek = max(maxabs(a, b) for a, b in zip(kernel, ref64))
    ep = max(maxabs(a, b) for a, b in zip(plain, ref64))
    print(f"{name}: |kernel - plain| {err:.3e} exceeds {tol}; float64 decides: "
          f"kernel {ek:.3e}, plain {ep:.3e} -> {'kernel' if ek <= ep else 'plain'} closer")
    require(ek <= ep, f"{name} differs from its plain twin by {err:.3e} W/m2 and is "
                      f"further from float64 ({ek:.3e}) than the twin ({ep:.3e})")


def adjudicate_lazy(name, err, tol, kernel, plain, make_ref64):
    """adjudicate with the float64 twin computed only if it has to decide."""
    if err > tol:
        adjudicate(name, err, tol, kernel, plain, make_ref64())


def nbytes(*tensors) -> int:
    """Bytes of the tensors (lists and tuples of tensors are walked; other
    values count 0)."""
    import torch

    n = 0
    for t in tensors:
        if torch.is_tensor(t):
            n += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            n += nbytes(*t)
    return n


def model_bytes(*models) -> int:
    return sum(nbytes(list(m.weights), list(m.biases), m.output_mean, m.output_std)
               for m in models)


def mlp_flops(model, rows: int) -> float:
    """2 * multiply-adds of the net's matrix products over ``rows`` rows."""
    return 2.0 * rows * sum(a * b for a, b in zip(model.dims[:-1], model.dims[1:]))


def cloud_flops(kind: str, mode: str, cld_fields, nband: int, ngpt: int) -> float:
    """Operations a cloud mode ("cld_lut" or "cld_bands") of the LW or SW
    kernel (``kind``) adds to the clear-sky ones on these (lwp, iwp, rel,
    rei) fields: CLOUD_FLOPS over the cells that hold liquid, ice or either."""
    c = CLOUD_FLOPS[kind]
    liq, ice = cld_fields[0] > 0, cld_fields[1] > 0
    n_liq, n_ice, n_any = int(liq.sum()), int(ice.sum()), int((liq | ice).sum())
    ops = c["gpt"] * ngpt * n_any
    if mode == "cld_lut":
        ops += (c["lut_phase"] * (n_liq + n_ice) + c["lut_band"] * n_any) * nband
    return float(ops)


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the peak memory rate, or the operations at the
    peak float32 rate, whichever is larger."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}  # no single PyTorch call computes any of these functions


def hold(name, kernel, twin, twin64, rtol, atol) -> dict:
    """Print and require testing.hold_kernel for one kernel output."""
    from rte_rrtmgp_nn_tpu_torch.testing import hold_kernel

    r = hold_kernel(kernel, twin, twin64, rtol, atol)
    r["max_abs_err"] = maxabs(kernel, twin)
    extra = ""
    if "kernel_f64" in r:
        extra = (f"; beyond the bound, float64 decides: kernel {r['kernel_f64']:.3f}, "
                 f"twin {r['twin_f64']:.3f} of the bound from float64")
    print(f"{name}: max|kernel-twin| {r['max_abs_err']:.3e}, {r['kernel_twin']:.3f} of the "
          f"bound (rtol {rtol}, atol {atol}){extra}")
    require(r["ok"], f"{name} differs from its twin beyond the bound and is further from "
                     f"float64 than the float32 twin allows ({r})")
    return r


def mlp_inputs(dev, data, *models) -> tuple:
    """(col_dry (ncol, nlay), the NN inputs of each model) of an RFMIP-like
    atmosphere: what K3 / K4 / K5 take on the general path."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128

    play, plev, tlay, _, _, _, concs = rfmip.lw_staged_inputs(data, lw_spectral_g128(), dev)
    gases = GasConcs(concs)
    col_dry = go.get_col_dry(gases.get_vmr("h2o", play.shape[0], play.shape[1]), plev)
    return (col_dry,) + tuple(go.compute_nn_inputs(play, tlay, gases, m) for m in models)


def k6_args(dev, data, lw_model, table, lw_spec) -> tuple:
    """lw_prep's arguments (layer-major) on an RFMIP-like atmosphere."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go

    play_t, plev_t, tlay_t, tlev_t, tsfc, _, concs_t = rfmip.lw_canonical_inputs(data, lw_spec, dev)
    gases = GasConcs(concs_t)
    nlay, ncol = tlay_t.shape
    col_dry = go.get_col_dry_lay_major(gases.get_vmr("h2o", nlay, ncol), plev_t).contiguous()
    x = go.compute_nn_inputs(play_t, tlay_t, gases, lw_model).contiguous()
    return (lw_model, x, col_dry, table.interpolate(tlay_t), table.interpolate(tlev_t),
            table.interpolate(tsfc), lw_spec.gpt2band_tensor(dev))


def mlp_phase(dev, lw_model, sw_model, data) -> tuple[dict, dict, dict]:
    """Phase 7: K3/K4/K5 against their twins on the full-size NN inputs.
    Returns (max |kernel - twin| per kernel, the timing closures, each
    kernel's bound at the timed shapes)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, nn_model_from_arrays
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.testing import (
        ALL_ACTIVATIONS, float64_copy, model_arrays, random_gas_optics_net_arrays,
        split_lw_both_arrays)

    pair = [load_model_netcdf(p, device=dev) for p in SW_PAIR]
    col_dry, x_lw, x_sw, x_pair = mlp_inputs(dev, data, lw_model, sw_model, pair[0])
    deep = nn_model_from_arrays(*random_gas_optics_net_arrays(
        (18,) + (128,) * 7 + (256,), ALL_ACTIVATIONS + ("linear",), seed=SEED), device=dev)
    tau_net = nn_model_from_arrays(*split_lw_both_arrays(*model_arrays(lw_model))[0], device=dev)
    cd64 = col_dry.double()
    print(f"MLP inputs: {x_lw.shape[0] * x_lw.shape[1]} rows; nets: LW demo {lw_model.dims}, "
          f"generic {deep.dims} {deep.activations}, tau half {tau_net.dims}, SW demo "
          f"{sw_model.dims}, SW pair {pair[0].dims}")
    errs = {}
    for tag, m in (("demo", lw_model), ("generic", deep)):
        got = mlp.fused_predict_lw_both(m, x_lw, col_dry)
        torch.cuda.synchronize()
        ref = mlp.fused_predict_lw_both_plain(m, x_lw, col_dry)
        ref64 = mlp.fused_predict_lw_both_plain(float64_copy(m), x_lw.double(), cd64)
        e = [hold(f"K3 {tag} {n}", g, r, r64, MLP_RTOL, a)
             for n, g, r, r64, a in zip(("tau", "pfrac"), got, ref, ref64, (1e-8, 1e-9))]
        errs.setdefault("k3", max(x["max_abs_err"] for x in e))
    got = mlp.fused_predict_tau(tau_net, x_lw, col_dry)
    errs["k4"] = hold("K4 tau half", got, mlp.fused_predict_tau_plain(tau_net, x_lw, col_dry),
                      mlp.fused_predict_tau_plain(float64_copy(tau_net), x_lw.double(), cd64),
                      MLP_RTOL, 1e-8)["max_abs_err"]
    for tag, (ma, mr), x in (("demo x2", (sw_model, sw_model), x_sw), ("pair", pair, x_pair)):
        tau, ssa = mlp.fused_predict_sw(ma, mr, x, col_dry)
        rtau, rssa = mlp.fused_predict_sw_plain(ma, mr, x, col_dry)
        tau64, ssa64 = mlp.fused_predict_sw_plain(float64_copy(ma), float64_copy(mr),
                                                  x.double(), cd64)
        big = rtau > 1e-12  # ssa where tau is not an underflow residue
        e = [hold(f"K5 {tag} tau", tau, rtau, tau64, MLP_RTOL, 1e-8),
             hold(f"K5 {tag} ssa", ssa[big], rssa[big], ssa64[big], 0.0, SSA_ATOL)]
        print(f"K5 {tag}: ssa mean {float(ssa.mean()):.4f} std {float(ssa.std()):.4f}")
        errs.setdefault("k5", max(x["max_abs_err"] for x in e))
    timers = {
        "k3": lambda: mlp.fused_predict_lw_both(lw_model, x_lw, col_dry),
        "k3_plain": lambda: mlp.fused_predict_lw_both_plain(lw_model, x_lw, col_dry),
        "k4": lambda: mlp.fused_predict_tau(tau_net, x_lw, col_dry),
        "k4_plain": lambda: mlp.fused_predict_tau_plain(tau_net, x_lw, col_dry),
        "k5": lambda: mlp.fused_predict_sw(sw_model, sw_model, x_sw, col_dry),
        "k5_plain": lambda: mlp.fused_predict_sw_plain(sw_model, sw_model, x_sw, col_dry),
    }
    rows = NCOL * NLAY
    out = lambda m: rows * m.dims[-1] * 4  # bytes of one (rows, n_outputs) float32 result
    post = lambda m: ELEMENT_FLOPS["mlp"] * rows * m.dims[-1]
    bounds = {
        "k3": bound(nbytes(x_lw, col_dry) + model_bytes(lw_model) + out(lw_model),
                    mlp_flops(lw_model, rows) + post(lw_model)),
        "k4": bound(nbytes(x_lw, col_dry) + model_bytes(tau_net) + out(tau_net),
                    mlp_flops(tau_net, rows) + post(tau_net)),
        "k5": bound(nbytes(x_sw, col_dry) + 2 * model_bytes(sw_model) + 2 * out(sw_model),
                    2 * (mlp_flops(sw_model, rows) + post(sw_model))),
    }
    return errs, timers, bounds


def k7_phase(dev, lw_model, table, lw_spec, data) -> tuple[dict, dict]:
    """Phase 8: K7 against its twins on the optical depths and sources
    gas_optics_lw_nn makes: the angles mode for 1-4 Gauss angles in one
    launch, with and without an incident flux; the one-angle call with
    per-(column, g-point) secants and an incident radiance; the fields mode
    on the layer-major transmittance and sources of the same fields. Returns
    (the result entries "k7" (one angle), "k7_angles" (N_ANGLES) and
    "k7_fields": max |kernel - twin| in W/m2 and the bound, the timing
    closures)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    play, plev, tlay, tlev, tsfc, emis_band, concs = rfmip.lw_staged_inputs(data, lw_spec, dev)
    tau, src = go.gas_optics_lw_nn([lw_model], play, plev, tlay, tsfc, GasConcs(concs),
                                   lw_spec, table, tlev=tlev)
    emis = lw_spec.expand(emis_band).contiguous()
    args = (tau, src.lay_source, src.lev_source, emis, src.sfc_source)
    ngpt = tau.shape[-1]
    rng = np.random.default_rng(SEED)
    inc_flux = t(rng.uniform(0.0, 2.0, (NCOL, ngpt)))
    gauss = lambda n: ([float(d) for d in plw.GAUSS_DS[n - 1, :n]],
                       [float(w) for w in plw.GAUSS_WTS[n - 1, :n]])
    errs = {}

    def check(name, got, ref):
        got, ref = torch.stack(tuple(got)), torch.stack(tuple(ref))
        e = maxabs(got, ref)
        print(f"K7 {name}: max|kernel-twin| {e:.3e} W/m2 (tol {LW_ATOL}); mean dn "
              f"{float(got[1].mean()):.4f}")
        require(bool(torch.isfinite(got).all()) and e <= LW_ATOL, f"K7 {name}")
        return e

    for n in range(1, 5):
        for inc in (None, inc_flux):
            n0 = k7.MODE_LAUNCHES["angles"]
            got = k7.lw_noscat_broadband_angles(*args, *gauss(n), inc)
            torch.cuda.synchronize()
            require(k7.MODE_LAUNCHES["angles"] == n0 + 1, f"K7 took more than one launch for {n} angles")
            e = check(f"angles mode {NCOL}x{NLAY}x{ngpt}, {n} angle(s) in one launch"
                      + (", incident flux" if inc is not None else ""),
                      got, k7.lw_noscat_broadband_angles_plain(*args, *gauss(n), inc))
            key = "k7" if n == 1 else "k7_angles"
            errs[key] = max(errs.get(key, 0.0), e)
    ds = t(rng.uniform(1.2, 2.5, (NCOL, ngpt)))
    inc_rad = inc_flux / (2.0 * np.pi * plw.LW_WEIGHT)
    e = check("one angle, per-(column, g-point) secants, incident radiance",
              k7.lw_noscat_broadband(*args, ds, plw.LW_WEIGHT, inc_rad),
              k7.lw_noscat_broadband_plain(*args, ds, plw.LW_WEIGHT, inc_rad))
    errs["k7"] = max(errs["k7"], e)
    # the fields mode on the layer-major transmittance and sources of the
    # diffusivity angle, as K6 writes them
    tl = tau * plw.LW_DIFFUSIVITY
    trans = torch.exp(-tl)
    src_dn, src_up = plw.lw_source_noscat(tl, trans, src.lay_source, src.lev_source)
    fields = tuple(f.transpose(0, 1).contiguous() for f in (trans, src_dn, src_up))
    fk = k7.lw_broadband_sweeps_kernel(*fields, emis, src.sfc_source)
    fp = plw.lw_broadband_sweeps(*fields, emis, src.sfc_source)
    errs["k7_fields"] = check(f"fields mode {NLAY}x{NCOL}x{ngpt}", fk[:2], fp[:2])

    d = torch.full((NCOL, ngpt), float(plw.GAUSS_DS[0, 0]), device=dev)
    secants, weights = gauss(N_ANGLES)
    timers = {"k7": lambda: k7.lw_noscat_broadband(*args, d, plw.LW_WEIGHT),
              "k7_plain": lambda: k7.lw_noscat_broadband_plain(*args, d, plw.LW_WEIGHT),
              "k7_angles": lambda: k7.lw_noscat_broadband_angles(*args, secants, weights),
              "k7_angles_plain": lambda: k7.lw_noscat_broadband_angles_plain(*args, secants,
                                                                             weights),
              "k7_fields": lambda: k7.lw_broadband_sweeps_kernel(*fields, emis, src.sfc_source),
              "k7_fields_plain": lambda: plw.lw_broadband_sweeps(*fields, emis, src.sfc_source)}
    out_bytes = 2 * NCOL * (NLAY + 1) * 4
    cells = NCOL * NLAY * ngpt
    results = {
        "k7": {"max_abs_err": errs["k7"], **k7_bound(nbytes(*args, d) + out_bytes, cells, 1)},
        "k7_angles": {"max_abs_err": errs["k7_angles"],
                      **k7_bound(nbytes(*args) + out_bytes, cells, N_ANGLES)},
        "k7_fields": {"max_abs_err": errs["k7_fields"],
                      **k7_bound(nbytes(*fields, emis, src.sfc_source) + out_bytes, cells, 0)},
    }
    return results, timers


def k7_bound(bytes_moved: float, cells: int, angles: int) -> dict:
    """K7's bound: its inputs read once per call and its outputs written
    once, whatever the number of angles; ELEMENT_FLOPS["k7"] per (cell,
    g-point) and angle, or for the fields mode (``angles`` 0) the sweeps
    alone, ELEMENT_FLOPS["k7_fields"] per (cell, g-point)."""
    per_cell = ELEMENT_FLOPS["k7"] * angles if angles else ELEMENT_FLOPS["k7_fields"]
    return bound(bytes_moved, per_cell * cells)


def hold_sw(got, ref, name="staged SW") -> float:
    """Hold SW fluxes per column within SW_ATOL of a reference (col_err:
    flux objects or dicts of named fields): every SW route of the port
    takes float64 two-stream coefficients (ops/sw_solver.pifm_coefficients,
    as K2), so no column near the resonance k*mu0 = 1 is excepted (ROADMAP
    Queue 3 F1). Returns the largest error."""
    return hold_columns(name, col_err(got, ref))


SW_FLUXES, LW_FLUXES = ("flux_up", "flux_dn", "flux_dn_dir"), ("flux_up", "flux_dn", "flux_net")


def col_err(got, ref, names=SW_FLUXES):
    """Per column, the largest |got - ref| over levels and fluxes (``names``
    of a flux object, or every entry of a dict of named (ncol, nlev)
    tensors), in float64 on the CPU."""
    import torch

    if isinstance(got, dict):
        pairs = [(got[n], ref[n]) for n in got]
    else:
        pairs = [(getattr(got, n), getattr(ref, n)) for n in names]
    err = torch.stack([(a.double().cpu() - b.double().cpu()).abs().amax(1) for a, b in pairs])
    return err.amax(0).numpy()


def hold_columns(name, err, tol=SW_ATOL) -> float:
    """Require every column's error ``err`` within ``tol`` (default the SW
    bound); the failure names the columns beyond and the largest. Returns
    the largest."""
    worst = int(np.argmax(err))
    over = np.nonzero(err > tol)[0]
    require(over.size == 0, f"{name}: {over.size} columns beyond {tol} W/m2 (the first "
                            f"{over[:20].tolist()}), largest {err[worst]:.3e} at column {worst}")
    return float(err[worst])


def general_main_path(dev, lw_model, sw_model, main) -> dict:
    """Phase 9: the general path through the drivers, each run with the
    kernels' counts set to 0 just before and read just after. ``main``
    maps top_at_1 to (data, fused LW fluxes, fused SW fluxes). Returns the
    launch count per kernel."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, nn_model_from_arrays
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.testing import model_arrays, split_lw_both_arrays

    def reset():
        k7.LAUNCHES = 0
        for m in (mlp.LAUNCHES, k7.MODE_LAUNCHES):
            for k in m:
                m[k] = 0

    def finite(fb, names=("flux_up", "flux_dn", "flux_net")):
        for n in names:
            v = getattr(fb, n)
            require(v.device.type == dev.type and tuple(v.shape) == (NCOL, NLAY + 1),
                    f"{n}: {v.device} {tuple(v.shape)}")
            require(bool(torch.isfinite(v).all()), f"{n} not finite")

    launches = {}
    reset()
    multi = {top: rfmip.rfmip_clear_sky_lw(d, [lw_model], n_gauss_angles=N_ANGLES, device=dev)
             for top, (d, _, _) in main.items()}
    torch.cuda.synchronize()
    launches["k3"], launches["k7_angles"] = (mlp.LAUNCHES["fused_predict_lw_both"],
                                             k7.MODE_LAUNCHES["angles"])
    print(f"general LW, {N_ANGLES} angles, both orientations: launches fused_predict_lw_both "
          f"{launches['k3']}, lw_noscat_broadband {k7.LAUNCHES} (angles mode "
          f"{launches['k7_angles']})")
    require(launches["k3"] == 2 and launches["k7_angles"] == 2 and k7.LAUNCHES == 2,
            "multi-angle LW: K3 and K7 (all angles in one launch) not once per call")
    for fb in multi.values():
        finite(fb)
    flip = max(maxabs(multi[True].flux_up, multi[False].flux_up.flip(1)),
               maxabs(multi[True].flux_dn, multi[False].flux_dn.flip(1)))
    print(f"general LW: mean up {float(multi[True].flux_up.mean()):.4f} dn "
          f"{float(multi[True].flux_dn.mean()):.4f} W/m2 ({N_ANGLES} angles; 1 angle, K1: "
          f"{float(main[True][1].flux_dn.mean()):.4f}); orientations differ by {flip:.3e}")
    require(flip <= 1e-6, "multi-angle LW: the two vertical orientations disagree")

    d1, lw1, sw1 = main[True]
    halves = [nn_model_from_arrays(*a, device=dev)
              for a in split_lw_both_arrays(*model_arrays(lw_model))]
    with config_override(use_megakernel=False):
        reset()
        two = rfmip.rfmip_clear_sky_lw(d1, halves, device=dev)
        torch.cuda.synchronize()
        launches["k4"], k7_two = mlp.LAUNCHES["fused_predict_tau"], k7.LAUNCHES
        reset()
        one = rfmip.rfmip_clear_sky_lw(d1, [lw_model], device=dev)
        torch.cuda.synchronize()
        k3_one, k7_one = mlp.LAUNCHES["fused_predict_lw_both"], k7.LAUNCHES
    finite(two)
    e_two = max(maxabs(two.flux_up, one.flux_up), maxabs(two.flux_dn, one.flux_dn))
    e_one = max(maxabs(one.flux_up, lw1.flux_up), maxabs(one.flux_dn, lw1.flux_dn))
    print(f"single-angle LW without the megakernel: two-model launches fused_predict_tau "
          f"{launches['k4']}, lw_noscat_broadband {k7_two}; one-model fused_predict_lw_both "
          f"{k3_one}, lw_noscat_broadband {k7_one}; two- vs one-model {e_two:.3e} W/m2, "
          f"one-model (K3 + K7) vs the K1 path {e_one:.3e} (tol {LW_ATOL})")
    require((launches["k4"], k7_two, k3_one, k7_one) == (1, 1, 1, 1),
            "single-angle staged LW did not launch K4 or K3, then K7, once each")
    launches["k7"] = k7_two + k7_one
    require(max(e_two, e_one) <= LW_ATOL, "the single-angle LW paths disagree")

    sw_models = [sw_model, sw_model]
    with config_override(use_megakernel=False):
        reset()
        staged = {top: rfmip.rfmip_clear_sky_sw(d, sw_models, device=dev)
                  for top, (d, _, _) in main.items()}
        torch.cuda.synchronize()
        launches["k5"] = mlp.LAUNCHES["fused_predict_sw"]
        cpu, f64 = torch.device("cpu"), torch.float64
        sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
        ref = rfmip.rfmip_clear_sky_sw(d1, [sw64, sw64], device=cpu, dtype=f64)
    require(launches["k5"] == 2, "the staged SW driver did not launch K5 once per call")
    for fb in staged.values():
        finite(fb, ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"))
    flip = max(maxabs(staged[True].flux_up, staged[False].flux_up.flip(1)),
               maxabs(staged[True].flux_dn, staged[False].flux_dn.flip(1)))
    require(flip <= 1e-6, "staged SW: the two vertical orientations disagree")
    err = hold_sw(staged[True], ref)
    e_fused = hold_sw(staged[True], sw1, "staged vs fused SW")
    print(f"staged SW (K5): fused_predict_sw launches {launches['k5']}; vs float64 on the CPU "
          f"{err:.3e} W/m2 (tol {SW_ATOL} in every column); vs the fused path (K2) {e_fused:.3e}; "
          f"orientations differ by {flip:.3e}")
    return launches


def synthetic_cloud_optics(spec, flavour, dev, dtype=None):
    """Seeded cloud-optics data on ``spec``'s bands, on ``dev``."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.extensions.cloud_optics import cloud_optics_from_arrays
    from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_cloud_optics

    return cloud_optics_from_arrays(
        synthesize_cloud_optics(spec, SEED, flavour),
        SpectralMapping.bands_only(spec.band_lims_wvn_array), dev, dtype or torch.float32)


def modes_phase(dev, lw_model, sw_model, table, lw_spec, sw_spec, solar, data,
                lw_in, sw_in) -> tuple[dict, dict, dict]:
    """Phase 11: K1 and K2 in both cloud modes, K8 and K9, each against its
    plain twin on the card at full size; then K8 and K9 through their cores
    with the counts read around. Returns (per-kernel results, launches,
    timing closures)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    results, timers = {}, {}
    lw_co = {f: synthetic_cloud_optics(lw_spec, f, dev) for f in ("lut", "pade")}
    sw_co = {f: synthetic_cloud_optics(sw_spec, f, dev) for f in ("lut", "pade")}
    cld = allsky.cloud_fields_lay_major(data.play, data.tlay, lw_co["lut"], True, dev)
    lwp, iwp = cld[0] > 0, cld[1] > 0
    share = {"liquid": float((lwp & ~iwp).float().mean()), "ice": float((iwp & ~lwp).float().mean()),
             "mixed": float((lwp & iwp).float().mean())}
    print(f"clouds at {NCOL}x{NLAY}: share of cells liquid-only {share['liquid']:.4f}, ice-only "
          f"{share['ice']:.4f}, mixed {share['mixed']:.4f}")
    require(all(v > 0 for v in share.values()), f"a kind of cloudy cell is missing: {share}")

    rows, ncell = NCOL * NLAY, NCOL * NLAY
    lw_flops = mlp_flops(lw_model, rows) + ELEMENT_FLOPS["lw"] * ncell * lw_spec.ngpt
    sw_flops = 2 * mlp_flops(sw_model, rows) + ELEMENT_FLOPS["sw"] * ncell * sw_spec.ngpt
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = sw_in
    mu0 = torch.full((NCOL,), ALLSKY_MU0, device=dev)
    alb = torch.full((NCOL, sw_spec.nband), 0.06, device=dev)
    clear_dn = k1.lw_clearsky_mega4(*fused.lw_args([lw_model], table, lw_spec, *lw_in)[0])[1]
    for flavour, mode in (("lut", "cld_lut"), ("pade", "cld_bands")):
        # K1 in the cloud mode
        args, kw = fused.lw_args([lw_model], table, lw_spec, *lw_in, (lw_co[flavour], cld))
        got = k1.lw_clearsky_mega4(*args, **kw)
        torch.cuda.synchronize()
        ref = k1.lw_clearsky_mega4_plain(*args, **kw)
        require(all(bool(torch.isfinite(o).all()) for o in got), f"K1 {mode} output not finite")
        e = max(maxabs(a, b) for a, b in zip(got, ref))
        moved = maxabs(got[1], clear_dn)
        print(f"K1 lw_clearsky_mega4[{mode}] {NCOL}x{NLAY}: max|kernel-plain| {e:.3e} W/m2 (tol "
              f"{LW_ATOL}); the clouds move flux_dn by up to {moved:.3f} W/m2; mean dn "
              f"{float(got[1].mean()):.4f}")
        require(moved > 1.0, f"K1 {mode}: the clouds do not show in the fluxes")

        def ref64(args=args, kw=kw):
            a, k = in_float64(args, kw)
            return k1.lw_clearsky_mega4_plain(*a, **k)

        adjudicate_lazy(f"K1 {mode}", e, LW_ATOL, got, ref, ref64)
        cloud_ops = cloud_flops("lw", mode, cld, lw_spec.nband, lw_spec.ngpt)
        results[f"k1_{mode}"] = {"max_abs_err": e, **bound(
            nbytes(*args[1:3], *args[5:9], args[11], list(kw.values())) + model_bytes(lw_model)
            + nbytes(table.totplnk, table.totplnk_diff) + 2 * NCOL * (NLAY + 1) * 4,
            lw_flops + cloud_ops)}
        timers[f"k1_{mode}"] = lambda a=args, k=kw: k1.lw_clearsky_mega4(*a, **k)
        timers[f"k1_{mode}_plain"] = lambda a=args, k=kw: k1.lw_clearsky_mega4_plain(*a, **k)

        # K2 in the cloud mode
        args, kw = fused.sw_args([sw_model, sw_model], sw_spec, play_t, plev_t, tlay_t, mu0,
                                 *fused.sw_boundary(sw_spec, solar, alb, alb), concs_t,
                                 (sw_co[flavour], cld))
        got = k2.sw_clearsky_megakernel(*args, **kw)
        torch.cuda.synchronize()
        ref = k2.sw_clearsky_megakernel_plain(*args, **kw)
        clear = k2.sw_clearsky_megakernel(*args)
        require(all(bool(torch.isfinite(o).all()) for o in got), f"K2 {mode} output not finite")
        errs = {n: maxabs(a, b) for n, a, b in zip(("up", "dn", "dn_dir"), got, ref)}
        e = max(errs.values())
        moved = maxabs(got[2], clear[2])
        print(f"K2 sw_clearsky_megakernel[{mode}] {NCOL}x{NLAY}: max|kernel-plain| "
              + " ".join(f"{n} {v:.3e}" for n, v in errs.items())
              + f" W/m2 (tol {SW_ATOL}); the clouds move the direct beam by up to {moved:.3f} W/m2")
        require(moved > 1.0, f"K2 {mode}: the clouds do not show in the fluxes")

        def ref64(args=args, kw=kw):
            a, k = in_float64(args, kw)
            return k2.sw_clearsky_megakernel_plain(*a, **k)

        adjudicate_lazy(f"K2 {mode}", e, SW_ATOL, got, ref, ref64)
        cloud_ops = cloud_flops("sw", mode, cld, sw_spec.nband, sw_spec.ngpt)
        results[f"k2_{mode}"] = {"max_abs_err": e, **bound(
            nbytes(*args[2:4], *args[5:], list(kw.values())) + model_bytes(sw_model, sw_model)
            + 3 * NCOL * (NLAY + 1) * 4, sw_flops + cloud_ops)}
        timers[f"k2_{mode}"] = lambda a=args, k=kw: k2.sw_clearsky_megakernel(*a, **k)
        timers[f"k2_{mode}_plain"] = lambda a=args, k=kw: k2.sw_clearsky_megakernel_plain(*a, **k)

    # K8: the LW kernel on raw lanes
    args5 = rfmip.lw_mega5_args([lw_model], table, lw_spec, *lw_in)
    got = k8_out = k1.lw_clearsky_mega5(*args5)
    torch.cuda.synchronize()
    ref = k1.lw_clearsky_mega5_plain(*args5)
    stacked = k1.lw_clearsky_mega4(*fused.lw_args([lw_model], table, lw_spec, *lw_in)[0])
    e = max(maxabs(a, b) for a, b in zip(got, ref))
    e_st = max(maxabs(a, b) for a, b in zip(got, stacked))
    print(f"K8 lw_clearsky_mega5 (raw lanes, codes {args5[2]}) {NCOL}x{NLAY}: max|kernel-plain| "
          f"{e:.3e}, vs the stacked-input mode {e_st:.3e} W/m2 (tol {LW_ATOL})")

    def ref64_k8():
        return k1.lw_clearsky_mega5_plain(*in_float64(args5, {})[0])

    adjudicate_lazy("K8", e, LW_ATOL, got, ref, ref64_k8)
    if e_st > LW_ATOL:
        # two float32 evaluations on features that differ in the last bit
        # ((x - min) * inv here, (x - min) / (max - min) there): neither is
        # the other's reference, so each is held to float64
        r64 = ref64_k8()
        e8, e1 = (max(maxabs(a, b) for a, b in zip(o, r64)) for o in (got, stacked))
        print(f"K8 vs the stacked-input mode beyond {LW_ATOL}; against float64: K8 {e8:.3e}, "
              f"stacked {e1:.3e} W/m2")
        require(max(e8, e1) <= LW_ATOL, "K8 or the stacked-input mode is off float64")
    results["k8"] = {"max_abs_err": e, **bound(
        nbytes(args5[1], args5[3], args5[4], *args5[7:10], args5[12]) + model_bytes(lw_model)
        + nbytes(table.totplnk, table.totplnk_diff) + 2 * NCOL * (NLAY + 1) * 4, lw_flops)}
    timers["k8"] = lambda: k1.lw_clearsky_mega5(*args5)
    timers["k8_plain"] = lambda: k1.lw_clearsky_mega5_plain(*args5)

    # K9: the SW kernel with one array per feature
    sargs, _ = fused.sw_args([sw_model, sw_model], None, *rfmip.sw_fused_inputs(solar, *sw_in))
    lanes = [l.contiguous() for l in sargs[2].unbind(-1)]
    largs = sargs[:2] + (lanes,) + sargs[3:]
    got = k2.sw_clearsky_megakernel(*largs, input_mode="lanes")
    torch.cuda.synchronize()
    ref = k2.sw_clearsky_megakernel_plain(*largs, input_mode="lanes")
    stacked = k2.sw_clearsky_megakernel(*sargs)
    e = max(maxabs(a, b) for a, b in zip(got, ref))
    e_st = max(maxabs(a, b) for a, b in zip(got, stacked))
    print(f"K9 sw_clearsky_megakernel(input_mode='lanes') {NCOL}x{NLAY}: max|kernel-plain| "
          f"{e:.3e} W/m2 (tol {SW_ATOL}), vs the stacked-input mode {e_st:.3e}")
    require(e_st == 0.0, "K9 differs from the stacked-input mode of the same kernel")

    def ref64_k9():
        return k2.sw_clearsky_megakernel_plain(*in_float64(largs, {})[0], input_mode="lanes")

    adjudicate_lazy("K9", e, SW_ATOL, got, ref, ref64_k9)
    results["k9"] = {"max_abs_err": e, **bound(
        nbytes(lanes, *sargs[3:4], *sargs[5:]) + model_bytes(sw_model, sw_model)
        + 3 * NCOL * (NLAY + 1) * 4, sw_flops)}
    timers["k9"] = lambda: k2.sw_clearsky_megakernel(*largs, input_mode="lanes")
    timers["k9_plain"] = lambda: k2.sw_clearsky_megakernel_plain(*largs, input_mode="lanes")

    # No driver routes to K8 or K9 (in the JAX package too only benchmarks and
    # tests call them), so their counts are read around the raw-lane LW core
    # from column-major inputs and around the lane-input SW wrapper itself
    k1.LAUNCHES = k2.LAUNCHES = 0
    for m in (k1.MODE_LAUNCHES, k2.MODE_LAUNCHES):
        for k in m:
            m[k] = 0
    fb = rfmip._lw_core_mega5([lw_model], table, lw_spec, *rfmip.lw_staged_inputs(data, lw_spec, dev),
                              top_at_1=True)
    sw_out = k2.sw_clearsky_megakernel(*largs, input_mode="lanes")
    torch.cuda.synchronize()
    launches = {"k8": k1.MODE_LAUNCHES["lanes"], "k9": k2.MODE_LAUNCHES["lanes"]}
    print(f"lane-mode launches (core and wrapper level, no driver route): lw_clearsky_mega5 "
          f"{launches['k8']} (of {k1.LAUNCHES} LW launches), sw_clearsky_megakernel[lanes] "
          f"{launches['k9']} (of {k2.LAUNCHES} SW)")
    require((launches["k8"], k1.LAUNCHES, launches["k9"], k2.LAUNCHES) == (1, 1, 1, 1),
            "the lane-mode cores did not launch K8 and K9 once each and nothing else")
    require(maxabs(fb.flux_up, k8_out[0]) <= 1e-6 and maxabs(fb.flux_dn, k8_out[1]) <= 1e-6
            and maxabs(sw_out[0], stacked[0]) == 0.0,
            "the lane-mode cores disagree with their kernels")
    return results, launches, timers


def write_allsky_files(directory) -> dict:
    """Write the all-sky drivers' input files, made from SEED, into
    ``directory``: a Garand-format atmosphere of NLAY layers, and
    lookup-table and Pade cloud-optics coefficient files for the LW and the
    SW bands. Returns their paths by "garand" and "<lw|sw>_<lut|pade>"."""
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128, sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.testing import (
        cloud_optics_nc_variables, garand_nc_variables, synthesize_cloud_optics,
        synthesize_garand)
    from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

    paths = {"garand": os.path.join(directory, "garand-synthetic.nc")}
    write_nc(paths["garand"], *garand_nc_variables(synthesize_garand(NLAY, SEED)))
    for band, spec in (("lw", lw_spectral_g128()), ("sw", sw_spectral_g112())):
        for flavour in ("lut", "pade"):
            paths[f"{band}_{flavour}"] = os.path.join(directory, f"cloud-coeffs-{band}-{flavour}.nc")
            write_nc(paths[f"{band}_{flavour}"], *cloud_optics_nc_variables(
                synthesize_cloud_optics(spec, SEED, flavour)))
    print(f"all-sky files: {sorted(os.path.basename(p) for p in paths.values())}")
    return paths


def allsky_core_closures(dev, lw_model, sw_models, paths, ncol=NCOL, sw_spec=None,
                         solar_source=None) -> dict:
    """The six all-sky cores (LW and SW; fused, staged and parallel-scan
    route) as closures over device-resident inputs read from the files ``paths``
    (write_allsky_files: "garand", "lw_lut", "sw_lut"), lookup-table cloud
    optics, ``ncol`` columns; SW on ``sw_spec`` (default the g-112 mapping)
    and ``solar_source`` (default the mapping's)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, fused
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, spectral_for, sw_spectral_g112)

    lw_spec = spectral_for("lw", [lw_model], entry="allsky_core_closures",
                           accepts=(lw_spectral_g128,))
    sw_spec = spectral_for("sw", sw_models, entry="allsky_core_closures",
                           accepts=(sw_spectral_g112,), spectral=sw_spec)
    if solar_source is None:
        solar_source = allsky.resolve_solar_source(sw_spec)
    atm = allsky.read_garand(paths["garand"], ncol)
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(solar_source, dtype=torch.float32, device=dev)
    tsfc = torch.as_tensor(atm.tlev[:, -1], device=dev)
    emis = torch.full((ncol, lw_spec.nband), 0.98, device=dev)
    mu0 = torch.full((ncol,), ALLSKY_MU0, device=dev)
    alb = torch.full((ncol, sw_spec.nband), 0.06, device=dev)
    lw_co = allsky.load_cloud_optics_checked(paths["lw_lut"], device=dev)
    sw_co = allsky.load_cloud_optics_checked(paths["sw_lut"], device=dev)
    clouds = allsky.make_clouds(atm.play, atm.tlay, lw_co)
    (play_t, plev_t, tlay_t, tlev_t, *cld_t), concs_t = allsky._canonical_tensors(
        atm, clouds, True, dev, torch.float32)
    (play, plev, tlay, tlev, *cld), concs = allsky._staged_tensors(atm, clouds, dev, torch.float32)
    return {
        "allsky_lw_core_fused": lambda: fused.lw_core(
            [lw_model], table, lw_spec, play_t, plev_t, tlay_t, tlev_t, tsfc, emis, concs_t,
            (lw_co, cld_t), top_at_1=True),
        "allsky_sw_core_fused": lambda: fused.sw_core(
            sw_models, sw_spec, play_t, plev_t, tlay_t, mu0,
            *fused.sw_boundary(sw_spec, solar, alb, alb), concs_t, (sw_co, cld_t), top_at_1=True),
        "allsky_lw_core_staged": lambda: allsky._allsky_lw_core(
            [lw_model], table, lw_spec, lw_co, play, plev, tlay, tlev, tsfc, emis, *cld, concs,
            top_at_1=True, n_gauss_angles=1),
        "allsky_sw_core_staged": lambda: allsky._allsky_sw_core_lay_major(
            sw_models, sw_spec, solar, sw_co, play, plev, tlay, mu0, alb, alb, *cld,
            concs, top_at_1=True),
        "allsky_lw_core_parallel": lambda: allsky._allsky_lw_core(
            [lw_model], table, lw_spec, lw_co, play, plev, tlay, tlev, tsfc, emis, *cld, concs,
            top_at_1=True, n_gauss_angles=1, scan_mode="parallel"),
        "allsky_sw_core_parallel": lambda: allsky._allsky_sw_core(
            sw_models, sw_spec, solar, sw_co, play, plev, tlay, mu0, alb, alb, *cld,
            concs, top_at_1=True, scan_mode="parallel"),
    }


def allsky_main_path(dev, lw_model, sw_model, solar_sum) -> tuple[dict, dict]:
    """Phase 12: allsky_lw / allsky_sw on the card from files written here,
    each call with every kernel count set to 0 just before and read just
    after. Returns (launches per kernel mode on the fused route, timing
    closures of the all-sky cores)."""
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        lw_spectral_g128, spectral_for, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    def reset():
        k1.LAUNCHES = k2.LAUNCHES = k7.LAUNCHES = 0
        for m in (k1.MODE_LAUNCHES, k2.MODE_LAUNCHES, mlp.LAUNCHES):
            for k in m:
                m[k] = 0

    def counts():
        torch.cuda.synchronize()
        c = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES, "k7": k7.LAUNCHES}
        c.update({f"k1_{k}": v for k, v in k1.MODE_LAUNCHES.items() if v})
        c.update({f"k2_{k}": v for k, v in k2.MODE_LAUNCHES.items() if v})
        c.update({k: v for k, v in mlp.LAUNCHES.items() if v})
        return {k: v for k, v in c.items() if v}

    def finite(fb, names):
        for n in names:
            v = getattr(fb, n)
            require(v.device.type == dev.type and tuple(v.shape) == (NCOL, NLAY + 1),
                    f"all-sky {n}: {v.device} {tuple(v.shape)}")
            require(bool(torch.isfinite(v).all()), f"all-sky {n} not finite")

    lw_names, sw_names = ("flux_up", "flux_dn", "flux_net"), ("flux_up", "flux_dn", "flux_dn_dir")
    lw_spec = spectral_for("lw", [lw_model], entry="allsky_main_path", accepts=(lw_spectral_g128,))
    sw_spec = spectral_for("sw", [sw_model, sw_model], entry="allsky_main_path",
                           accepts=(sw_spectral_g112,))
    cpu, f64 = torch.device("cpu"), torch.float64
    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_allsky_files(tmp)
        # the file's 2 profiles and the 3-column cloud pattern repeat every 6
        # columns: 6 columns in float64 on the CPU are the reference of all
        tile = torch.arange(NCOL) % 6
        for flavour, mode in (("lut", "cld_lut"), ("pade", "cld_bands")):
            garand, lw_co, sw_co = paths["garand"], paths[f"lw_{flavour}"], paths[f"sw_{flavour}"]
            reset()
            lw = allsky.allsky_lw(garand, lw_co, [lw_model], ncol=NCOL, device=dev)
            c_lw = counts()
            reset()
            sw = allsky.allsky_sw(garand, sw_co, [sw_model, sw_model], ncol=NCOL, device=dev)
            c_sw = counts()
            print(f"all-sky {flavour}, fused route: allsky_lw launches {c_lw}, allsky_sw {c_sw}")
            require(c_lw == {"k1": 1, f"k1_{mode}": 1} and c_sw == {"k2": 1, f"k2_{mode}": 1},
                    f"the fused all-sky route did not launch K1 and K2 once in the {mode} mode "
                    "and nothing else")
            launches[f"k1_{mode}"], launches[f"k2_{mode}"] = c_lw[f"k1_{mode}"], c_sw[f"k2_{mode}"]
            finite(lw, lw_names)
            finite(sw, sw_names + ("flux_net",))

            reset()
            lw3 = allsky.allsky_lw(garand, lw_co, [lw_model], ncol=NCOL, n_gauss_angles=N_ANGLES,
                                   device=dev)
            c_lw3 = counts()
            with config_override(use_megakernel=False):
                reset()
                lw1 = allsky.allsky_lw(garand, lw_co, [lw_model], ncol=NCOL, device=dev)
                c_lw1 = counts()
                reset()
                sws = allsky.allsky_sw(garand, sw_co, [sw_model, sw_model], ncol=NCOL, device=dev)
                c_sws = counts()
            print(f"all-sky {flavour}, staged routes: allsky_lw {N_ANGLES} angles {c_lw3}, 1 angle "
                  f"{c_lw1}, allsky_sw {c_sws}")
            require(c_lw3 == {"fused_predict_lw_both": 1, "k7": 1}
                    and c_lw1 == {"fused_predict_lw_both": 1, "k7": 1}
                    and c_sws == {"fused_predict_sw": 1},
                    "the staged all-sky routes did not launch K3 and K7 (all angles) once, or K5 once")
            finite(lw3, lw_names)
            finite(sws, sw_names)

            ref_lw = {n: allsky.allsky_lw(garand, lw_co, [lw64], ncol=6, n_gauss_angles=n,
                                          device=cpu, dtype=f64) for n in (1, N_ANGLES)}
            ref_sw = allsky.allsky_sw(garand, sw_co, [sw64, sw64], ncol=6, device=cpu, dtype=f64)
            tiled = lambda fb, n: getattr(fb, n)[tile]
            e_mega = max(maxabs(getattr(lw, n).cpu(), tiled(ref_lw[1], n)) for n in lw_names)
            e_st1 = max(maxabs(getattr(lw1, n).cpu(), tiled(ref_lw[1], n)) for n in lw_names)
            e_st3 = max(maxabs(getattr(lw3, n).cpu(), tiled(ref_lw[N_ANGLES], n)) for n in lw_names)
            e_ms = max(maxabs(getattr(lw, n), getattr(lw1, n)) for n in lw_names)
            print(f"all-sky {flavour} LW vs float64 on the CPU: fused {e_mega:.3e}, staged 1 angle "
                  f"{e_st1:.3e}, staged {N_ANGLES} angles {e_st3:.3e}; fused vs staged {e_ms:.3e} "
                  f"W/m2 (tol {LW_ATOL}); mean dn {float(lw.flux_dn.mean()):.4f} up "
                  f"{float(lw.flux_up.mean()):.4f}")
            require(max(e_mega, e_st1, e_st3, e_ms) <= LW_ATOL, "all-sky LW routes disagree")
            ref_tiled = type(ref_sw)(**{n: tiled(ref_sw, n) for n in sw_names})
            e_mega = max(maxabs(getattr(sw, n).cpu(), getattr(ref_tiled, n)) for n in sw_names)
            e_st = hold_sw(sws, ref_tiled, f"all-sky {flavour} staged SW")
            e_fs = hold_sw(sw, sws, f"all-sky {flavour} fused vs staged SW")
            print(f"all-sky {flavour} SW vs float64 on the CPU: fused {e_mega:.3e}, staged "
                  f"{e_st:.3e} (tol {SW_ATOL} in every column); fused vs staged {e_fs:.3e} "
                  f"W/m2; mean dn "
                  f"{float(sw.flux_dn.mean()):.4f} up {float(sw.flux_up.mean()):.4f} dir "
                  f"{float(sw.flux_dn_dir.mean()):.4f}")
            require(e_mega <= SW_ATOL, "all-sky fused SW disagrees with float64")

            if flavour == "lut":
                # parallel scans: the general cores; LW then solves spectrally
                # with log-depth scans (no transport kernel), SW with the
                # log-depth adding
                reset()
                lwp = allsky.allsky_lw(garand, lw_co, [lw_model], ncol=NCOL, scan_mode="parallel",
                                       device=dev)
                c_lwp = counts()
                reset()
                swp = allsky.allsky_sw(garand, sw_co, [sw_model, sw_model], ncol=NCOL,
                                       scan_mode="parallel", device=dev)
                c_swp = counts()
                e_lwp = max(maxabs(getattr(lwp, n), getattr(lw1, n)) for n in lw_names)
                e_swp = hold_sw(swp, sws, "all-sky parallel-scan vs staged SW")
                print(f"all-sky parallel scans: allsky_lw launches {c_lwp}, vs the staged request "
                      f"{e_lwp:.3e} W/m2 (tol {LW_ATOL}); allsky_sw launches {c_swp}, vs the staged "
                      f"request {e_swp:.3e} (tol {SW_ATOL} in every column)")
                require(c_lwp == {"fused_predict_lw_both": 1} and c_swp == {"fused_predict_sw": 1},
                        "the parallel-scan all-sky requests did not take K3 and K5 alone")
                require(e_lwp <= LW_ATOL, "all-sky parallel-scan LW disagrees with the staged request")
                finite(swp, sw_names)

            # columns 0 and 2 share a profile, as do 1 and 5; 2 and 5 are cloud-free
            for cloudy, clear_col in ((0, 2), (1, 5)):
                d_lw = float(lw.flux_dn[cloudy, -1] - lw.flux_dn[clear_col, -1])
                d_sw = float(sw.flux_dn_dir[cloudy, -1] - sw.flux_dn_dir[clear_col, -1])
                print(f"all-sky {flavour}: column {cloudy} (cloudy) against {clear_col} (clear): LW "
                      f"flux_dn at the surface {d_lw:+.3f}, SW direct beam {d_sw:+.3f} W/m2")
                require(d_lw > 0 and d_sw < 0, "clouds do not raise the LW down flux and cut the "
                                               "SW direct beam at the surface")
            toa = float((sw.flux_dn[:, 0].double() - solar_sum * ALLSKY_MU0).abs().max()
                        / (solar_sum * ALLSKY_MU0))
            require(toa <= 1e-5, f"all-sky SW TOA down differs from sum(solar)*mu0 by {toa:.2e}")

        timers = allsky_core_closures(dev, lw_model, [sw_model, sw_model], paths)
    return launches, timers


def mode_cases(dev, ncol, nlay, lw_model, sw_model, table, lw_spec, sw_spec, solar) -> dict:
    """{name: (wrapper, plain twin, args, keywords, tolerance in W/m2)} of K1
    and K2 in their four modes (K8 and K9 are the lane modes) on one
    atmosphere synthesized from SEED, with the all-sky driver's clouds."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, SEED, top_at_1=True))
    lw_in = rfmip.lw_canonical_inputs(data, lw_spec, dev)
    sw_in = rfmip.sw_canonical_inputs(data, dev)
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = sw_in
    mu0 = torch.full((ncol,), ALLSKY_MU0, device=dev)
    alb = torch.full((ncol, sw_spec.nband), 0.06, device=dev)
    lw, lwp = k1.lw_clearsky_mega4, k1.lw_clearsky_mega4_plain
    sw, swp = k2.sw_clearsky_megakernel, k2.sw_clearsky_megakernel_plain
    sargs, _ = fused.sw_args([sw_model, sw_model], None, *rfmip.sw_fused_inputs(solar, *sw_in))
    lanes = [l.contiguous() for l in sargs[2].unbind(-1)]
    cases = {
        "k1": (lw, lwp, fused.lw_args([lw_model], table, lw_spec, *lw_in)[0], {}, LW_ATOL),
        "k2": (sw, swp, sargs, {}, SW_ATOL),
        "k8": (k1.lw_clearsky_mega5, k1.lw_clearsky_mega5_plain,
               rfmip.lw_mega5_args([lw_model], table, lw_spec, *lw_in), {}, LW_ATOL),
        "k9": (sw, swp, sargs[:2] + (lanes,) + sargs[3:], dict(input_mode="lanes"), SW_ATOL),
    }
    for flavour, mode in (("lut", "cld_lut"), ("pade", "cld_bands")):
        lw_co = synthetic_cloud_optics(lw_spec, flavour, dev)
        sw_co = synthetic_cloud_optics(sw_spec, flavour, dev)
        cld = allsky.cloud_fields_lay_major(data.play, data.tlay, lw_co, True, dev)
        cases[f"k1_{mode}"] = (lw, lwp, *fused.lw_args(
            [lw_model], table, lw_spec, *lw_in, (lw_co, cld)), LW_ATOL)
        cases[f"k2_{mode}"] = (sw, swp, *fused.sw_args(
            [sw_model, sw_model], sw_spec, play_t, plev_t, tlay_t, mu0,
            *fused.sw_boundary(sw_spec, solar, alb, alb), concs_t, (sw_co, cld)), SW_ATOL)
    return cases


MODE_OF = {"k1": "clear", "k2": "clear", "k8": "lanes", "k9": "lanes", "k1_cld_lut": "cld_lut",
           "k2_cld_lut": "cld_lut", "k1_cld_bands": "cld_bands", "k2_cld_bands": "cld_bands"}


def geometry_phase(dev, card, lw_model, sw_model, table, lw_spec, sw_spec, solar, lw_args,
                   sw_args) -> dict:
    """Phase 18: K1 and K2, every mode, at ragged sizes against their twins;
    each mode's launch plan, ptxas counts and resident blocks per SM at the
    full size; K2's time against the number of layers. Returns the geometry
    entry per kernel."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    cases = lambda ncol, nlay: mode_cases(dev, ncol, nlay, lw_model, sw_model, table, lw_spec,
                                          sw_spec, solar)
    for nlay in (13, 61):
        worst = {}
        for name, (fn, twin, args, kw, tol) in cases(37, nlay).items():
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            ref = twin(*args, **kw)
            require(all(bool(torch.isfinite(o).all()) and tuple(o.shape) == (37, nlay + 1)
                        for o in got), f"{name} at 37x{nlay}: output not finite or misshapen")
            worst[name] = max(maxabs(a, b) for a, b in zip(got, ref))
            require(worst[name] <= tol, f"{name} at 37x{nlay} differs from its twin by "
                                        f"{worst[name]:.3e} W/m2 (tol {tol})")
        print(f"ragged 37x{nlay}, max|kernel-twin| W/m2 (tol LW {LW_ATOL}, SW {SW_ATOL}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    lw_net, sw_net = lw_model.dims, sw_model.dims
    plans = {"k1": k1.launch_plan(NLAY, lw_args[1].shape[-1], lw_net[1], lw_net[2], lw_spec.ngpt),
             "k2": k2.launch_plan(NLAY, sw_args[2].shape[-1], sw_net[1], sw_net[2], sw_spec.ngpt)}
    geometry = {}
    for name, mode in MODE_OF.items():
        lw_kernel = name.startswith(("k1", "k8"))
        plan = plans["k1" if lw_kernel else "k2"]
        res = build.kernel_resources("lw_mega_kernel" if lw_kernel else "sw_mega_kernel",
                                     k1.MODE_CODES[mode])
        require(bool(res), f"{name}: the build's ptxas output has no entry for this kernel mode")
        blocks = build.blocks_per_sm("lw_clearsky_mega4" if lw_kernel else "sw_clearsky_megakernel",
                                     plan, k1.MODE_CODES[mode], dev.index)
        require(blocks >= 1, f"{name}: the runtime keeps no block of this plan on an SM")
        geometry[name] = {"threads": plan.threads, "smem_bytes": plan.smem_bytes,
                          "blocks_per_sm": blocks, **res}
        print(f"geometry {name}: {plan.threads} threads in {plan.groups} layer groups of "
              f"{plan.layers_per_group} layers, {plan.smem_bytes} B of shared memory (weight slabs "
              f"2 x {4 * plan.slab_floats} B), {res['registers']} registers, {res['spill_bytes']} B "
              f"spill, {blocks} block(s) per SM by the runtime's occupancy call")
    # K2 against the number of layers. Up to 64 layers every layer group runs
    # its nets as one pass of kMegaRows rows, so what grows with nlay is the
    # coefficients (nlay / 4 per thread), the sweeps (nlay per thread) and
    # the level sums; twice the layers do not fit the shared memory. At four
    # times the columns, so that the card takes longer over a quarter of the
    # layers than the host takes to queue the call.
    ms, ncol = {}, 4 * NCOL
    for nlay in (NLAY // 4, NLAY // 2, NLAY):
        fn, _, args, kw, _ = cases(ncol, nlay)["k2"]
        ms[nlay] = cuda_ms(lambda: fn(*args, **kw))
    lo, mid = NLAY // 4, NLAY // 2
    per_layer = (ms[NLAY] - ms[lo]) / (NLAY - lo)
    off_line = ms[mid] - (ms[lo] + per_layer * (mid - lo))
    print("layers k2: " + ", ".join(f"{v:.4f} ms at {ncol}x{k}" for k, v in ms.items())
          + f"; {per_layer * 1e3:.3f} us per layer ({off_line:+.4f} ms off the line at {mid}), "
          f"so {per_layer * NLAY / ms[NLAY]:.4f} of the time at {NLAY} layers grows with the "
          f"layers (coefficients, sweeps, level sums: the sweeps' share is below it) | {card}")
    require(ms[lo] < ms[mid] < ms[NLAY], "K2 is not slower with more layers")
    return geometry


def kernels_wide_phase(dev, card, lw_model, sw_model, table, lw_spec) -> tuple[dict, dict]:
    """Phase 19: K3-K7's launch plans, ptxas counts and the blocks per SM the
    runtime's occupancy call gives, and their times at four times the
    columns (a kernel under 0.3 ms at NCOL columns reads the host's time to
    queue a call). Returns (geometry entry per kernel, ms per call at
    4 x NCOL columns)."""
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.testing import model_arrays, split_lw_both_arrays, synthesize_rfmip

    ncol = 4 * NCOL
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, NLAY, SEED, top_at_1=True))
    tau_net = nn_model_from_arrays(*split_lw_both_arrays(*model_arrays(lw_model))[0], device=dev)
    col_dry, x_lw, x_sw = mlp_inputs(dev, data, lw_model, sw_model)
    args = k6_args(dev, data, lw_model, table, lw_spec)
    smem = k1._smem_limit(dev)
    calls = {
        "k3": (lambda: mlp.fused_predict_lw_both(lw_model, x_lw, col_dry), (lw_model.dims,)),
        "k4": (lambda: mlp.fused_predict_tau(tau_net, x_lw, col_dry), (tau_net.dims,)),
        "k5": (lambda: mlp.fused_predict_sw(sw_model, sw_model, x_sw, col_dry),
               (sw_model.dims, sw_model.dims)),
    }
    geometry, wide = {}, {}
    for k, (fn, dims) in calls.items():
        plan = mlp.mlp_launch_plan(*map(tuple, dims), smem_limit=smem)
        res = build.kernel_resources("mlp_kernel", plan.rows)
        require(bool(res), f"{k}: the build's ptxas output has no entry for mlp_kernel<{plan.rows}>")
        blocks = build.blocks_per_sm("mlp_predict", plan, 0, dev.index)
        require(blocks >= 1, f"{k}: the runtime keeps no block of this plan on an SM")
        geometry[k] = {"threads": plan.threads, "smem_bytes": plan.smem_bytes,
                       "blocks_per_sm": blocks, **res}
        print(f"geometry {k}: {plan.threads} threads, {plan.rows} rows per block, activations "
              f"{plan.width} wide, {plan.smem_bytes} B of shared memory (weight slabs 2 x "
              f"{4 * plan.slab_floats} B), {res['registers']} registers, {res['spill_bytes']} B "
              f"spill, {blocks} block(s) per SM by the runtime's occupancy call")
        wide[k] = cuda_ms(fn)
    _, x, *_ = args
    dims = lw_model.dims
    plan = k6.lw_prep_plan(NLAY, x.shape[-1], dims[1], dims[2], lw_spec.ngpt, smem)
    res = build.kernel_resources("lw_prep_kernel")
    require(bool(res), "k6: the build's ptxas output has no entry for lw_prep_kernel")
    blocks = build.blocks_per_sm("lw_prep", plan, 0, dev.index)
    require(blocks >= 1, "k6: the runtime keeps no block of this plan on an SM")
    geometry["k6"] = {"threads": plan.threads, "smem_bytes": plan.smem_bytes,
                      "blocks_per_sm": blocks, **res}
    print(f"geometry k6: {plan.threads} threads in {plan.groups} layer groups of "
          f"{plan.layers_per_group} layers, {plan.smem_bytes} B of shared memory (weight slabs "
          f"2 x {4 * plan.slab_floats} B), {res['registers']} registers, {res['spill_bytes']} B "
          f"spill, {blocks} block(s) per SM by the runtime's occupancy call")
    wide["k6"] = cuda_ms(lambda: k6.lw_prep(*args))
    k7_geometry, k7_wide = k7_wide_phase(dev, lw_model, table, lw_spec, data, args, smem)
    geometry.update(k7_geometry)
    wide.update(k7_wide)
    for k, ms in wide.items():
        extra = ""
        if "bound_ms_wide" in geometry[k]:
            b = geometry[k]["bound_ms_wide"]
            extra = f", bound {b:.4f} ms ({b / ms:.3f} of it)"
        print(f"timing {k} at {ncol}x{NLAY}: {ms:.4f} ms, {ms / 4:.4f} ms per {NCOL} columns"
              f"{extra} | {card}")
    return geometry, wide


def k7_wide_phase(dev, lw_model, table, lw_spec, data, k6_args_wide, smem) -> tuple[dict, dict]:
    """Phase 19 for K7: its plan, ptxas counts and blocks per SM for one
    angle, N_ANGLES angles and the fields mode, and its time at the columns
    of ``data`` (the angles mode on gas_optics_lw_nn's fields, the fields
    mode on K6's output), each beside its bound there. Returns (geometry
    entry per mode, ms per call)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    play, plev, tlay, tlev, tsfc, emis_band, concs = rfmip.lw_staged_inputs(data, lw_spec, dev)
    tau, src = go.gas_optics_lw_nn([lw_model], play, plev, tlay, tsfc, GasConcs(concs),
                                   lw_spec, table, tlev=tlev)
    emis = lw_spec.expand(emis_band).contiguous()
    args = (tau, src.lay_source, src.lev_source, emis, src.sfc_source)
    ncol, _, ngpt = tau.shape
    d = torch.full((ncol, ngpt), plw.LW_DIFFUSIVITY, device=dev)
    secants = [float(x) for x in plw.GAUSS_DS[N_ANGLES - 1, :N_ANGLES]]
    weights = [float(x) for x in plw.GAUSS_WTS[N_ANGLES - 1, :N_ANGLES]]
    trans, src_dn, src_up, sfc = k6.lw_prep(*k6_args_wide)
    out_bytes, cells = 2 * ncol * (NLAY + 1) * 4, ncol * NLAY * ngpt
    calls = {
        "k7": ("angles", 1, lambda: k7.lw_noscat_broadband(*args, d, plw.LW_WEIGHT),
               k7_bound(nbytes(*args, d) + out_bytes, cells, 1)),
        "k7_angles": ("angles", N_ANGLES,
                      lambda: k7.lw_noscat_broadband_angles(*args, secants, weights),
                      k7_bound(nbytes(*args) + out_bytes, cells, N_ANGLES)),
        "k7_fields": ("fields", 1,
                      lambda: k7.lw_broadband_sweeps_kernel(trans, src_dn, src_up, emis, sfc),
                      k7_bound(nbytes(trans, src_dn, src_up, emis, sfc) + out_bytes, cells, 0)),
    }
    geometry, wide = {}, {}
    for k, (mode, nang, fn, b) in calls.items():
        plan = k7.lw_noscat_plan(NLAY, ngpt, nang, smem)
        code = k7.MODE_CODES[mode]
        res = build.kernel_resources("lw_noscat_kernel", (nang, code, plan.seg_layers))
        require(bool(res), f"{k}: the build's ptxas output has no entry for lw_noscat_kernel<{nang}, "
                           f"{code}, {plan.seg_layers}>")
        blocks = build.blocks_per_sm("lw_noscat_broadband", plan, code, dev.index)
        require(blocks >= 1, f"{k}: the runtime keeps no block of this plan on an SM")
        geometry[k] = {"threads": plan.threads, "smem_bytes": plan.smem_bytes,
                       "blocks_per_sm": blocks, **res, "bound_ms_wide": b["bound_ms"]}
        n_tiers = k7.tiers(NLAY, plan.seg_layers * plan.segments)
        print(f"geometry {k} ({mode} mode, {nang} angle(s)): {plan.threads} threads, "
              f"{plan.segments} per g-point of {plan.seg_layers} layers each, {plan.kept_tiers} of "
              f"{n_tiers} tier(s) kept in shared memory, {plan.smem_bytes} B of shared memory, "
              f"{res['registers']} registers, {res['spill_bytes']} B spill, {blocks} block(s) per "
              "SM by the runtime's occupancy call")
        wide[k] = cuda_ms(fn)
    return geometry, wide


def reset_counts():
    """Set every kernel's launch count to 0."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    k1.LAUNCHES = k2.LAUNCHES = k6.LAUNCHES = k7.LAUNCHES = 0
    for m in (k1.MODE_LAUNCHES, k2.MODE_LAUNCHES, k7.MODE_LAUNCHES, mlp.LAUNCHES):
        for k in m:
            m[k] = 0


def read_counts() -> dict:
    """After a synchronize, the kernels launched since reset_counts: k1, k2
    (all modes), k6, k7 (all modes; k7_angles and k7_fields by mode) and
    the MLP kernel's epilogues by name; kernels that were not launched are
    left out."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    torch.cuda.synchronize()
    c = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES, "k6": k6.LAUNCHES, "k7": k7.LAUNCHES,
         **{f"k7_{k}": v for k, v in k7.MODE_LAUNCHES.items()}, **mlp.LAUNCHES}
    return {k: v for k, v in c.items() if v}


def prep_phase(dev, lw_model, table, lw_spec, lw_in, main, model64, table64, card):
    """Phases 14 and 15: K6 against its twin at full size, then the prep LW
    core end to end. ``main`` maps top_at_1 to (data, fused LW fluxes, ...).
    Returns (K6's result entry, the launches of K6 and of K7's fields mode in
    the core runs, timings)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_broadband_sweeps
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    # ---- 14. K6 vs plain ----------------------------------------------------
    play_t, plev_t, tlay_t, tlev_t, tsfc, emis_band, concs_t = lw_in
    args = k6_args(dev, main[True][0], lw_model, table, lw_spec)
    _, x, col_dry, *_, g2b = args
    got = k6.lw_prep(*args)
    torch.cuda.synchronize()
    ref = k6.lw_prep_plain(*args)
    a64 = (model64(lw_model), x.double(), col_dry.double(), table64.interpolate(tlay_t.double()),
           table64.interpolate(tlev_t.double()), table64.interpolate(tsfc.double()), g2b)
    ref64 = k6.lw_prep_plain(*a64)
    # the largest g-point Planck source: fraction times band Planck value
    _, pf = mlp.fused_predict_lw_both_plain(lw_model, x, col_dry)
    idx = g2b.long()
    planck_max = max(float((pf * args[3][..., idx]).max()), float((pf * args[4][:-1][..., idx]).max()),
                     float(ref[3].max()))
    src_atol = float(f"{K6_SRC_REL * planck_max:.3e}")
    print(f"K6 lw_prep {NCOL}x{NLAY}x{lw_spec.ngpt}: largest g-point Planck source "
          f"{planck_max:.4f} W/m2/sr -> source bound {src_atol:.3e}")
    for o in got:
        require(bool(torch.isfinite(o).all()), "K6 output not finite")
    held = [hold("K6 trans", got[0], ref[0], ref64[0], MLP_RTOL, K6_TRANS_ATOL)]
    held += [hold(f"K6 {n}", g, r, r64, 0.0, src_atol)
             for n, g, r, r64 in zip(("src_dn", "src_up", "sfc_src"), got[1:], ref[1:], ref64[1:])]
    emis = lw_spec.expand(emis_band)
    fk = lw_broadband_sweeps(*got[:3], emis, got[3])
    fp = lw_broadband_sweeps(*ref[:3], emis, ref[3])
    e_sweep = max(maxabs(fk.flux_up, fp.flux_up), maxabs(fk.flux_dn, fp.flux_dn))
    print(f"K6: broadband sweeps on the kernel's and on the twin's fields differ by "
          f"{e_sweep:.3e} W/m2 (tol {LW_ATOL}); mean dn {float(fk.flux_dn.mean()):.4f}")
    require(e_sweep <= LW_ATOL, "the sweeps on K6's fields disagree with those on the twin's")
    ncell = NCOL * NLAY
    result = {"max_abs_err": max(h["max_abs_err"] for h in held), **bound(
        nbytes(*args[1:]) + model_bytes(lw_model) + nbytes(*got),
        mlp_flops(lw_model, ncell) + ELEMENT_FLOPS["k6"] * ncell * lw_spec.ngpt)}
    timed = {"k6": cuda_ms(lambda: k6.lw_prep(*args)),
             "k6_plain": cuda_ms(lambda: k6.lw_prep_plain(*args), reps=9)}

    # ---- 15. the prep LW core ------------------------------------------------
    launches = {"k6": 0, "k7_fields": 0}
    for top, (d, fused, _) in main.items():
        staged_in = rfmip.lw_staged_inputs(d, lw_spec, dev)
        reset_counts()
        fb = rfmip._lw_core_prep([lw_model], table, lw_spec, *staged_in, top_at_1=top)
        counts = read_counts()
        e = max(maxabs(fb.flux_up, fused.flux_up), maxabs(fb.flux_dn, fused.flux_dn))
        print(f"prep LW core top_at_1={top}: launches {counts}; vs the fused driver (K1) "
              f"{e:.3e} W/m2 (tol {LW_ATOL}); mean up {float(fb.flux_up.mean()):.4f} dn "
              f"{float(fb.flux_dn.mean()):.4f}")
        require(counts == {"k6": 1, "k7": 1, "k7_fields": 1},
                "_lw_core_prep did not launch K6 once and K7's fields mode once, and nothing else")
        require(tuple(fb.flux_up.shape) == (NCOL, NLAY + 1)
                and bool(torch.isfinite(fb.flux_up).all() and torch.isfinite(fb.flux_dn).all()),
                "_lw_core_prep output")
        require(e <= LW_ATOL, "the prep LW core disagrees with the fused LW driver")
        launches["k6"] += counts.get("k6", 0)
        launches["k7_fields"] += counts.get("k7_fields", 0)
    cpu, f64 = torch.device("cpu"), torch.float64
    small = rfmip_data_from_arrays(synthesize_rfmip(64, NLAY, SEED + 1, top_at_1=True))
    lw_cpu = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    t_cpu = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=cpu, dtype=f64)
    ref_fb = rfmip._lw_core_prep([lw_cpu], t_cpu, lw_spec,
                                 *rfmip.lw_staged_inputs(small, lw_spec, cpu, f64), top_at_1=True)
    got_fb = rfmip._lw_core_prep([lw_model], table, lw_spec,
                                 *rfmip.lw_staged_inputs(small, lw_spec, dev), top_at_1=True)
    e = max(maxabs(got_fb.flux_up.cpu(), ref_fb.flux_up), maxabs(got_fb.flux_dn.cpu(), ref_fb.flux_dn))
    print(f"prep LW core 64x{NLAY}: CUDA vs float64 on the CPU {e:.3e} W/m2 (tol {LW_ATOL})")
    require(e <= LW_ATOL, "the prep LW core on CUDA disagrees with float64 on the CPU")
    timed["lw_core_prep"] = cuda_ms(lambda: rfmip._lw_core_prep(
        [lw_model], table, lw_spec, *staged_in, top_at_1=False))
    for k, ms in timed.items():
        print(f"timing {k}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s at {NCOL}x{NLAY} | {card}")
    return result, launches, timed


def parallel_phase(dev, lw_model, sw_model, main):
    """Phase 16: the RFMIP drivers with scan_mode="parallel" against the
    sequential requests of phase 5 (fused) on the same data."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip

    import torch

    d, lw_seq, sw_seq = main[True]
    reset_counts()
    lw_par = rfmip.rfmip_clear_sky_lw(d, [lw_model], scan_mode="parallel", device=dev)
    c_lw = read_counts()
    reset_counts()
    sw_par = rfmip.rfmip_clear_sky_sw(d, [sw_model, sw_model], scan_mode="parallel", device=dev)
    c_sw = read_counts()
    e_lw = max(maxabs(lw_par.flux_up, lw_seq.flux_up), maxabs(lw_par.flux_dn, lw_seq.flux_dn))
    print(f"parallel-scan RFMIP requests: rfmip_clear_sky_lw launches {c_lw}, vs the sequential "
          f"request (K1) {e_lw:.3e} W/m2 (tol {LW_ATOL}); rfmip_clear_sky_sw launches {c_sw}")
    # the broadband LW solve does not read the scan mode: the transport kernel runs
    require(c_lw == {"fused_predict_lw_both": 1, "k7": 1, "k7_angles": 1}
            and c_sw == {"fused_predict_sw": 1},
            "the parallel-scan RFMIP requests did not take K3 + K7 and K5")
    require(e_lw <= LW_ATOL, "parallel-scan LW disagrees with the sequential request")
    for fb, names in ((lw_par, ("flux_up", "flux_dn")), (sw_par, ("flux_up", "flux_dn", "flux_dn_dir"))):
        for n in names:
            require(bool(torch.isfinite(getattr(fb, n)).all()), f"parallel-scan {n} not finite")
    # the general SW core takes K2's float64 two-stream coefficients
    # (pifm_coefficients): within SW_ATOL of the fused request in every column
    e_sw = hold_sw(sw_par, sw_seq, "parallel-scan SW vs the fused request")
    print(f"parallel-scan SW vs the sequential request (K2): {e_sw:.3e} W/m2 (tol {SW_ATOL} in "
          f"every column)")


def lut_phase(dev, card):
    """Phase 17: the lookup-table gas optics on the card with the solvers
    behind it, at full size and, against float64 on the CPU, at 64 columns.
    Returns the timings of its stages."""
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.gasoptics.lut_gas_optics import (
        compute_optimal_angles, gas_optics_lw_lut, gas_optics_sw_lut)
    from rte_rrtmgp_nn_tpu_torch.rte import rte_lw, rte_sw

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    with tempfile.TemporaryDirectory() as tmp:
        paths = testing.write_lut_files(tmp, LUT_GPTS_PER_BAND, SEED)
        t0 = time.perf_counter()
        kd = {k: load_kdist(p, testing.LUT_GASES, device=dev) for k, p in paths.items()}
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        kd64 = {k: load_kdist(p, testing.LUT_GASES, dtype=f64, device=cpu) for k, p in paths.items()}
        kd32 = {k: load_kdist(p, testing.LUT_GASES, device=cpu) for k, p in paths.items()}
    print(f"LUT k-distributions: LW {kd['lw'].ngpt} g-points in {kd['lw'].nband} bands, SW "
          f"{kd['sw'].ngpt} in {kd['sw'].nband}; kmajor {tuple(kd['lw'].kmajor.shape)}; loaded "
          f"onto the card in {t_load * 1e3:.1f} ms")
    require((kd["lw"].ngpt, kd["sw"].ngpt) == (256, 224) and kd["lw"].kmajor.is_cuda,
            "the k-distributions are not at the reference's width on the card")

    data = testing.synthesize_rfmip(NCOL, NLAY, SEED)
    reset_counts()
    out = testing.lut_fluxes(kd["lw"], kd["sw"], data, dev, f32)
    counts = read_counts()
    print(f"LUT path {NCOL}x{NLAY}: launches {counts} (lw_noscat_broadband once for each of "
          f"the 1-angle, {N_ANGLES}-angle and optimal-angle solves)")
    require(counts == {"k7": 3, "k7_angles": 3}, "the LUT LW solves did not launch K7 once each")
    for name, v in out.items():
        require(v.is_cuda, f"LUT path {name} is on {v.device}")
        require(bool(torch.isfinite(v).all()), f"LUT path {name} not finite")
        if name.endswith(("_up", "_dn", "_dir")):
            require(tuple(v.shape) == (NCOL, NLAY + 1), f"LUT path {name}: {tuple(v.shape)}")
    mu0 = testing.lut_inputs(data, cpu, f64)[5]
    toa = float(kd64["sw"].solar_source().sum()) * mu0
    rel = float(((out["sw_dn"][:, 0].double().cpu() - toa).abs() / toa).max())
    print(f"LUT path: mean LW up {float(out['lw1_up'].mean()):.4f} dn {float(out['lw1_dn'].mean()):.4f} "
          f"({N_ANGLES} angles dn {float(out['lw3_dn'].mean()):.4f}, optimal angles "
          f"{float(out['lwopt_dn'].mean()):.4f}, cloudy two-stream {float(out['lw2s_dn'].mean()):.4f}, "
          f"cloudy rescaled {float(out['lwtang_dn'].mean()):.4f}); SW up {float(out['sw_up'].mean()):.4f} "
          f"dn {float(out['sw_dn'].mean()):.4f} W/m2; SW TOA dn vs sum(solar)*mu0 max rel {rel:.2e}")
    require(rel <= 1e-5, f"LUT SW TOA down differs from sum(solar)*mu0 by {rel:.2e}")
    # the package's heating rate is +g/cp d(F_dn - F_up)/dp, as the JAX
    # package's: radiative cooling, which LW does to the stratosphere, is
    # POSITIVE in it (ROADMAP Queue 3, F4)
    strat = torch.as_tensor(data["play"] < 1.0e4)
    hr = out["hr_lw"].cpu()[strat]
    print(f"LUT path: LW heating rate above 100 hPa, the package's sign (cooling > 0): mean "
          f"{float(hr.mean()):.4f} K/day, {float((hr > 0).float().mean()):.4f} of the cells > 0")
    require(float(hr.mean()) > 0, "the mean LW heating rate of the stratosphere has the wrong sign")

    # per-stage times at full size (the slow PyTorch stages with fewer samples)
    play, plev, tlay, tlev, tsfc, mu0_d, gases = testing.lut_inputs(data, dev, f32)
    props, src = gas_optics_lw_lut(kd["lw"], play, plev, tlay, tsfc, gases, tlev=tlev)
    sw_props, sw_src = gas_optics_sw_lut(kd["sw"], play, plev, tlay, gases)
    emis = torch.full((NCOL, kd["lw"].nband), 0.97, device=dev)
    alb = torch.full((NCOL, kd["sw"].ngpt), 0.1, device=dev)
    slow = dict(reps=5, batch=3, warmup=1)
    timed = {
        "lut_gas_optics_lw": cuda_ms(lambda: gas_optics_lw_lut(
            kd["lw"], play, plev, tlay, tsfc, gases, tlev=tlev), **slow),
        "lut_rte_lw_1angle": cuda_ms(lambda: rte_lw(props, True, src, emis, broadband=True), reps=9),
        "lut_rte_lw_3angles": cuda_ms(lambda: rte_lw(props, True, src, emis, n_gauss_angles=N_ANGLES,
                                                     broadband=True), reps=9),
        "lut_optimal_angles": cuda_ms(lambda: compute_optimal_angles(kd["lw"], props.tau), reps=9),
        "lut_gas_optics_sw": cuda_ms(lambda: gas_optics_sw_lut(kd["sw"], play, plev, tlay, gases),
                                     **slow),
        "lut_rte_sw": cuda_ms(lambda: rte_sw(sw_props, True, mu0_d, sw_src.toa_source, alb, alb,
                                             broadband=True), **slow),
    }
    for k, ms in timed.items():
        print(f"timing {k}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s at {NCOL}x{NLAY} | {card}")

    # 64 columns: the card against float64 on the CPU; where the CPU's own
    # float32 run is beyond the bound (the two-stream LW source is
    # ill-conditioned in float32 for thin layers, ROADMAP Queue 3 F3), twice
    # its distance from float64 is the yardstick (testing.FLOAT32_SPREAD)
    small = testing.synthesize_rfmip(64, NLAY, SEED + 1)
    ref = testing.lut_fluxes(kd64["lw"], kd64["sw"], small, cpu, f64)
    own = testing.lut_fluxes(kd32["lw"], kd32["sw"], small, cpu, f32)
    got = testing.lut_fluxes(kd["lw"], kd["sw"], small, dev, f32)
    errs = {}
    for name, v in got.items():
        if name == "hr_lw" or name.startswith("sw_"):
            continue
        e = maxabs(v.cpu(), ref[name])
        e_own = maxabs(own[name], ref[name])
        errs[name] = e
        require(e <= max(LW_ATOL, testing.FLOAT32_SPREAD * e_own),
                f"LUT path {name}: CUDA is {e:.3e} W/m2 from float64 (CPU float32: {e_own:.3e})")
        if e > LW_ATOL:
            print(f"LUT path {name}: CUDA {e:.3e} W/m2 from float64, beyond {LW_ATOL}; the CPU's "
                  f"float32 run is {e_own:.3e} from it (F3: thin layers in the two-stream source)")
    sw_got = type("SW", (), dict(flux_up=got["sw_up"], flux_dn=got["sw_dn"], flux_dn_dir=got["sw_dir"]))
    sw_ref = type("SW", (), dict(flux_up=ref["sw_up"], flux_dn=ref["sw_dn"], flux_dn_dir=ref["sw_dir"]))
    e_sw = hold_sw(sw_got, sw_ref, "LUT SW")
    print(f"LUT path 64x{NLAY}: CUDA vs float64 on the CPU: LW "
          + ", ".join(f"{k[:-3]} {max(errs[k[:-3] + '_up'], errs[k[:-3] + '_dn']):.3e}"
                      for k in errs if k.endswith("_up"))
          + f" (tol {LW_ATOL}); SW {e_sw:.3e} W/m2 (tol {SW_ATOL} in every column)")
    return timed

GCM_NCOL, GCM_BLOCK = 1_036_800, 57_600  # scripts/bench_gcm.py's defaults: 18 blocks
GCM_SIDE_NCOL, GCM_RAGGED_NCOL = 115_200, 100_000
GCM_ATOL = 1e-4  # W/m2: the sweep against the all-sky drivers on the same columns
GCM_TWIN_COLUMNS = 14_400  # columns a plain-twin call takes at GCM block size (by_columns)


def sza_for_mu0(mu0: float) -> np.float32:
    """A float32 solar zenith angle whose cosine, as the GCM sweep takes it
    (float32 cos of float32 radians), is float32(mu0) exactly."""
    want = np.float32(mu0)
    s = np.float32(np.degrees(np.arccos(mu0)))
    for _ in range(256):
        got = np.cos(np.deg2rad(np.array([s], np.float32)))[0]
        if got == want:
            return s
        s = np.nextafter(s, np.float32(0 if got < want else 90))
    raise SmokeFailure(f"no float32 zenith angle has the cosine {want}")


def gcm_host(directory) -> tuple[dict, dict]:
    """The GCM columns of phase 20 and the files of the all-sky drivers:
    synthesize_gcm_columns over the RFMIP-size atmosphere of SEED, with
    the gases a Garand file carries; its first NCOL columns take the
    all-sky example's boundary conditions (emissivity 0.98, albedo 0.06,
    mu0 0.86, the surface at the lowest level's temperature) and are
    written as a Garand file. Returns (host, the paths of write_allsky_files
    with "garand" that file)."""
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky_io import GARAND_GASES
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.testing import garand_nc_variables, synthesize_rfmip
    from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

    base = synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=True)
    base["gases"] = {g: v for g, v in base["gases"].items() if g in GARAND_GASES}
    host = gcm.synthesize_gcm_columns(rfmip_data_from_arrays(base), GCM_NCOL, seed=SEED)
    head = slice(0, NCOL)
    host["sfc_emis"][head], host["sfc_alb"][head] = 0.98, 0.06
    host["tsfc"][head] = host["tlev"][head, -1]
    host["sza"][head] = sza_for_mu0(ALLSKY_MU0)
    paths = write_allsky_files(directory)
    garand = {"p_lay": host["play"][head].T, "p_lev": host["plev"][head].T,
              "t_lay": host["tlay"][head].T, "t_lev": host["tlev"][head].T}
    for k, v in host.items():
        if k.startswith("gas:"):
            v = v[head]
            garand[f"vmr_{k[4:]}"] = (v if v.ndim == 2 else np.broadcast_to(v[:, None], (NCOL, NLAY))).T
    paths["garand"] = os.path.join(directory, "garand-gcm-head.nc")
    write_nc(paths["garand"], *garand_nc_variables(
        {k: np.ascontiguousarray(v, np.float32) for k, v in garand.items()}))
    return host, paths


@contextlib.contextmanager
def kept_calls(sites: dict, keep):
    """Within the block, each kernel wrapper of ``sites`` ({tag: (module,
    attribute)}: the name the GCM path calls it through) keeps a copy of the
    arguments of its calls whose index ``keep`` picks, then launches as
    before. A copy, because a streamed block's views into its staging
    buffer are refilled by a later block; copies of strided views are
    contiguous. Yields {tag: [(args, kwargs), ...]}."""
    import torch

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        if type(x) in (list, tuple):
            return type(x)(copy(v) for v in x)
        return x

    kept = {tag: [] for tag in sites}
    saved = []
    for tag, (module, attr) in sites.items():
        fn = getattr(module, attr)
        calls = itertools.count()

        def wrapper(*a, _fn=fn, _tag=tag, _calls=calls, **kw):
            if keep(next(_calls)):
                kept[_tag].append((copy(a), {k: copy(v) for k, v in kw.items()}))
            return _fn(*a, **kw)

        saved.append((module, attr, fn))
        setattr(module, attr, wrapper)
    try:
        yield kept
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def by_columns(fn, args, kw, ncol: int):
    """fn's tuple of outputs on ``ncol`` columns, called GCM_TWIN_COLUMNS
    columns at a time (each tensor is cut on its first axis of size ncol)
    and joined on the outputs' column axis: the plain twins at GCM block
    size in a bounded share of the card's memory."""
    import torch

    def cut(x, s0, n):
        if torch.is_tensor(x):
            axis = next((i for i, m in enumerate(x.shape) if m == ncol), None)
            return x if axis is None else x.narrow(axis, s0, n)
        if type(x) in (list, tuple):
            return type(x)(cut(v, s0, n) for v in x)
        return x

    parts = []
    for s0 in range(0, ncol, GCM_TWIN_COLUMNS):
        n = min(GCM_TWIN_COLUMNS, ncol - s0)
        out = fn(*(cut(a, s0, n) for a in args), **{k: cut(v, s0, n) for k, v in kw.items()})
        parts.append((n, tuple(out)))
    n0, first = parts[0]
    axes = [o.shape.index(n0) for o in first]
    return tuple(torch.cat([p[i] for _, p in parts], dim=axes[i]) for i in range(len(first)))


def in_float64(args, kw) -> tuple[list, dict]:
    """The arguments of a kernel's plain twin in float64: tensors, nets
    (testing.float64_copy) and the Planck table; the cloud lookup-table pack
    stays as it is."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable
    from rte_rrtmgp_nn_tpu_torch.models.network import NNModel
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy

    nets = {}

    def up(x):
        if torch.is_tensor(x):
            return x.double() if x.is_floating_point() else x
        if isinstance(x, NNModel):
            if id(x) not in nets:
                nets[id(x)] = float64_copy(x)
            return nets[id(x)]
        if isinstance(x, PlanckTable):
            return PlanckTable(x.totplnk.double(), x.totplnk_diff.double(), x.temp_ref_min,
                               x.totplnk_delta)
        if type(x) in (list, tuple):
            return type(x)(up(v) for v in x)
        return x

    return [up(a) for a in args], {k: (v if k == "cld_lut" else up(v)) for k, v in kw.items()}


def gcm_hold_kept(what: str, kept: dict, blocks, phase: str = "gcm") -> None:
    """Each kept call of the GCM path (or of ``phase``'s path) launched
    again through its wrapper on the card and held against its plain twin
    on the same tensors, at the block's own column count (the one of
    ``blocks``, the sweep's block widths, that its arguments carry): K1, K2
    and K7 by the rule of phases 3, 4 and 8 (LW_ATOL, SW_ATOL, float64
    decides beyond), K3 and K5 by phase 7's (testing.hold_kernel; K5's ssa
    where tau is not an underflow residue)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.testing import bound_excess

    kernels = {"k1": (k1, "lw_clearsky_mega4", LW_ATOL), "k2": (k2, "sw_clearsky_megakernel", SW_ATOL),
               "k7": (k7, "lw_noscat_broadband_angles", LW_ATOL),
               "k3": (mlp, "fused_predict_lw_both", None), "k5": (mlp, "fused_predict_sw", None)}
    require(any(kept.values()), f"{phase} {what}: no kernel call was kept")
    for tag, calls in kept.items():
        module, name, tol = kernels[tag.split(":")[0]]
        kernel, twin = getattr(module, name), getattr(module, name + "_plain")
        for args, kw in calls:
            ncol = next(n for a in args if torch.is_tensor(a) for n in a.shape if n in blocks)
            label = f"{phase} {what} {tag} ({name}) on a block of {ncol} columns"
            got = tuple(kernel(*args, **kw))
            torch.cuda.synchronize()
            require(all(bool(torch.isfinite(o).all()) for o in got), f"{label}: not finite")
            ref = by_columns(twin, args, kw, ncol)
            ref64 = lambda a=args, k=kw, n=ncol: by_columns(twin, *in_float64(a, k), n)
            if tol is not None:
                e = max(maxabs(a, b) for a, b in zip(got, ref))
                print(f"{label}: max|kernel-twin| {e:.3e} W/m2 (tol {tol})")
                adjudicate_lazy(label, e, tol, got, ref, ref64)
                continue
            bounds = [(MLP_RTOL, 1e-8), (MLP_RTOL, 1e-9) if tag == "k3" else (0.0, SSA_ATOL)]
            pick = [slice(None), slice(None) if tag == "k3" else ref[0] > 1e-12]
            beyond = any(bound_excess(g[p], r[p], rt, at) > 1.0
                         for g, r, p, (rt, at) in zip(got, ref, pick, bounds))
            r64 = ref64() if beyond else ref
            for out, g, r, r6, p, (rt, at) in zip(("tau", "pfrac" if tag == "k3" else "ssa"),
                                                   got, ref, r64, pick, bounds):
                hold(f"{label} {out}", g[p], r[p], r6[p], rt, at)
        calls.clear()
    # the twins' memory back to the card before the next sweep allocates
    torch.cuda.empty_cache()


def device_us(e) -> float:
    """A torch.profiler key average's own device time (us), under either
    attribute name of the installed torch."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def profiled_calls(fn, calls: int = 3) -> tuple[float, float]:
    """``fn`` after one warm-up call, ``calls`` times under torch.profiler:
    (kernel launches a call, device busy ms a call), the memory copies and
    sets left out of both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
              and not e.key.startswith(("Memcpy", "Memset"))]
    require(events, "the profiler's trace holds no device time")
    return (sum(e.count for e in events) / calls,
            sum(device_us(e) for e in events) / 1e3 / calls)


def gcm_profile(sweep, nblocks: int, card: str) -> None:
    """One streamed sweep under torch.profiler: the device's idle share over
    the sweep (1 - kernel time / the sweep's time), the copies' time, and
    K1 + K2 per block against the block's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = sweep()
    window = r["elapsed_s"] * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    require(events, "the profiler's trace of the GCM sweep holds no device time")
    copies = sum(device_us(e) for e in events if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernels = sum(device_us(e) for e in events if not e.key.startswith(("Memcpy", "Memset"))) / 1e3
    mega = {k: sum(device_us(e) for e in events if f"{k}_mega_kernel" in e.key) / 1e3
            for k in ("lw", "sw")}
    launches = sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset")))
    print(f"gcm profile, one streamed sweep: window {window:.1f} ms, kernels {kernels:.1f} ms "
          f"({launches / nblocks:.1f} launches a block), copies {copies:.1f} ms, idle share "
          f"{1 - kernels / window:.4f}; K1 + K2 {(mega['lw'] + mega['sw']) / nblocks:.3f} ms a "
          f"block (K1 {mega['lw'] / nblocks:.3f}, K2 {mega['sw'] / nblocks:.3f}) of a "
          f"{window / nblocks:.3f} ms window | {card}")
    for e in sorted(events, key=device_us, reverse=True)[:6]:
        print(f"gcm profile kernel {e.key[:60]!r}: {device_us(e) / 1e3 / nblocks:.3f} ms a block, "
              f"{e.count / nblocks:.1f} launches a block")


def gcm_phase(dev, lw_model, sw_model, card) -> None:
    """Phase 20: the GCM sweep at GCM_NCOL columns x NLAY layers in blocks
    of GCM_BLOCK, each sweep's launches counted around it."""
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, fused, gcm
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    t_phase = time.perf_counter()
    nblocks = -(-GCM_NCOL // GCM_BLOCK)
    sw_pair = [sw_model, sw_model]
    # where the GCM step calls each kernel's wrapper (kept_calls)
    fused_sites = {"k1": (fused, "lw_clearsky_mega4"), "k2": (fused, "sw_clearsky_megakernel")}
    staged_sites = {"k3": (mlp, "fused_predict_lw_both"), "k7": (k7, "lw_noscat_broadband_angles"),
                    "k5": (mlp, "fused_predict_sw")}
    first = lambda i: i == 0
    with tempfile.TemporaryDirectory() as tmp:
        host, paths = gcm_host(tmp)
        co = {k: allsky.load_cloud_optics_checked(paths[k], device=dev)
              for k in ("lw_lut", "sw_lut", "lw_pade", "sw_pade")}
        t_host = time.perf_counter() - t_phase
        sky = lambda h, flavour="lut", **kw: gcm.gcm_sweep_allsky(
            h, [lw_model], sw_pair, co[f"lw_{flavour}"], co[f"sw_{flavour}"],
            block_size=GCM_BLOCK, device=dev, **kw)

        def counted(fn):
            reset_counts()
            r = fn()
            c = read_counts()
            c.update({f"k1_{k}": v for k, v in k1.MODE_LAUNCHES.items() if v})
            c.update({f"k2_{k}": v for k, v in k2.MODE_LAUNCHES.items() if v})
            return r, c

        def line(name, r):
            gbs = r["bytes_per_column"] * r["ncol"] / r["elapsed_s"] / 1e9
            print(f"gcm {name}: {r['ncol']} x {NLAY} in {r['elapsed_s']:.3f} s, "
                  f"{r['columns_per_s']:.0f} columns/s, {r['bytes_per_column']:.1f} H2D bytes a "
                  f"column, {gbs:.2f} GB/s over the sweep | {card}")

        # the fused route, lookup-table clouds: K1 and K2 once a block each;
        # the first sweep also allocates the pinned staging and result buffers
        line("all-sky streamed f32, first sweep", sky(host))
        f32, c = counted(lambda: sky(host))
        line("all-sky streamed f32 (K1 + K2 cld_lut)", f32)
        print(f"gcm all-sky streamed f32 launches: {c}")
        require(c == {"k1": nblocks, "k2": nblocks, "k1_cld_lut": nblocks, "k2_cld_lut": nblocks},
                f"the streamed GCM sweep did not launch K1 and K2 once a block in the cld_lut "
                f"mode and nothing else: {c}")
        diag = f32["diagnostics"]
        require(diag.shape == (GCM_NCOL, 3) and np.isfinite(diag).all(),
                "GCM diagnostics not finite or of the wrong shape")
        # the host link's rate for one block from pinned memory
        nbytes = int(f32["bytes_per_column"] * GCM_BLOCK)
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        on_dev = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        ms = cuda_ms(lambda: on_dev.copy_(pinned, non_blocking=True), reps=5, batch=4)
        print(f"gcm H2D: one block of {nbytes / 1e6:.1f} MB from pinned memory in {ms:.3f} ms, "
              f"{nbytes / ms / 1e6:.2f} GB/s | {card}")
        del pinned, on_dev
        # the resident sweep runs block 0 once before its timer starts: its
        # K1 and K2 calls are kept and held against the twins
        with kept_calls(fused_sites, first) as kept:
            resident = sky(host, resident=True)
        line("all-sky resident f32", resident)
        gcm_hold_kept("all-sky block 0 (cld_lut)", kept, {GCM_BLOCK})
        require(np.array_equal(resident["diagnostics"], diag),
                "the resident GCM sweep differs from the streamed one")
        mixed = sky(host, precision="mixed")
        line("all-sky streamed mixed", mixed)
        e_mixed = float(np.abs(mixed["diagnostics"] - diag).max())
        mu0 = np.cos(np.deg2rad(host["sza"]))
        night = mu0 <= 0.0
        require(night.any() and ((mu0 > 0) & (mu0 <= 0.1)).any(),
                "the GCM columns hold no night or no grazing sun")
        zero = all(np.all(d[night, 2] == 0.0) for d in (diag, mixed["diagnostics"]))
        print(f"gcm mixed vs f32: max {e_mixed:.3e} W/m2 (tol 0.05); night SW of "
              f"{int(night.sum())} columns exactly 0: {zero}; means olr {f32['mean_olr']:.4f} "
              f"lw_sfc_dn {f32['mean_lw_sfc_dn']:.4f} sw_sfc_dn {f32['mean_sw_sfc_dn']:.4f}")
        require(e_mixed <= 0.05, "the mixed-precision GCM sweep is beyond 0.05 W/m2 of f32")
        require(zero, "night SW of the GCM sweep is not exactly 0")
        del mixed, resident

        # the first NCOL columns against the all-sky drivers on the same columns
        lw = allsky.allsky_lw(paths["garand"], paths["lw_lut"], [lw_model], ncol=NCOL, device=dev)
        sw = allsky.allsky_sw(paths["garand"], paths["sw_lut"], sw_pair, ncol=NCOL, device=dev)
        ref = torch.stack([lw.flux_up[:, 0], lw.flux_dn[:, -1], sw.flux_dn[:, -1]], 1).cpu().numpy()
        e_drv = np.abs(diag[:NCOL] - ref).max(0)
        print(f"gcm first {NCOL} columns vs allsky_lw / allsky_sw: olr {e_drv[0]:.3e}, lw_sfc_dn "
              f"{e_drv[1]:.3e}, sw_sfc_dn {e_drv[2]:.3e} W/m2 (tol {GCM_ATOL})")
        require(e_drv.max() <= GCM_ATOL, "the GCM sweep disagrees with the all-sky drivers")

        # clear-sky LW: K1 once a block
        lw_s, c = counted(lambda: gcm.gcm_sweep_lw(host, [lw_model], block_size=GCM_BLOCK,
                                                   device=dev))
        line("LW streamed f32 (K1 clear)", lw_s)
        require(c == {"k1": nblocks, "k1_clear": nblocks},
                f"the LW GCM sweep did not launch K1 once a block and nothing else: {c}")
        with kept_calls({"k1:clear": (fused, "lw_clearsky_mega4")}, first) as kept:
            lw_r = gcm.gcm_sweep_lw(host, [lw_model], block_size=GCM_BLOCK, resident=True,
                                    device=dev)
        line("LW resident f32", lw_r)
        gcm_hold_kept("LW block 0 (clear)", kept, {GCM_BLOCK})
        require(np.array_equal(lw_s["diagnostics"], lw_r["diagnostics"]),
                "the resident LW GCM sweep differs from the streamed one")
        del lw_s, lw_r

        # the device's idle share over one streamed sweep
        gcm_profile(lambda: sky(host), nblocks, card)

        # GCM_SIDE_NCOL columns: Pade clouds (the band modes) and the staged route
        side = {k: v[:GCM_SIDE_NCOL] for k, v in host.items()}
        nside = -(-GCM_SIDE_NCOL // GCM_BLOCK)
        pade, c = counted(lambda: sky(side, flavour="pade"))
        line("all-sky streamed f32, Pade (K1 + K2 cld_bands)", pade)
        require(c == {"k1": nside, "k2": nside, "k1_cld_bands": nside, "k2_cld_bands": nside},
                f"the Pade GCM sweep did not launch K1 and K2 once a block in the cld_bands mode: {c}")
        pd = pade["diagnostics"]
        require(np.isfinite(pd).all() and np.all(pd[night[:GCM_SIDE_NCOL], 2] == 0.0),
                "the Pade GCM sweep is not finite or its night SW not 0")
        with kept_calls(fused_sites, first) as kept:
            sky({k: v[:GCM_BLOCK] for k, v in host.items()}, flavour="pade")
        gcm_hold_kept("all-sky Pade block 0 (cld_bands)", kept, {GCM_BLOCK})
        with config_override(use_megakernel=False):
            staged, c = counted(lambda: sky(side))
        line("all-sky streamed f32, staged route (K3 + K7, K5)", staged)
        require(c == {"fused_predict_lw_both": nside, "k7": nside, "k7_angles": nside,
                      "fused_predict_sw": nside},
                f"the staged GCM sweep did not launch K3, K7 and K5 once a block: {c}")
        st = staged["diagnostics"]
        e_lw = float(np.abs(st[:, :2] - diag[:GCM_SIDE_NCOL, :2]).max())
        print(f"gcm staged vs fused route on {GCM_SIDE_NCOL} columns: LW {e_lw:.3e} W/m2 "
              f"(tol {LW_ATOL})")
        require(e_lw <= LW_ATOL, "the staged GCM route's LW disagrees with the fused one")
        e_sw = hold_columns("gcm staged vs fused SW", np.abs(st[:, 2] - diag[:GCM_SIDE_NCOL, 2]))
        print(f"gcm staged vs fused SW: max {e_sw:.3e} W/m2 (tol {SW_ATOL} in every column)")
        del side, pade, staged

        # a ragged last block against the same columns in one block
        rag = {k: v[:GCM_RAGGED_NCOL] for k, v in host.items()}
        widths = {GCM_BLOCK, GCM_RAGGED_NCOL - GCM_BLOCK}
        with kept_calls(fused_sites, lambda i: i == 1) as kept:
            blocks = sky(rag)
        gcm_hold_kept("all-sky ragged last block (cld_lut)", kept, widths)
        # the staged route's kernels on both blocks of the same sweep
        with config_override(use_megakernel=False), kept_calls(staged_sites, lambda i: True) as kept:
            sky(rag)
        gcm_hold_kept("all-sky staged route", kept, widths)
        whole = gcm.gcm_sweep_allsky(rag, [lw_model], sw_pair, co["lw_lut"], co["sw_lut"],
                                     block_size=GCM_RAGGED_NCOL, device=dev)
        e_rag = float(np.abs(blocks["diagnostics"] - whole["diagnostics"]).max())
        print(f"gcm ragged: {GCM_RAGGED_NCOL} columns in blocks of {GCM_BLOCK} (the last "
              f"{GCM_RAGGED_NCOL - GCM_BLOCK}) vs one block: max {e_rag:.3e} W/m2 (tol {GCM_ATOL})")
        require(e_rag <= GCM_ATOL, "the ragged GCM sweep differs from the one-block sweep")
    print(f"gcm phase: {time.perf_counter() - t_phase:.1f} s (host columns and files "
          f"{t_host:.1f} s) | {card}")


# phase 21: the training recipe of artifacts/lw-synth64-lut_both_128_128_*.nc
# (scripts/train_from_lut.py), a few epochs of a few steps
TRAIN_NEXP, TRAIN_NSITES = 18, 100      # RFMIP's experiments x 100 sites = 1800 columns
TRAIN_EPOCHS, TRAIN_STEPS = 3, 50
TRAIN_PAIRS, TRAIN_HIDDEN, TRAIN_LR = 1024, 128, 1e-3
TRAIN_ALPHA, TRAIN_EMA = 0.85, 0.999
# the card's five float32 steps against the CPU's: the losses within rtol
# 1e-4 (float32 matmuls summed in other orders); the weights, 99.9% of them
# within 1e-5, every one within 2 x 5 x lr (one Adam step moves a weight by
# about lr at most, so two runs whose gradient components near 0 take
# opposite signs part by at most that)
TRAIN_LOSS_RTOL, TRAIN_W_ATOL = 1e-4, 1e-5


def train_profile(step, evaluate, card, n_steps: int = 20) -> None:
    """``n_steps`` training steps (each with its batch gather) and one eval
    under torch.profiler: each window on the host clock, the device's
    kernel time and launches in it, the idle share, and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    for tag, fn, n in (("step", step, n_steps), ("eval", evaluate, 1)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.no_grad() if tag == "eval" else contextlib.nullcontext():
                for _ in range(n):
                    fn()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3 / n
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
        require(events, f"the profiler's trace of the training {tag} holds no device time")
        busy = sum(dev_us(e) for e in events) / 1e3 / n
        launches = sum(e.count for e in events) / n
        top = sorted(events, key=dev_us, reverse=True)[:4]
        print(f"training profile, one {tag}: window {window:.4f} ms, device busy {busy:.4f} ms "
              f"({launches:.1f} kernels and copies), idle share {1 - busy / window:.4f}; most "
              "time: " + ", ".join(f"{e.key[:40]!r} {dev_us(e) / 1e3 / n:.4f} ms"
                                   for e in top) + f" | {card}")


def training_phase(dev, card) -> None:
    """Phase 21: NN training with radiation-in-the-loop evaluation on the
    card (training/*, scripts/torch_train_from_lut.py's recipe): the LUT LW
    gendata at 18 experiments x 100 sites x 60 layers on a synthetic
    64-g-point k-distribution (K7 once) against float64 on the CPU; a fresh
    "lw_both" net 7 -> 128 -> 128 -> 128 trained for TRAIN_EPOCHS epochs of
    TRAIN_STEPS steps (Adam with cosine decay, hybrid loss, EMA) through
    train_with_radiation_eval, each eval counted (K3 once, K7 once); after
    the last step K3 and K7 on the eval's own inputs against their twins,
    K1 through rfmip_clear_sky_lw on the trained net against its twin and
    against the same weights loaded fresh (0 W/m2: the kept first-layer
    split and the kernel's net follow the weights the steps changed in
    place); the best model saved and reloaded (bit-identical fluxes); five
    steps on the card against the same five on the CPU; K3 refusing a
    weight that requires grad. The features' scaling is numpy on the host,
    as in the JAX script; the CPU runs only the stated references."""
    import glob
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import compute_planck_source_nn
    from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, save_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
    from rte_rrtmgp_nn_tpu_torch.training.eval_loop import train_with_radiation_eval
    from rte_rrtmgp_nn_tpu_torch.training.gendata import generate_lw_training_data
    from rte_rrtmgp_nn_tpu_torch.training.train import (
        TrainState, cosine_decay_schedule, init_model, make_train_step, scheduled)

    cpu, f64 = torch.device("cpu"), torch.float64
    t_phase = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the training matmuls")
    data = rfmip_data_from_arrays(testing.synthesize_rfmip_experiments(
        TRAIN_NEXP, TRAIN_NSITES, NLAY, SEED))
    ncol = data.ncol
    with tempfile.TemporaryDirectory() as tmp:
        kpath = os.path.join(tmp, "kdist-synthetic-lw-g4.nc")
        generate_kdist_nc(kpath, kind="lw", gpts_per_band=4, nband=16)
        kd = load_kdist(kpath, R.GASES, device=dev)
        ngpt = kd.ngpt
        require(ngpt == 64 and kd.kmajor.is_cuda, "the recipe's k-distribution is not 64 g-points "
                                                  "on the card")

        # -- gendata on the card, against float64 on the CPU ------------------
        train_nc = os.path.join(tmp, "lw_train_data.nc")
        reset_counts()
        t0 = time.perf_counter()
        gen = generate_lw_training_data(train_nc, kd, data, gas_order=R.GASES)
        t_first = time.perf_counter() - t0
        counts = read_counts()
        require(counts == {"k7": 1, "k7_angles": 1}, f"gendata launched {counts}, not K7 once")
        t0 = time.perf_counter()
        generate_lw_training_data(os.path.join(tmp, "again.nc"), kd, data, gas_order=R.GASES)
        t_gendata = time.perf_counter() - t0
        ref = {}
        for tag, dtype in (("f64", f64), ("f32", torch.float32)):
            kd_cpu = load_kdist(kpath, R.GASES, dtype=dtype, device=cpu)
            ref[tag] = generate_lw_training_data(os.path.join(tmp, f"{tag}.nc"), kd_cpu, data,
                                                 gas_order=R.GASES)
        for n in ("rsu", "rsd"):
            e = float(np.abs(gen[n].astype(np.float64) - ref["f64"][n]).max())
            e_own = float(np.abs(ref["f32"][n].astype(np.float64) - ref["f64"][n]).max())
            print(f"training gendata {n}: card vs float64 on the CPU {e:.3e} W/m2, the CPU's "
                  f"float32 {e_own:.3e} (tol max({LW_ATOL}, {testing.FLOAT32_SPREAD} x the "
                  "CPU's float32))")
            require(np.isfinite(gen[n]).all() and e <= max(LW_ATOL, testing.FLOAT32_SPREAD * e_own),
                    f"training gendata {n} is {e:.3e} W/m2 from float64")
        print(f"training gendata {TRAIN_NEXP}x{TRAIN_NSITES}x{NLAY}, {ngpt} g-points: "
              f"{t_gendata * 1e3:.1f} ms (first call {t_first * 1e3:.1f} ms, launches {counts}), "
              f"file written and read back | {card}")

        # -- training through train_with_radiation_eval -------------------------
        ts = R.lw_training_set(train_nc, ngpt)
        fresh_net = lambda device: init_model(
            [ts.xs.shape[-1], TRAIN_HIDDEN, TRAIN_HIDDEN, 2 * ngpt],
            torch.Generator().manual_seed(SEED), input_names=("tlay", "play") + R.GASES,
            input_min=ts.xmin, input_max=ts.xmax, output_mean=ts.out_mean,
            output_std=ts.out_std, device=device)
        model = fresh_net(dev)
        ev = R.LWFluxEval(kd, data, ts, gen["rsu"].reshape(ncol, -1),
                          gen["rsd"].reshape(ncol, -1), dev)
        lw_driver = lambda m: rfmip.rfmip_clear_sky_lw(data, [m], spectral=kd.spectral,
                                                       planck_table=kd.planck, device=dev)
        with torch.no_grad():  # the caches the steps must not leave stale
            lw_driver(model)
            ev.fluxes(model)
        total = TRAIN_EPOCHS * TRAIN_STEPS
        schedule = cosine_decay_schedule(TRAIN_LR, total, alpha=1e-2)
        make_state = lambda m: (lambda o: TrainState(m, o, scheduler=scheduled(o, schedule)))(
            torch.optim.Adam(m.parameters(), lr=TRAIN_LR, eps=1e-8))
        state = make_state(model)
        inner = make_train_step(alpha=TRAIN_ALPHA)
        pairs = R.pair_index(TRAIN_PAIRS, dev)
        xs = torch.as_tensor(ts.xs, dtype=torch.float32, device=dev)
        ys = torch.as_tensor(ts.ys, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(SEED)
        step_events, eval_ms, eval_counts = [], [], []

        def data_iter():
            idx = R.sample_pair_rows(rng, TRAIN_NEXP, TRAIN_NSITES, NLAY, TRAIN_PAIRS)
            idx = torch.as_tensor(idx, device=dev)
            return xs[idx], ys[idx]

        def train_step(st, x, y):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = inner(st, x, y, pairs)
            ev1.record()
            step_events.append((ev0, ev1))
            return out

        def eval_fn(m):
            reset_counts()
            t0 = time.perf_counter()
            metrics = ev.metrics(m)
            eval_ms.append((time.perf_counter() - t0) * 1e3)
            eval_counts.append(read_counts())
            return metrics

        t0 = time.perf_counter()
        result = train_with_radiation_eval(
            state, train_step, data_iter, eval_fn, R.REF_SCORES, n_epochs=TRAIN_EPOCHS,
            steps_per_epoch=TRAIN_STEPS, patience=TRAIN_EPOCHS, verbose=False,
            ema_decay=TRAIN_EMA, save_path=os.path.join(
                tmp, f"lw-synth{ngpt}-lut_both_{TRAIN_HIDDEN}_{TRAIN_HIDDEN}_HR_{{hr}}_FRC_{{frc}}.nc"))
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        med = statistics.median(step_ms)
        hist = result.history
        print(f"training: {len(hist)} epochs x {TRAIN_STEPS} steps of {2 * TRAIN_PAIRS} rows "
              f"(net {model.dims}, Adam lr {TRAIN_LR} cosine, hybrid alpha {TRAIN_ALPHA}, EMA "
              f"{TRAIN_EMA}): losses {[round(h['loss'], 5) for h in hist]}, radiation scores "
              f"{[round(h['score'], 3) for h in hist]}, best epoch {result.best_epoch}")
        print(f"training step: median {med:.4f} ms by CUDA events (min {min(step_ms):.4f}, max "
              f"{max(step_ms):.4f}), {1e3 / med:.1f} steps/s, {2 * TRAIN_PAIRS * 1e3 / med:.0f} "
              f"rows/s | {card}")
        print(f"training eval: {statistics.median(eval_ms):.3f} ms per epoch (median of "
              f"{len(eval_ms)}: {[round(v, 3) for v in eval_ms]}), launches per eval "
              f"{eval_counts} | {card}")
        print(f"training loop: {t_loop:.2f} s for {total} steps and {len(hist)} evals | {card}")
        train_profile(lambda: inner(state, *data_iter(), pairs), lambda: ev.metrics(
            result.best_model), card)
        require(len(hist) == TRAIN_EPOCHS and all(np.isfinite(h["score"]) for h in hist),
                "a training epoch gave no finite radiation score")
        require(all(c == {"fused_predict_lw_both": 1, "k7": 1, "k7_angles": 1}
                    for c in eval_counts), f"an eval did not launch K3 once and K7 once: "
                                           f"{eval_counts}")

        # -- save and reload: bit-identical fluxes --------------------------------
        (saved,) = glob.glob(os.path.join(tmp, f"lw-synth{ngpt}-lut_both_*_HR_*.nc"))
        again = load_model_netcdf(saved, device=dev)
        with torch.no_grad():
            same = all(torch.equal(a, b) for a, b in zip(ev.fluxes(result.best_model),
                                                         ev.fluxes(again)))
        print(f"training save/reload: {os.path.basename(saved)} loads back with bit-identical "
              f"fluxes: {same}")
        require(same, "the saved best model does not give the same fluxes back")

        # -- K3 and K7 against their twins after the steps -----------------------
        live = state.model
        with torch.no_grad():
            for tag, m in (("trained net", live), ("best (EMA) net", result.best_model)):
                got = mlp.fused_predict_lw_both(m, ev.x, ev.col_dry)
                twin = mlp.fused_predict_lw_both_plain(m, ev.x, ev.col_dry)
                twin64 = mlp.fused_predict_lw_both_plain(
                    testing.float64_copy(m), ev.x.double(), ev.col_dry.double())
                for n, g, r, r64, a in zip(("tau", "pfrac"), got, twin, twin64, (1e-8, 1e-9)):
                    hold(f"training K3 {tag} {n}", g, r, r64, MLP_RTOL, a)
            tau, pfrac = mlp.fused_predict_lw_both(live, ev.x, ev.col_dry)
            lay, lev, sfc, _ = compute_planck_source_nn(pfrac, ev.tlay, ev.tlev, ev.tsfc,
                                                        kd.spectral, kd.planck)
            emis = kd.spectral.expand(ev.emis).contiguous()
            one = ([plw.LW_DIFFUSIVITY], [plw.LW_WEIGHT])
            got = k7.lw_noscat_broadband_angles(tau, lay, lev, emis, sfc, *one)
            twin = k7.lw_noscat_broadband_angles_plain(tau, lay, lev, emis, sfc, *one)
            e7 = max(maxabs(a, b) for a, b in zip(got, twin))
            print(f"training K7 on the trained net's eval inputs: max|kernel-twin| {e7:.3e} W/m2 "
                  f"(tol {LW_ATOL})")
            require(e7 <= LW_ATOL, f"training K7 differs from its twin by {e7:.3e} W/m2")

            # -- K1 through the driver on the trained net: twin and a fresh load --
            reset_counts()
            fl = lw_driver(live)
            counts = read_counts()
            require(counts == {"k1": 1}, f"rfmip_clear_sky_lw on the trained net launched {counts}")
            args, _ = fused.lw_args([live], kd.planck, kd.spectral,
                                    *rfmip.lw_canonical_inputs(data, kd.spectral, dev))
            up_p, dn_p = k1.lw_clearsky_mega4_plain(*args)
            e1 = max(maxabs(fl.flux_up, up_p), maxabs(fl.flux_dn, dn_p))
            adjudicate_lazy("training K1", e1, LW_ATOL, (fl.flux_up, fl.flux_dn), (up_p, dn_p),
                            lambda: k1.lw_clearsky_mega4_plain(*in_float64(args, {})[0]))
            save_model_netcdf(os.path.join(tmp, "trained.nc"), live)
            fresh = load_model_netcdf(os.path.join(tmp, "trained.nc"), device=dev)
            ff = lw_driver(fresh)
            e_fresh = max(maxabs(fl.flux_up, ff.flux_up), maxabs(fl.flux_dn, ff.flux_dn))
            print(f"training K1 (rfmip_clear_sky_lw, {ngpt} g-points) on the trained net: "
                  f"launches {counts}, max|kernel-twin| {e1:.3e} W/m2 (tol {LW_ATOL}); against "
                  f"the same weights loaded fresh {e_fresh:.3e} W/m2 (0 expected); mean dn "
                  f"{float(fl.flux_dn.mean()):.4f}")
            require(e_fresh == 0.0, f"K1 on the trained net is {e_fresh:.3e} W/m2 from the same "
                                    "weights loaded fresh: a kept copy went stale")

        # -- a weight that requires grad, with grad enabled: K3 refuses --------
        n0 = mlp.LAUNCHES["fused_predict_lw_both"]
        try:
            with torch.enable_grad():
                mlp.fused_predict_lw_both(live, ev.x, ev.col_dry)
            refused = ""
        except ValueError as e:
            refused = str(e)
        print(f"training K3 with grad enabled and trainable weights: refused: {refused!r}")
        require(refused.startswith("fused_predict_lw_both: ")
                and mlp.LAUNCHES["fused_predict_lw_both"] == n0,
                "K3 ran with grad enabled on weights that require grad")

    # -- five float32 steps on the card against the same five on the CPU ------
    rng = np.random.default_rng(SEED + 1)
    rows = [R.sample_pair_rows(rng, TRAIN_NEXP, TRAIN_NSITES, NLAY, TRAIN_PAIRS) for _ in range(5)]
    runs = {}
    for device in (dev, cpu):
        st = make_state(fresh_net(device))
        X, Y = torch.as_tensor(ts.xs, device=device), torch.as_tensor(ts.ys, device=device)
        P = R.pair_index(TRAIN_PAIRS, device)
        losses = []
        for r in rows:
            i = torch.as_tensor(r, device=device)
            losses.append(float(inner(st, X[i], Y[i], P)[1]))
        runs[device.type] = (np.array(losses), torch.cat([p.detach().cpu().reshape(-1)
                                                          for p in st.model.parameters()]))
    (lc, wc), (lp, wp) = runs["cuda"], runs["cpu"]
    gap = (wc - wp).abs()
    loss_rel = float(np.abs(lc / lp - 1).max())
    share = float((gap <= TRAIN_W_ATOL).double().mean())
    print(f"training card vs CPU, 5 float32 steps from the same init on the same rows: losses "
          f"{lc.round(6).tolist()} vs {lp.round(6).tolist()} (max rel {loss_rel:.3e}, tol "
          f"{TRAIN_LOSS_RTOL}); weights max |gap| {float(gap.max()):.3e}, 99.9th percentile "
          f"{float(gap.quantile(0.999)):.3e}, share within {TRAIN_W_ATOL} {share:.6f}")
    require(loss_rel <= TRAIN_LOSS_RTOL and share >= 0.999
            and float(gap.max()) <= 2 * 5 * TRAIN_LR,
            "the card's training steps part from the CPU's beyond the stated tolerance")
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s | {card}")


# phase 22: the column split over ranks (parallel/distributed.py, the sharded
# fused cores, the dry run and the multichip bench), at the main path's size
SCRIPTS = os.path.join(HERE, "scripts")
BENCH_COLS = 1824  # columns a card, bench_multichip.py's default


def sharded_rank(arrays):
    """What each of phase 22's two ranks sharing the card runs (gloo): the
    sharded fused cores on the main path's inputs, this rank's block and
    the gathered whole, with K1 and K2 counted; then the dry run's three
    stages (scripts/torch_dryrun_multichip.py), with every kernel counted."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SCRIPTS)
    import torch_dryrun_multichip as D
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, spectral_for, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.parallel.distributed import global_mesh
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding

    mesh = global_mesh()
    dev = mesh.devices[0]
    data = rfmip_data_from_arrays(arrays)
    ((_, c0, nc),) = column_sharding(mesh, 2).split(data.ncol)
    block = data.block(c0, nc)
    lw = load_model_netcdf(LW_MODEL, device=dev)
    sw = load_model_netcdf(SW_MODEL, device=dev)
    spec = spectral_for("lw", [lw], entry="sharded_rank", accepts=(lw_spectral_g128,))
    sspec = spectral_for("sw", [sw, sw], entry="sharded_rank", accepts=(sw_spectral_g112,))
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32, device=dev)
    lw_fn = rfmip.lw_mega_core_sharded(mesh, [lw], table, spec, data.top_at_1)
    sw_fn = rfmip.sw_mega_core_sharded(mesh, [sw, sw], sspec, solar, data.top_at_1)
    li, si = rfmip.lw_canonical_inputs(block, spec, dev), rfmip.sw_canonical_inputs(block, dev)
    out = {"rank": dist.get_rank(), "device": str(dev), "mesh": mesh.shape,
           "ready_s": time.perf_counter() - T_IMPORT}
    with torch.no_grad():
        lw_fn(*li), sw_fn(*si)  # the first calls load the kernels
        reset_counts()
        out["lw"] = [t.cpu().numpy() for t in lw_fn(*li)]
        out["sw"] = [t.cpu().numpy() for t in sw_fn(*si)]
        out["counts"] = read_counts()
        out["lw_all"] = [t.cpu().numpy() for t in lw_fn(*li, gather=True)]
        out["sw_all"] = [t.cpu().numpy() for t in sw_fn(*si, gather=True)]
    out["sharded_s"] = time.perf_counter() - T_IMPORT - out["ready_s"]
    dist.barrier()
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401  (the first optimizer step of a process imports it)
    out["dynamo_import_s"] = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    out["dryrun"] = D.rank_main(NCOL, NLAY)
    out["dryrun_counts"] = read_counts()
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def sharded_phase(dev, card, lw_model, sw_model, table, lw_spec, sw_spec, solar, lw_in,
                  sw_in) -> dict:
    """Phase 22: (a) a process group of one (NCCL, this process):
    lw_mega_core_sharded / sw_mega_core_sharded on the main path's inputs
    against the unsharded fused cores (0 W/m2 expected: K1's and K2's
    launch plans do not depend on the columns), one K1 and one K2 launch a
    call, both timed; (b) two ranks spawned on the one card (gloo, which
    stages its CUDA collectives through the host): each rank's block and the
    gathered fluxes against (a), K1 and K2 once a rank a call; (c) the dry
    run's three stages on the same two ranks (the training step, the
    g-point-split staged forward: K3 + K7 a rank, the fused core: K1);
    (d) scripts/torch_bench_multichip.py at one card, --core mega (with
    its profiler window) and --core staged, BENCH_COLS columns a card."""
    import torch
    import torch.distributed as dist

    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    sys.path.insert(0, SCRIPTS)
    import torch_bench_multichip as B
    import torch_dryrun_multichip as D

    t_phase = time.perf_counter()
    times = {}
    # ---- (a) world size 1 ----
    fl = fused.lw_core([lw_model], table, lw_spec, *lw_in, top_at_1=True)
    fs = rfmip._sw_core_mega_canon([sw_model, sw_model], solar, *sw_in, top_at_1=True)
    want = {"lw": (fl.flux_up, fl.flux_dn), "sw": (fs.flux_up, fs.flux_dn, fs.flux_dn_dir)}
    pdist.initialize(f"127.0.0.1:{pdist.free_port()}", 1, 0, device=dev)
    try:
        mesh = pdist.global_mesh()
        require(mesh.ranks is not None and dist.get_backend() == "nccl",
                "phase 22 (a): not a process-group mesh on NCCL")
        lw_fn = rfmip.lw_mega_core_sharded(mesh, [lw_model], table, lw_spec, True)
        sw_fn = rfmip.sw_mega_core_sharded(mesh, [sw_model, sw_model], sw_spec, solar, True)
        reset_counts()
        got = {"lw": lw_fn(*lw_in), "sw": sw_fn(*sw_in)}
        counts = read_counts()
        err = {k: max(maxabs(a, b) for a, b in zip(got[k], want[k])) for k in got}
        print(f"sharded world size 1 (NCCL, {mesh.shape}): lw_mega_core_sharded, "
              f"sw_mega_core_sharded at {NCOL}x{NLAY}: launches {counts}; max|sharded - "
              f"unsharded| LW {err['lw']:.3e}, SW {err['sw']:.3e} W/m2 (0 expected)")
        require(counts == {"k1": 1, "k2": 1}, f"the sharded cores launched {counts}, not K1 and "
                                              "K2 once")
        require(err["lw"] == 0.0 and err["sw"] == 0.0,
                "the sharded cores differ from the unsharded ones at world size 1")
        with torch.no_grad():
            times = {"lw_sharded": cuda_ms(lambda: lw_fn(*lw_in)),
                     "sw_sharded": cuda_ms(lambda: sw_fn(*sw_in)),
                     "lw_unsharded": cuda_ms(lambda: fused.lw_core(
                         [lw_model], table, lw_spec, *lw_in, top_at_1=True)),
                     "sw_unsharded": cuda_ms(lambda: rfmip._sw_core_mega_canon(
                         [sw_model, sw_model], solar, *sw_in, top_at_1=True))}
        print("sharded timing at world size 1: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()) + f" | {card}")
    finally:
        dist.destroy_process_group()

    # ---- (b) + (c): two ranks sharing the card ----
    t0 = time.perf_counter()
    ranks = pdist.launch(sharded_rank, 2, synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=True),
                         timeout_s=600)
    t_ranks = time.perf_counter() - t0
    half = NCOL // 2
    for r, out in enumerate(ranks):
        errs = {}
        for k in ("lw", "sw"):
            w = [t.cpu().numpy() for t in want[k]]
            errs[k] = max(max(float(np.abs(a - b[half * r:half * (r + 1)]).max())
                              for a, b in zip(out[k], w)),
                          max(float(np.abs(a - b).max()) for a, b in zip(out[k + "_all"], w)))
        print(f"sharded rank {r} of 2 ({out['device']}, gloo, {out['mesh']}): launches a call "
              f"{out['counts']}; block and gathered against (a): LW {errs['lw']:.3e}, SW "
              f"{errs['sw']:.3e} W/m2")
        require(out["device"] == "cuda:0" and out["counts"] == {"k1": 1, "k2": 1},
                f"rank {r} launched {out['counts']} on {out['device']}, not K1 and K2 once")
        require(errs["lw"] == 0.0 and errs["sw"] == 0.0,
                f"rank {r}'s sharded fluxes differ from the unsharded cores'")
        dr = out["dryrun"]
        print(f"dryrun rank {r}: mesh {dr['mesh']}, columns {dr['cols']}, g-points {dr['gpts']}, "
              f"train loss {dr['loss']:.6f} (every rank {dr['losses']}), launches "
              f"{out['dryrun_counts']}, max|fused over 'col' - g-point-split staged| "
              f"{dr['mega_err']:.3e} W/m2 (tol {LW_ATOL}); the rank ready {out['ready_s']:.2f} s "
              f"after its start, the sharded cores {out['sharded_s']:.2f} s, torch._dynamo's "
              f"import {out['dynamo_import_s']:.2f} s, the dry run {out['dryrun_s']:.2f} s "
              f"(stage 1 {dr['stage_s'][0]:.2f}, stages 2 and 3 {dr['stage_s'][1]:.2f})")
        require(out["dryrun_counts"] == {"fused_predict_lw_both": 1, "k7": 1, "k7_angles": 1,
                                         "k1": 1},
                f"rank {r}'s dry run launched {out['dryrun_counts']}")
    print(D.report([o["dryrun"] for o in ranks]) + f" | {card}")
    print(f"sharded two ranks: {t_ranks:.1f} s (their start, both parts) | {card}")

    # ---- (d) the multichip bench at one card ----
    rows = {}
    for core in ("mega", "staged"):
        rows[core] = B.main(["--device-counts", "1", "--core", core,
                             "--cols-per-device", str(BENCH_COLS)]
                            + (["--profile"] if core == "mega" else []))
        require(rows[core][-1]["value"] > 0, f"the {core} bench gave no throughput")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s | {card}")
    return times


# phase 23: the SW training recipe of artifacts/sw-synth56-lut_*
# (scripts/train_from_lut_sw.py), cut as phase 21 cuts the LW one
TRAIN_SW_ALPHA = 0.6


def training_sw_phase(dev, card) -> None:
    """Phase 23: the SW training recipe on the card
    (scripts/torch_train_from_lut_sw.py on training/lut_recipe): the LUT SW
    gendata at 18 experiments x 100 sites x 60 layers on a synthetic
    56-g-point k-distribution (no kernel: LUT gas optics and rte_sw); fresh
    absorption and Rayleigh nets 7 -> 128 -> 128 -> 56 trained jointly for
    TRAIN_EPOCHS epochs of TRAIN_STEPS steps (an Adam with cosine decay
    each, hybrid loss, EMA) through train_with_radiation_eval, each
    day-masked eval counted (K5 once); after the last step K5 on the eval's
    inputs against its twin; both best nets saved with the score in their
    names and loaded back (bit-identical fluxes)."""
    import glob
    import tempfile

    import torch

    sys.path.insert(0, SCRIPTS)
    import torch_train_from_lut_sw as S
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, save_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
    from rte_rrtmgp_nn_tpu_torch.training.eval_loop import (
        provenance_attrs, train_with_radiation_eval)
    from rte_rrtmgp_nn_tpu_torch.training.gendata import generate_sw_training_data
    from rte_rrtmgp_nn_tpu_torch.training.train import make_train_step

    t_phase = time.perf_counter()
    data = rfmip_data_from_arrays(testing.synthesize_rfmip_experiments(
        TRAIN_NEXP, TRAIN_NSITES, NLAY, SEED))
    ncol = data.ncol
    with tempfile.TemporaryDirectory() as tmp:
        kpath = os.path.join(tmp, "kdist-synthetic-sw-g4.nc")
        generate_kdist_nc(kpath, kind="sw", gpts_per_band=4, nband=14)
        kd = load_kdist(kpath, R.GASES, device=dev)
        ngpt = kd.ngpt
        require(ngpt == 56 and kd.kmajor.is_cuda, "the SW recipe's k-distribution is not 56 "
                                                  "g-points on the card")
        train_nc = os.path.join(tmp, "sw_train_data.nc")
        reset_counts()
        t0 = time.perf_counter()
        gen = generate_sw_training_data(train_nc, kd, data, gas_order=R.GASES)
        t_first = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        generate_sw_training_data(os.path.join(tmp, "again.nc"), kd, data, gas_order=R.GASES)
        t_gendata = time.perf_counter() - t0
        require(all(np.isfinite(gen[n]).all() for n in ("rsu", "rsd", "rsd_dir")),
                "the SW gendata fluxes are not finite")
        print(f"training-sw gendata {TRAIN_NEXP}x{TRAIN_NSITES}x{NLAY}, {ngpt} g-points: "
              f"{t_gendata * 1e3:.1f} ms (first call {t_first * 1e3:.1f} ms, launches "
              f"{counts or 'none'}: LUT gas optics and rte_sw) | {card}")

        ts = R.sw_training_set(train_nc)
        total = TRAIN_EPOCHS * TRAIN_STEPS
        state = S.fresh_pair(ts, ngpt, TRAIN_HIDDEN, TRAIN_LR, total, SEED, dev)
        pairs = R.pair_index(TRAIN_PAIRS, dev)
        inner = R.pair_train_step(make_train_step(alpha=TRAIN_SW_ALPHA),
                                  make_train_step(alpha=TRAIN_SW_ALPHA), pairs)
        xs = torch.as_tensor(ts.xs, dtype=torch.float32, device=dev)
        ya = torch.as_tensor(ts.ys_abs, dtype=torch.float32, device=dev)
        yr = torch.as_tensor(ts.ys_ray, dtype=torch.float32, device=dev)
        ev = R.SWFluxEval(kd, data, ts, gen["rsu"].reshape(ncol, -1),
                          gen["rsd"].reshape(ncol, -1), dev)
        rng = np.random.default_rng(SEED)
        step_events, eval_ms, eval_counts = [], [], []

        def data_iter():
            idx = torch.as_tensor(R.sample_pair_rows(rng, TRAIN_NEXP, TRAIN_NSITES, NLAY,
                                                     TRAIN_PAIRS), device=dev)
            return xs[idx], (ya[idx], yr[idx])

        def train_step(st, x, y):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(st, x, y)
            e1.record()
            step_events.append((e0, e1))
            return out

        def eval_fn(models):
            reset_counts()
            t0 = time.perf_counter()
            metrics = ev.metrics(models)
            eval_ms.append((time.perf_counter() - t0) * 1e3)
            eval_counts.append(read_counts())
            return metrics

        t0 = time.perf_counter()
        result = train_with_radiation_eval(
            state, train_step, data_iter, eval_fn, R.REF_SCORES, n_epochs=TRAIN_EPOCHS,
            steps_per_epoch=TRAIN_STEPS, patience=TRAIN_EPOCHS, verbose=False,
            ema_decay=TRAIN_EMA)
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        med = statistics.median(step_ms)
        hist = result.history
        print(f"training-sw: {len(hist)} epochs x {TRAIN_STEPS} steps of {2 * TRAIN_PAIRS} rows, "
              f"both nets {state.abs_state.model.dims} (Adam lr {TRAIN_LR} cosine each, hybrid "
              f"alpha {TRAIN_SW_ALPHA}, EMA {TRAIN_EMA}): losses "
              f"{[round(h['loss'], 5) for h in hist]}, radiation scores "
              f"{[round(h['score'], 3) for h in hist]}, best epoch {result.best_epoch}")
        print(f"training-sw step (both nets): median {med:.4f} ms by CUDA events (min "
              f"{min(step_ms):.4f}, max {max(step_ms):.4f}), {1e3 / med:.1f} steps/s | {card}")
        print(f"training-sw eval: {statistics.median(eval_ms):.3f} ms per epoch (median of "
              f"{len(eval_ms)}: {[round(v, 3) for v in eval_ms]}), launches per eval "
              f"{eval_counts} | {card}")
        print(f"training-sw loop: {t_loop:.2f} s for {total} steps and {len(hist)} evals | {card}")
        require(len(hist) == TRAIN_EPOCHS and all(np.isfinite(h["score"]) for h in hist),
                "a SW training epoch gave no finite radiation score")
        require(all(c == {"fused_predict_sw": 1} for c in eval_counts),
                f"a SW eval did not launch K5 once: {eval_counts}")

        # -- K5 against its twin after the steps, on the eval's own inputs --
        with torch.no_grad():
            for tag, (a, r) in (("trained nets", state.model), ("best (EMA) nets",
                                                                result.best_model)):
                got = mlp.fused_predict_sw(a, r, ev.x, ev.col_dry)
                twin = mlp.fused_predict_sw_plain(a, r, ev.x, ev.col_dry)
                twin64 = mlp.fused_predict_sw_plain(testing.float64_copy(a),
                                                    testing.float64_copy(r), ev.x.double(),
                                                    ev.col_dry.double())
                hold(f"training-sw K5 {tag} tau", got[0], twin[0], twin64[0], MLP_RTOL, 1e-8)
                hold(f"training-sw K5 {tag} ssa", got[1], twin[1], twin64[1], 0.0, SSA_ATOL)

        # -- both best nets saved and loaded back: bit-identical fluxes --
        attrs = provenance_attrs(result, R.REF_SCORES)
        for tag, m in zip(("absorption", "rayleigh"), result.best_model):
            save_model_netcdf(os.path.join(
                tmp, f"sw-synth{ngpt}-lut_{tag}_{TRAIN_HIDDEN}_{TRAIN_HIDDEN}_HR_x.nc"), m,
                attrs=attrs)
        again = [load_model_netcdf(glob.glob(os.path.join(tmp, f"sw-synth{ngpt}-lut_{t}_*.nc"))[0],
                                   device=dev) for t in ("absorption", "rayleigh")]
        with torch.no_grad():
            same = all(torch.equal(a, b) for a, b in zip(ev.fluxes(result.best_model),
                                                         ev.fluxes(again)))
        print(f"training-sw save/reload: both nets load back with bit-identical fluxes: {same}")
        require(same, "the saved SW nets do not give the same fluxes back")
    print(f"training-sw phase: {time.perf_counter() - t_phase:.1f} s | {card}")


CLI_NEXP, CLI_NSITES = 18, 100  # the RFMIP file's experiments x sites: 1800 columns
CLI_NLOOPS = 2  # torch_run_allsky --nloops: K1 and K2 once each a loop
# the regression harness's LUT LW solves but the Jacobian's: K7 once each
CLI_LUT_LW_SOLVES = 9
CLI_REGRESSION_SIZE = (8, 20)  # torch_run_regression's default --ncol, --nlay
LW64_MODEL = os.path.join(HERE, "artifacts", "lw-g128-demo_both_64_64_HR_2.62e-01_FRC_2.07e+01.nc")


def load_script(name):
    """scripts/<name>.py (or <name>.py beside this file) as a module."""
    import importlib.util

    path = os.path.join(HERE, "scripts", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"cli_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call_script(name, entry, args, consts=None) -> tuple:
    """``entry``(args) of scripts/<name>.py in this process (its module
    constants set to ``consts`` first), its standard output captured:
    (what it returned, the output, host seconds, the kernels launched:
    read_counts with K1's and K2's modes as k1_<mode> / k2_<mode>), the
    counts set to 0 just before and read just after."""
    import io

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    mod = load_script(name)
    for k, v in (consts or {}).items():
        setattr(mod, k, v)
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        value = getattr(mod, entry)(list(args))
    counts = read_counts()
    seconds = time.perf_counter() - t0
    for tag, modes in (("k1", k1.MODE_LAUNCHES), ("k2", k2.MODE_LAUNCHES)):
        counts.update({f"{tag}_{k}": v for k, v in modes.items() if v})
    return value, out.getvalue(), seconds, counts


def run_script(name, args) -> tuple[str, float, dict]:
    """call_script of main(args): (the output, host seconds, the kernels
    launched). Requires exit status 0."""
    rc, out, seconds, counts = call_script(name, "main", args)
    require(rc == 0, f"{name} {' '.join(args)} exited {rc}:\n{out}")
    return out, seconds, counts


def read_fields(path, names=None) -> dict:
    """Variables of a flux file (all of them by default) as float64 tensors
    on the CPU, each (columns, levels): an RFMIP file's (expt, site, level)
    flattened to expt x site columns."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.utils import ncio

    with ncio.NCFile(path) as f:
        arrays = {n: f.read(n, np.float64) for n in (names or f.variables())}
    return {n: torch.from_numpy(v.reshape(-1, v.shape[-1])) for n, v in arrays.items()}


def regression_float64(script) -> dict:
    """scripts/torch_run_regression.py's fields at its defaults in float64
    on the CPU (its own load_kdists and regression_fields)."""
    import torch

    cpu, f64 = torch.device("cpu"), torch.float64
    with contextlib.redirect_stdout(None):
        kd_lw, kd_sw = script.load_kdists(None, None, f64, device=cpu)
    ncol, nlay = CLI_REGRESSION_SIZE
    fields = script.regression_fields(kd_lw, kd_sw, ncol, nlay, f64, device=cpu)
    return {n: torch.from_numpy(v) for n, v in fields.items()}


def cli_phase(dev, card, lw_model, table, lw_spec, data) -> dict:
    """Phase 24: the command-line entry points (scripts/torch_run_rfmip.py,
    torch_run_allsky.py, torch_eval_rfmip.py, torch_run_regression.py), each
    run through its main() on the card and with --device cpu on files
    written to a temporary directory: the RFMIP file at 18 x 100 x 60
    (testing.write_rfmip_file, seed 0), the all-sky files of phase 12 and a
    models dir holding the in-repo stand-ins under the reference's BEST
    names. The card's output files against the CPU run's: LW within LW_ATOL,
    beyond it float64 decides (adjudicate); SW within SW_ATOL, beyond it
    float64 decides, the card and the CPU each within SW_ATOL of it in every
    column (float64 two-stream coefficients on every route); the eval's 8
    metrics within 2e-3 of the CPU run's; every regression check under
    --fail-tol 1e-5 on the card, and its 28 fields card against CPU as
    above. The launches counted around
    each main on the card (and none on the CPU), each run's host seconds.
    Then lw_solver_noscat_lay_major's K7 route on the layer-major fields of
    the main path's gas optics, with per-(column, g-point) secants and an
    incident flux, against its PyTorch path on the card (one launch;
    beyond LW_ATOL float64 decides), both timed. Returns the times."""
    import shutil
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.utils import cli

    cpu, f64 = torch.device("cpu"), torch.float64
    t_phase = time.perf_counter()
    secs = {}
    sw64 = [load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)] * 2
    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)

    def both(name, args, outs):
        """The script on the card and on the CPU; ``outs(tag)`` the
        arguments naming its outputs. Returns {tag: (stdout, counts)}."""
        runs = {}
        for tag, device in (("card", "cuda"), ("cpu", "cpu")):
            out, sec, counts = run_script(name, [*args, *outs(tag), "--device", device])
            secs[f"{name}_{tag}"] = sec
            print(f"cli {name} on the {tag}: {sec:.2f} s, launches {counts} | {card}")
            for line in out.splitlines():
                if "mean" in line or "FAIL" in line or line.startswith(("LW:", "SW:", "ncol")):
                    print(f"cli {name} [{tag}] {line.strip()}")
            runs[tag] = (out, counts)
        require(runs["cpu"][1] == {}, f"{name} --device cpu launched kernels: {runs['cpu'][1]}")
        return runs

    def hold_lw(name, got, ref, make_ref64):
        e = max(maxabs(got[n], ref[n]) for n in got)
        print(f"cli {name}: max|card - cpu| {e:.3e} W/m2 (tol {LW_ATOL})")
        adjudicate_lazy(f"cli {name}", e, LW_ATOL, tuple(got.values()), tuple(ref.values()),
                        lambda: tuple(make_ref64()[n] for n in got))
        return e

    def hold_sw_cli(name, got, ref, make_ref64):
        """Beyond SW_ATOL float64 decides: the card and the CPU each within
        SW_ATOL of it in every column."""
        e = max(maxabs(got[n], ref[n]) for n in got)
        line = f"cli {name}: max|card - cpu| {e:.3e} W/m2 (tol {SW_ATOL})"
        if e > SW_ATOL:
            ref64 = make_ref64()
            ref64 = {n: ref64[n] for n in got}
            e64 = hold_sw(got, ref64, f"cli {name} card")
            e_cpu = hold_sw(ref, ref64, f"cli {name} CPU")
            line += f"; float64 decides: card {e64:.3e}, CPU {e_cpu:.3e}"
        print(line)
        return e

    with tempfile.TemporaryDirectory() as tmp:
        j = lambda *p: os.path.join(tmp, *p)
        rfmip_file = j("rfmip.nc")
        testing.write_rfmip_file(rfmip_file, CLI_NEXP, CLI_NSITES, NLAY, SEED)
        paths = write_allsky_files(tmp)
        for sub, lw in (("models", LW_MODEL), ("models64", LW64_MODEL)):
            os.makedirs(j(sub))
            shutil.copy(lw, j(sub, cli.LW_MODEL_FILE))
        for f in cli.SW_MODEL_FILES:
            shutil.copy(SW_MODEL, j("models", f))
        fdata = read_rfmip(rfmip_file)

        # torch_run_rfmip: K1 once, K2 once
        runs = both("torch_run_rfmip", ["--input", rfmip_file, "--models-dir", j("models"),
                                        "--what", "lw,sw", "--tag", "t"],
                    lambda tag: ["--output-dir", j(tag)])
        require(runs["card"][1] == {"k1": 1, "k1_clear": 1, "k2": 1, "k2_clear": 1},
                f"torch_run_rfmip did not launch K1 once and K2 once: {runs['card'][1]}")
        fl = {tag: {n: read_fields(j(tag, f"{n}_t.nc"), [n])[n] for n in ("rlu", "rld")}
              for tag in ("card", "cpu")}
        fs = {tag: {n: read_fields(j(tag, f"{n}_t.nc"), [n])[n] for n in ("rsu", "rsd")}
              for tag in ("card", "cpu")}
        def rfmip_sw64():
            fb = rfmip.rfmip_clear_sky_sw(fdata, sw64, device=cpu, dtype=f64)
            return {"rsu": fb.flux_up, "rsd": fb.flux_dn}

        def rfmip_lw64():
            fb = rfmip.rfmip_clear_sky_lw(fdata, [lw64], device=cpu, dtype=f64)
            return {"rlu": fb.flux_up, "rld": fb.flux_dn}

        hold_lw("torch_run_rfmip LW", fl["card"], fl["cpu"], rfmip_lw64)
        hold_sw_cli("torch_run_rfmip SW", fs["card"], fs["cpu"], rfmip_sw64)

        # torch_run_allsky: K1 and K2 in the cld_lut mode, once each a loop
        names = ("lw_flux_up", "lw_flux_dn", "sw_flux_up", "sw_flux_dn")
        runs = both("torch_run_allsky", ["--input", paths["garand"], "--lw-cloud-coeffs",
                                         paths["lw_lut"], "--sw-cloud-coeffs", paths["sw_lut"],
                                         "--models-dir", j("models"), "--ncol", str(NCOL),
                                         "--nloops", str(CLI_NLOOPS)],
                    lambda tag: ["--output", j(f"allsky-{tag}.nc")])
        n = CLI_NLOOPS
        require(runs["card"][1] == {"k1": n, "k1_cld_lut": n, "k2": n, "k2_cld_lut": n},
                f"torch_run_allsky did not launch K1 and K2 cld_lut once a loop: "
                f"{runs['card'][1]}")
        fa = {tag: read_fields(j(f"allsky-{tag}.nc"), names) for tag in ("card", "cpu")}
        tile = torch.arange(NCOL) % 6  # the file's 2 profiles x the 3-column cloud pattern

        def allsky64(band):
            if band == "lw":
                fb = allsky.allsky_lw(paths["garand"], paths["lw_lut"], [lw64], ncol=6,
                                      device=cpu, dtype=f64)
            else:
                fb = allsky.allsky_sw(paths["garand"], paths["sw_lut"], sw64, ncol=6,
                                      device=cpu, dtype=f64)
            return {f"{band}_flux_up": fb.flux_up[tile], f"{band}_flux_dn": fb.flux_dn[tile]}

        sub = lambda d, band: {n: v for n, v in d.items() if n.startswith(band)}
        hold_lw("torch_run_allsky LW", sub(fa["card"], "lw"), sub(fa["cpu"], "lw"),
                lambda: allsky64("lw"))
        hold_sw_cli("torch_run_allsky SW", sub(fa["card"], "sw"), sub(fa["cpu"], "sw"),
                    lambda: allsky64("sw"))

        # torch_eval_rfmip: K1 once; the reference fluxes from the 64-wide net
        ref = j("ref64.nc")
        run_script("torch_eval_rfmip", [j("models64", cli.LW_MODEL_FILE), "--rfmip", rfmip_file,
                                        "--save-fluxes", ref, "--device", "cuda"])
        runs = both("torch_eval_rfmip", [j("models", cli.LW_MODEL_FILE), "--rfmip", rfmip_file,
                                         "--ref-fluxes", ref],
                    lambda tag: ["--save-fluxes", j(f"eval-{tag}.nc")])
        require(runs["card"][1] == {"k1": 1, "k1_clear": 1},
                f"torch_eval_rfmip did not launch K1 once: {runs['card'][1]}")
        blocks = {}
        for tag, (out, _) in runs.items():
            lines = out.splitlines()
            i = lines.index("--------")
            blocks[tag] = (lines[i + 1], np.array([float(v) for v in lines[i + 3].split(",")]))
            print(f"cli torch_eval_rfmip [{tag}] {lines[i + 3]}")
        de = float(np.abs(blocks["card"][1] - blocks["cpu"][1]).max())
        print(f"cli torch_eval_rfmip: metrics card vs cpu max {de:.3e} (tol {CLI_METRIC_ATOL}); "
              f"header {blocks['card'][0] == blocks['cpu'][0]}")
        require(blocks["card"][0] == blocks["cpu"][0] and len(blocks["card"][1]) == 8
                and de <= CLI_METRIC_ATOL and bool((blocks["card"][1] != 0).all()),
                "torch_eval_rfmip's metric block on the card differs from the CPU run's")
        fe = {tag: read_fields(j(f"eval-{tag}.nc"), ("rlu", "rld")) for tag in ("card", "cpu")}
        hold_lw("torch_eval_rfmip fluxes", fe["card"], fe["cpu"], rfmip_lw64)

        # torch_run_regression at its defaults: K7 once a LUT LW solve
        runs = both("torch_run_regression", ["--fail-tol", "1e-5"],
                    lambda tag: ["--output", j(f"regression-{tag}.nc")])
        require(runs["card"][1] == {"k7": CLI_LUT_LW_SOLVES, "k7_angles": CLI_LUT_LW_SOLVES},
                f"torch_run_regression did not launch K7 once a LUT LW solve: {runs['card'][1]}")
        for tag, (out, _) in runs.items():
            for line in out.splitlines():
                if "max rel diff" in line:
                    print(f"cli torch_run_regression [{tag}] {line.strip()}")
            require("all verification checks passed" in out,
                    f"torch_run_regression on the {tag}: a check failed")
        # its fields, card against CPU: every LW field (the nine K7 solves,
        # the Jacobian's PyTorch solve) and every SW field (PyTorch's PIFM,
        # float64 coefficients, on both)
        fr = {tag: read_fields(j(f"regression-{tag}.nc")) for tag in ("card", "cpu")}
        require(sorted(fr["card"]) == sorted(fr["cpu"]) and len(fr["card"]) == 28,
                f"torch_run_regression wrote other fields: {sorted(fr['card'])}")
        script = load_script("torch_run_regression")
        reg64 = {}

        def regression64():
            if not reg64:
                reg64.update(regression_float64(script))
            return reg64

        hold_lw("torch_run_regression LW", sub(fr["card"], "lw"), sub(fr["cpu"], "lw"),
                regression64)
        hold_sw_cli("torch_run_regression SW", sub(fr["card"], "sw"), sub(fr["cpu"], "sw"),
                    regression64)

    # lw_solver_noscat_lay_major on the card: one launch of K7's angles mode
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    play, plev, tlay, tlev, tsfc, emis_band, concs = rfmip.lw_staged_inputs(data, lw_spec, dev)
    tau, src = go.gas_optics_lw_nn([lw_model], play, plev, tlay, tsfc, GasConcs(concs),
                                   lw_spec, table, tlev=tlev)
    lay = lambda a: a.transpose(0, 1).contiguous()
    args = (lay(tau), lay(src.lay_source), lay(src.lev_source),
            lw_spec.expand(emis_band).contiguous(), src.sfc_source)
    ngpt = tau.shape[-1]
    rng = np.random.default_rng(SEED)
    kw = {"inc_flux": t(rng.uniform(0.0, 2.0, (NCOL, ngpt))),
          "lw_ds": t(rng.uniform(1.5, 2.0, (NCOL, ngpt)))}
    reset_counts()
    got = plw.lw_solver_noscat_lay_major(*args, **kw)
    counts = read_counts()
    plain = plw.lw_solver_noscat_lay_major_plain(*args, **kw)
    require(counts == {"k7": 1, "k7_angles": 1},
            f"lw_solver_noscat_lay_major did not launch K7's angles mode once: {counts}")
    e = max(maxabs(got.flux_up, plain.flux_up), maxabs(got.flux_dn, plain.flux_dn))
    adjudicate_lazy("lay-major K7 route", e, LW_ATOL, got[:2], plain[:2], lambda: tuple(
        plw.lw_solver_noscat_lay_major_plain(*(a.double() for a in args),
                                             **{k: v.double() for k, v in kw.items()})[:2]))
    timed = {"lay_major_k7": cuda_ms(lambda: plw.lw_solver_noscat_lay_major(*args, **kw)),
             "lay_major_plain": cuda_ms(lambda: plw.lw_solver_noscat_lay_major_plain(*args, **kw),
                                        reps=9)}
    print(f"cli lay-major K7 route {NLAY}x{NCOL}x{ngpt}, per-(column, g-point) secants in "
          f"[1.5, 2], incident flux: launches {counts}, max|K7 - plain| {e:.3e} W/m2 (tol "
          f"{LW_ATOL}); {timed['lay_major_k7']:.4f} ms, plain {timed['lay_major_plain']:.4f} ms "
          f"| {card}")
    secs["phase"] = time.perf_counter() - t_phase
    print("cli seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" | {card}")
    return timed


# phase 25: the last scripts of the JAX package (scripts/torch_train_demo.py,
# torch_train_demo_sw.py, torch_calibrate_sw_g112.py, torch_calibrate_sw_solar.py)
DEMO_EPOCHS, DEMO_STEPS = 3, 50  # cut as phase 21 cuts training (the demos' own: 60 x 400)
# the card against the CPU: the g-112 weights within 1e-4 (each band's
# weights sum to 1; the card's optical depths are K4's, within rtol 2e-5 of
# the twin's, and NNLS moves a small weight relatively more than the taus
# move); the solar fractions within 1e-4 (a fraction moves its band's TOA
# source by TSI times its change: 0.14 W/m2 at 1e-4)
DEMO_G112_ATOL, DEMO_SOLAR_ATOL = 1e-4, 1e-4
SOLAR_NBAND = 14  # torch_calibrate_sw_solar: one all-sky SW run a band


def script_numbers(pattern: str, out: str) -> np.ndarray:
    """Every match of ``pattern``'s groups in a script's output, as floats."""
    import re

    return np.array([[float(v) for v in (m if isinstance(m, tuple) else (m,))]
                     for m in re.findall(pattern, out)])


def solar_fractions(out: str) -> np.ndarray:
    """The fractions torch_calibrate_sw_solar prints (np.array2string)."""
    text = out.split("planck.SW_SOLAR_BAND_FRAC_CAL):")[1].split("]")[0]
    return np.array([float(v) for v in text.strip(" [\n").split(",")])


def hold_single_band_k2(calls: list, ncol: int, card: str) -> None:
    """K2's kept calls (args, kwargs), one a single-band source: the
    kernel on the sources summed within SW_ATOL of its outputs summed, on a
    zero source exactly 0, and each call against its twin
    (gcm_hold_kept)."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    args, kw = calls[0]
    summed = list(args)
    summed[7] = sum(a[7] for a, _ in calls)  # inc_flux_dir: the full source
    whole = k2.sw_clearsky_megakernel(*summed, **kw)
    parts = [k2.sw_clearsky_megakernel(*a, **k) for a, k in calls]
    e_lin = max(maxabs(w, sum(p[i] for p in parts)) for i, w in enumerate(whole))
    summed[7] = torch.zeros_like(summed[7])
    zero = k2.sw_clearsky_megakernel(*summed, **kw)
    torch.cuda.synchronize()
    print(f"demos K2 cld_lut: the {len(calls)} single-band sources summed against their "
          f"outputs summed {e_lin:.3e} W/m2 (tol {SW_ATOL}); a zero source gives "
          f"{max(float(o.abs().max()) for o in zero)} | {card}")
    require(e_lin <= SW_ATOL and all(bool((o == 0).all()) for o in zero),
            "K2 cld_lut is not linear in its source, or a zero source gives nonzero flux")
    gcm_hold_kept("calibrate_sw_solar", {f"k2:band {i}": [c] for i, c in enumerate(calls)},
                  (ncol,), phase="demos")


def demos_phase(dev, card) -> None:
    """Phase 25: the distillation demos and the SW calibrations
    (scripts/torch_train_demo.py, torch_train_demo_sw.py,
    torch_calibrate_sw_g112.py, torch_calibrate_sw_solar.py), each through
    its run() / main() on the card and with --device cpu, the launches
    counted around each, on files written to a temporary directory: the
    RFMIP file of phase 24 (18 x 100 x 60), the stand-in teachers (the
    128-wide LW demo net; the SW demo net as both SW nets, under the
    reference's names) and a 224-output SW net (testing.sw_g224_net_arrays
    from the seed) as the g-224 net, phase 12's Garand and SW lookup-table
    cloud files. The demos at their default widths (64 LW, 48 SW) and 1024
    pairs, cut to DEMO_EPOCHS x DEMO_STEPS, card and CPU from one saved
    student (--init-from): each epoch's metrics card against CPU (LW_ATOL,
    SW_ATOL), the best epoch, the saved files' names; the g-112 weights
    within DEMO_G112_ATOL; the solar calibration at targets that positive
    fractions reach (the CPU's responses times SW_SOLAR_BAND_FRAC_CAL): the
    responses within SW_ATOL and the fractions within DEMO_SOLAR_ATOL. Then
    K4's calls (the g-112 and the 224-wide g-224 net) and K2's 14
    single-band cld_lut calls as the scripts made them, against their twins
    on the card; K2 on a zero source exactly 0, and on the 14 sources
    summed within SW_ATOL of its 14 outputs summed. "demos ..." lines."""
    import glob
    import shutil
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import fused
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        SW_SOLAR_BAND_FRAC_CAL, spectral_for, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import (
        load_model_netcdf, nn_model_from_arrays, save_model_netcdf)
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy
    from rte_rrtmgp_nn_tpu_torch.training.train import init_model
    from rte_rrtmgp_nn_tpu_torch.utils import cli

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    secs = {}

    def both(name, entry, args, outs, consts=None, around=contextlib.nullcontext):
        """The script's ``entry`` on the card (inside ``around()``, whose
        value is kept) and on the CPU; ``outs(tag)`` the arguments naming
        its outputs. Returns {tag: (value, stdout, counts, kept)}."""
        runs = {}
        for tag, device in (("card", "cuda"), ("cpu", "cpu")):
            with (around() if tag == "card" else contextlib.nullcontext()) as kept:
                value, out, sec, counts = call_script(
                    name, entry, [*args, *outs(tag), "--device", device], consts)
            secs[f"{name}_{tag}"] = sec
            print(f"demos {name} on the {tag}: {sec:.2f} s, launches {counts} | {card}")
            for line in out.splitlines():
                if line.startswith(("best radiation", "vs teacher", "achieved", "max |delta|")):
                    print(f"demos {name} [{tag}] {line.strip()}")
            runs[tag] = (value, out, counts, kept)
        require(runs["cpu"][2] == {}, f"{name} --device cpu launched kernels: {runs['cpu'][2]}")
        return runs

    with tempfile.TemporaryDirectory() as tmp:
        j = lambda *p: os.path.join(tmp, *p)
        rfmip_file = j("rfmip.nc")
        testing.write_rfmip_file(rfmip_file, CLI_NEXP, CLI_NSITES, NLAY, SEED)
        paths = write_allsky_files(tmp)
        os.makedirs(j("models"))
        for f in cli.SW_MODEL_FILES:
            shutil.copy(SW_MODEL, j("models", f))
        sw_host = load_model_netcdf(SW_MODEL, device=cpu)
        save_model_netcdf(j("models", cli.SW_G224_MODEL_FILE),
                          nn_model_from_arrays(*testing.sw_g224_net_arrays(sw_host, SEED),
                                               device=cpu))

        # -- the demos, card and CPU from one saved student ----------------------
        demos = {
            "lw": ("torch_train_demo", ["--teacher", LW_MODEL], LW_MODEL, 64, LW_ATOL,
                   {"k1": 1, "k1_clear": 1, "fused_predict_lw_both": DEMO_EPOCHS,
                    "k7": DEMO_EPOCHS, "k7_angles": DEMO_EPOCHS}),
            "sw": ("torch_train_demo_sw", ["--models-dir", j("models")], SW_MODEL, 48, SW_ATOL,
                   {"fused_predict_sw": DEMO_EPOCHS + 1}),
        }
        for band, (name, teacher_args, teacher_path, hidden, atol, expect) in demos.items():
            t = load_model_netcdf(teacher_path, device=cpu)
            save_model_netcdf(j(f"student-{band}.nc"), init_model(
                [t.n_inputs, hidden, hidden, t.n_outputs], torch.Generator().manual_seed(SEED),
                input_names=t.input_names, input_min=t.input_min, input_max=t.input_max,
                output_mean=t.output_mean, output_std=t.output_std, device=cpu))
            runs = both(name, "run", [*teacher_args, "--rfmip", rfmip_file, "--epochs",
                                      str(DEMO_EPOCHS), "--steps-per-epoch", str(DEMO_STEPS),
                                      "--init-from", j(f"student-{band}.nc")],
                        lambda tag: ["--out-dir", j(f"{band}-{tag}")])
            require(runs["card"][2] == expect,
                    f"{name} did not launch {expect} on the card: {runs['card'][2]}")
            rc, rp = runs["card"][0], runs["cpu"][0]
            require(len(rc.history) == len(rp.history) == DEMO_EPOCHS
                    and all(np.isfinite(h["score"]) for h in rc.history),
                    f"{name}: an epoch gave no finite radiation score")
            dl = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(rc.history, rp.history))
            dm = [float(np.abs(np.subtract(a["metrics"], b["metrics"])).max())
                  for a, b in zip(rc.history, rp.history)]
            (fc,), (fp,) = (glob.glob(j(f"{band}-{tag}", "*.nc")) for tag in ("card", "cpu"))
            print(f"demos {name}: net {rc.best_model.dims}, {DEMO_EPOCHS} epochs x {DEMO_STEPS} "
                  f"steps of 2048 rows; scores card {[round(h['score'], 4) for h in rc.history]}, "
                  f"cpu {[round(h['score'], 4) for h in rp.history]}; best epoch {rc.best_epoch} "
                  f"/ {rp.best_epoch}; losses card vs cpu {dl:.3e} relative; metrics card vs cpu "
                  f"by epoch {[float(f'{e:.3e}') for e in dm]} (tol {atol}); saved "
                  f"{os.path.basename(fc)} / {os.path.basename(fp)} | {card}")
            require(max(dm) <= atol, f"{name}: an epoch's metrics on the card are "
                                     f"{max(dm):.3e} from the CPU run's (tol {atol})")
            require(rc.best_epoch == rp.best_epoch and
                    os.path.basename(fc) == os.path.basename(fp),
                    f"{name}: the card's best epoch or saved file differs from the CPU run's")

        # -- calibrate_sw_g112: K4 twice, the 224-wide net the second time --------
        runs = both("torch_calibrate_sw_g112", "main",
                    ["--rfmip", rfmip_file, "--models-dir", j("models")],
                    lambda tag: ["--out", j(f"weights-{tag}.py")],
                    around=lambda: kept_calls({"k4": (mlp, "fused_predict_tau")},
                                              lambda i: True))
        require(runs["card"][2] == {"fused_predict_tau": 2},
                f"torch_calibrate_sw_g112 did not launch K4 twice: {runs['card'][2]}")
        weights = {}
        for tag in ("card", "cpu"):
            scope = {}
            exec(open(j(f"weights-{tag}.py")).read(), scope)
            weights[tag] = scope["SW_G112_WEIGHTS"]
        resid = {tag: script_numbers(r"rms transmission residual ([0-9.]+)", runs[tag][1])
                 for tag in ("card", "cpu")}
        dw = float(np.abs(weights["card"] - weights["cpu"]).max())
        print(f"demos torch_calibrate_sw_g112: weights card vs cpu max {dw:.3e} (tol "
              f"{DEMO_G112_ATOL}), zero weights {int((weights['card'] == 0).sum())} / "
              f"{int((weights['cpu'] == 0).sum())}; band residuals card "
              f"{resid['card'].ravel().tolist()}, cpu {resid['cpu'].ravel().tolist()} | {card}")
        require(weights["card"].shape == (112,) and dw <= DEMO_G112_ATOL
                and resid["card"].shape == (14, 1),
                "torch_calibrate_sw_g112's weights on the card differ from the CPU run's")
        for args, kw in runs["card"][3]["k4"]:
            net, x, col_dry = args
            label = f"demos K4 on {'x'.join(map(str, x.shape[:-1]))} rows, net {net.dims}"
            got = mlp.fused_predict_tau(*args)
            hold(label, got, mlp.fused_predict_tau_plain(*args),
                 mlp.fused_predict_tau_plain(float64_copy(net), x.double(), col_dry.double()),
                 MLP_RTOL, 1e-8)
            rows = x.numel() // x.shape[-1]
            b = bound(nbytes(x, col_dry) + model_bytes(net) + rows * net.dims[-1] * 4,
                      mlp_flops(net, rows) + ELEMENT_FLOPS["mlp"] * rows * net.dims[-1])
            ms = cuda_ms(lambda: mlp.fused_predict_tau(*args))
            ms_plain = cuda_ms(lambda: mlp.fused_predict_tau_plain(*args), reps=9)
            print(f"{label}: {ms:.4f} ms (plain {ms_plain:.4f}), bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']} | {card}")

        # -- calibrate_sw_solar: K2 cld_lut once a band ---------------------------
        script = load_script("torch_calibrate_sw_solar")
        pair = [load_model_netcdf(j("models", f), device=cpu) for f in cli.SW_MODEL_FILES]
        with contextlib.redirect_stdout(None):
            resp = script.band_responses(paths["garand"], paths["sw_lut"], pair,
                                         spectral_for("sw", pair, entry="demos_phase",
                                                      accepts=(sw_spectral_g112,)), cpu)
        target = SW_SOLAR_BAND_FRAC_CAL @ resp
        runs = both("torch_calibrate_sw_solar", "main",
                    ["--garand", paths["garand"], "--sw-cloud-coeffs", paths["sw_lut"],
                     "--models-dir", j("models")], lambda tag: [],
                    consts={"TARGET_DN": target[0], "TARGET_UP": target[1]},
                    around=lambda: kept_calls({"k2": (fused, "sw_clearsky_megakernel")},
                                              lambda i: True))
        require(runs["card"][2] == {"k2": SOLAR_NBAND, "k2_cld_lut": SOLAR_NBAND},
                f"torch_calibrate_sw_solar did not launch K2 cld_lut once a band: "
                f"{runs['card'][2]}")
        pattern = r"band +\d+: dn= *([0-9.]+) +up= *([0-9.]+)"
        rc, rp = (script_numbers(pattern, runs[tag][1]) for tag in ("card", "cpu"))
        fc, fp = (solar_fractions(runs[tag][1]) for tag in ("card", "cpu"))
        dr, df = float(np.abs(rc - rp).max()), float(np.abs(fc - fp).max())
        print(f"demos torch_calibrate_sw_solar: targets dn/up {target[0]:.4f} / {target[1]:.4f} "
              f"W/m2; responses card vs cpu max {dr:.3e} W/m2 (tol {SW_ATOL}, printed to 1e-3), "
              f"fractions max {df:.3e} (tol {DEMO_SOLAR_ATOL}); card {fc.tolist()} | {card}")
        require(rc.shape == rp.shape == (SOLAR_NBAND, 2) and dr <= SW_ATOL
                and df <= DEMO_SOLAR_ATOL and bool((fc > 0).all()),
                "torch_calibrate_sw_solar on the card differs from the CPU run")
        hold_single_band_k2(runs["card"][3]["k2"], script.NCOL, card)

    secs["phase"] = time.perf_counter() - t_phase
    print("demos seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" | {card}")


# phase 26: the benchmark entry points (bench_torch.py, scripts/torch_bench_allsky.py,
# scripts/torch_bench_gcm.py), each through its main() at its default size
BENCH_ALLSKY_WIDE = 28_800  # the all-sky size of ROADMAP Queue 1 item 2
# the GCM entry cut from 18 blocks of 57,600 columns to 4, to keep the phase
# near a minute (phase 20 sweeps all 18); the block size is not cut
BENCH_GCM_NCOL = 4 * 57_600
BENCH_RUNS = (("bench_torch", ()), ("bench_torch", ("--core", "staged")),
              ("torch_bench_allsky", ()),
              ("torch_bench_allsky", ("--ncol", str(BENCH_ALLSKY_WIDE))),
              ("torch_bench_gcm", ("--ncol", str(BENCH_GCM_NCOL))),
              ("torch_bench_gcm", ("--ncol", str(BENCH_GCM_NCOL), "--resident")))

# nets of another k-distribution than the entries' fixed g-128 LW / g-112 SW
# mappings: each entry refuses them in words before it builds or launches
# anything (utils/bench.load_nets)
LW64_LUT_MODEL = os.path.join(HERE, "artifacts",
                              "lw-synth64-lut_both_128_128_HR_2.31e-01_FRC_2.39e-01.nc")
BENCH_MISFITS = tuple((name, ("--sw-models", *SW_PAIR)) for name in (
    "bench_torch", "torch_bench_allsky", "torch_bench_gcm", "torch_bench_multichip")) + (
    ("bench_torch", ("--lw-model", LW64_LUT_MODEL)),)


def bench_refusals(card) -> None:
    """Each entry of BENCH_MISFITS through its main() on the card: it must
    raise the ValueError that names the mapping it takes, with every
    kernel's count 0 around the call. Prints each refusal's first line."""
    for name, args in BENCH_MISFITS:
        what = f"{name} {' '.join(os.path.basename(a) for a in args)}"
        reset_counts()
        t0 = time.perf_counter()
        try:
            call_script(name, "main", args)
        except ValueError as e:
            seconds = time.perf_counter() - t0
            counts = read_counts()
            first = str(e).split(". ")[0]
            require("takes the g-" in first and "not " in first,
                    f"{what}: refused in other words: {e}")
            require(not counts, f"{what}: launched {counts} before refusing")
            print(f"bench refuses {what}: {first}; {seconds:.3f} s, launches {counts} | {card}")
        else:
            raise SmokeFailure(f"{what} ran on nets it should refuse")


def bench_launches(name: str, args, lines: list) -> dict:
    """The launches an entry's run must count (read_counts with the fused
    kernels' modes): once a core or driver call ("calls" in its JSON) on
    its route, K1 and K2 (clear, or cld_lut for all-sky), or K3 + K7 and K5
    staged; for the GCM sweeps once a block, plus the warm-up block and
    the one block of the output check, K1 and K2 cld_lut (all-sky) and K1
    clear (LW)."""
    if name == "torch_bench_gcm":
        n = lines[0]["blocks"] + 2
        return {"k1": 2 * n, "k1_cld_lut": n, "k1_clear": n, "k2": n, "k2_cld_lut": n}
    lw, sw = lines[0]["calls"]["lw"], lines[0]["calls"]["sw"]
    if "staged" in args:
        return {"fused_predict_lw_both": lw, "k7": lw, "k7_angles": lw, "fused_predict_sw": sw}
    mode = "cld_lut" if name == "torch_bench_allsky" else "clear"
    return {"k1": lw, f"k1_{mode}": lw, "k2": sw, f"k2_{mode}": sw}


def bench_phase(card) -> None:
    """Phase 26: each benchmark entry on the card through its main(), the
    kernels' counts set to 0 just before and read just after (call_script);
    each must exit 0 with "correct": true on every JSON line, name the card
    it ran on, and launch what bench_launches says; then each refuses nets
    of another mapping (bench_refusals). Prints their JSON lines and the
    phase's seconds."""
    t_phase = time.perf_counter()
    for name, args in BENCH_RUNS:
        rc, out, seconds, counts = call_script(name, "main", args)
        lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        for line in lines:
            print(json.dumps(line))
        what = f"{name} {' '.join(args)}".strip()
        require(rc == 0 and lines and all(line["correct"] for line in lines),
                f"{what} exited {rc} or was not correct:\n{out}")
        require(all(line["device"]["platform"] == "gpu" and line["backend"] == "cuda"
                    and not line["metric"].endswith("_cpu") for line in lines),
                f"{what} did not run on the card")
        require(all(line.get("sw_f1_columns", 0) == 0 for line in lines),
                f"{what}: SW columns beyond 2e-2 W/m2 were let through")
        want = bench_launches(name, args, lines)
        require(counts == want, f"{what} launched {counts}, not {want}")
        print(f"bench {what}: exit 0, correct, {seconds:.2f} s, launches {counts}; "
              + "; ".join(f"{line['metric']} {line['value']:.1f}" for line in lines)
              + f" | {card}")
    bench_refusals(card)
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s | {card}")


def sw_pair_phase(dev, card) -> tuple[dict, dict, dict]:
    """Phase 27: the SW main path on a real absorption + Rayleigh pair, the
    in-repo sw-synth56-lut nets of hidden widths 128_128 on the synthetic
    56-g-point SW k-distribution they were trained on
    (testing.sw_pair_setup), at NCOL x NLAY from SEED. The float64 optical
    properties' ssa quantiles and the cells and columns within 1e-3 of the
    resonance k*mu0 = 1; rfmip_clear_sky_sw on the fused route (K2 at ngpt =
    56, once a call) and on the staged route (K5 once a call, then the
    PyTorch sweeps with pifm_coefficients), each with the counts set to 0
    just before and read just after, each within SW_ATOL of the port's
    float64 CPU run in every column; K2 against its twin on the same CUDA
    tensors (float64 deciding beyond); K2's time, its twin's and its bound;
    both staged SW cores' times and kernel launches a call (the pair and the
    stand-in of phase 10). Returns (K2's result entry, its launches, its
    times) for the kernels line."""
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import spectral_for, sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.ops.sw_solver import pifm_eigenvalue

    t_phase = time.perf_counter()
    cpu, f64 = torch.device("cpu"), torch.float64
    with tempfile.TemporaryDirectory() as tmp:
        pair = testing.sw_pair_setup(tmp, "128_128", device=dev)
        pair64 = testing.sw_pair_setup(tmp, "128_128", device=cpu, dtype=f64)
    spec, models = pair["spectral"], pair["models"]
    ngpt = spec.ngpt
    data = rfmip_data_from_arrays(testing.synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=True))
    kw = dict(spectral=spec, solar_source=pair["solar"])

    _, ssa, mu0 = testing.rfmip_sw_optics64(data, pair64["models"], spec)
    day = torch.as_tensor(data.sza < 90.0)
    dist = (pifm_eigenvalue(ssa, torch.zeros_like(ssa))[2] * mu0[:, None, None] - 1.0).abs()
    near = dist[day] <= 1e-3
    q = np.quantile(ssa.numpy(), [0.0, 0.05, 0.5, 0.95, 1.0])
    print(f"sw-pair {NCOL}x{NLAY}, {ngpt} g-points ({os.path.basename(pair['paths'][0])}): ssa "
          f"quantiles 0/5/50/95/100% " + " ".join(f"{v:.6g}" for v in q)
          + f"; {float(near.double().mean()):.4e} of the day cells ({int(near.sum())} of "
          f"{near.numel()}) within 1e-3 of k*mu0 = 1, in {int(near.any(2).any(1).sum())} of "
          f"{int(day.sum())} day columns; smallest |k*mu0 - 1| {float(dist[day].min()):.3e}")
    require(q[0] < 1e-3 and q[-1] > 0.99, "the pair's ssa does not span [0, 1]")
    ref = rfmip.rfmip_clear_sky_sw(data, pair64["models"], dtype=f64, device=cpu, **kw)

    reset_counts()
    fb_fused = rfmip.rfmip_clear_sky_sw(data, models, device=dev, **kw)
    c_fused = read_counts()
    reset_counts()
    with config_override(use_megakernel=False):
        staged = rfmip.rfmip_clear_sky_sw(data, models, device=dev, **kw)
    c_staged = read_counts()
    print(f"sw-pair launches: fused rfmip_clear_sky_sw {c_fused}, staged {c_staged}")
    require(c_fused == {"k2": 1} and c_staged == {"fused_predict_sw": 1},
            "the pair's SW requests did not launch K2 once (fused) or K5 once (staged)")
    for fb in (fb_fused, staged):
        for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
            v = getattr(fb, n)
            require(tuple(v.shape) == (NCOL, NLAY + 1) and bool(torch.isfinite(v).all()),
                    f"sw-pair {n}: {tuple(v.shape)} or not finite")
    e_fused = hold_sw(fb_fused, ref, "sw-pair fused SW (K2) vs float64")
    e_staged = hold_sw(staged, ref, "sw-pair staged SW (K5) vs float64")
    e_routes = hold_sw(staged, fb_fused, "sw-pair staged vs fused SW")
    print(f"sw-pair vs float64 on the CPU, in every column: fused (K2) {e_fused:.3e}, staged (K5) "
          f"{e_staged:.3e}; staged vs fused {e_routes:.3e} W/m2 (tol {SW_ATOL}) | {card}")

    solar = torch.as_tensor(pair["solar"], dtype=torch.float32, device=dev)
    args, _ = fused.sw_args(models, None,
                            *rfmip.sw_fused_inputs(solar, *rfmip.sw_canonical_inputs(data, dev)))
    outs_k = k2.sw_clearsky_megakernel(*args)
    torch.cuda.synchronize()
    outs_p = k2.sw_clearsky_megakernel_plain(*args)
    outs_64 = k2.sw_clearsky_megakernel_plain(*in_float64(args, {})[0])
    e2 = max(maxabs(a, b) for a, b in zip(outs_k, outs_p))
    print(f"sw-pair K2 {NCOL}x{NLAY}x{ngpt}: max|kernel-plain| {e2:.3e} W/m2 (tol {SW_ATOL}); vs "
          f"float64 plain: kernel {max(maxabs(a, b) for a, b in zip(outs_k, outs_64)):.3e}, "
          f"plain {max(maxabs(a, b) for a, b in zip(outs_p, outs_64)):.3e}")
    adjudicate("K2 on the pair", e2, SW_ATOL, outs_k, outs_p, outs_64)
    ncell = NCOL * NLAY
    result = {"max_abs_err": e2, **bound(
        nbytes(*args[2:4], *args[5:]) + model_bytes(*models) + 3 * NCOL * (NLAY + 1) * 4,
        sum(mlp_flops(m, ncell) for m in models) + ELEMENT_FLOPS["sw"] * ncell * ngpt)}
    timed = {"k2_pair": cuda_ms(lambda: k2.sw_clearsky_megakernel(*args)),
             "k2_pair_plain": cuda_ms(lambda: k2.sw_clearsky_megakernel_plain(*args), reps=9)}
    print(f"timing sw-pair K2 (ngpt {ngpt}): {timed['k2_pair']:.4f} ms, plain twin "
          f"{timed['k2_pair_plain']:.4f} ms; bound {result['bound_ms']:.4f} ms by "
          f"{result['bound_by']} ({result['bound_ms'] / timed['k2_pair']:.3f} of it) | {card}")

    stand = load_model_netcdf(SW_MODEL, device=dev)
    stand_spec = spectral_for("sw", [stand, stand], entry="sw_pair_phase",
                              accepts=(sw_spectral_g112,))
    stand_solar = torch.as_tensor(rfmip.default_solar_source(stand_spec),
                                  dtype=torch.float32, device=dev)
    sw_in = rfmip.sw_staged_inputs(data, dev)
    cores = {"pair": lambda: rfmip._sw_core_lay_major(models, solar, *sw_in, top_at_1=True),
             "stand-in": lambda: rfmip._sw_core_lay_major([stand, stand], stand_solar, *sw_in,
                                                          top_at_1=True)}
    for name, core in cores.items():
        ms = cuda_ms(core)
        launches, busy = profiled_calls(core)
        print(f"timing sw-pair staged SW core, {name}: {ms:.4f} ms, {launches:.1f} kernel launches "
              f"a call, device busy {busy:.4f} ms a call (idle share {1 - busy / ms:.4f}) | {card}")
    print(f"sw-pair phase: {time.perf_counter() - t_phase:.1f} s | {card}")
    return result, {"k2_pair": c_fused["k2"]}, timed


ALLSKY_PAIR_WIDE = BENCH_ALLSKY_WIDE  # P2's larger size: the all-sky bench's --ncol


def read_mode_counts() -> dict:
    """read_counts, with K1's and K2's launches also by mode (k1_<mode>,
    k2_<mode>)."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    c = read_counts()
    for tag, mod in (("k1", k1), ("k2", k2)):
        c.update({f"{tag}_{k}": v for k, v in mod.MODE_LAUNCHES.items() if v})
    return c


@contextlib.contextmanager
def no_twins():
    """While the block runs, every kernel's plain twin raises: a call on the
    card that reached a twin fails instead of running it."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    def twin(*args, **kwargs):
        raise SmokeFailure("a kernel's plain twin ran on the card")

    saved = [(mod, name, getattr(mod, name)) for mod in (k1, k2, k6, k7, mlp)
             for name in dir(mod) if name.endswith("_plain") and callable(getattr(mod, name))]
    for mod, name, _ in saved:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def allsky_pair_phase(dev, card) -> tuple[dict, dict, dict]:
    """Phase 28: the all-sky path at the net shapes users run. P1
    (testing.allsky_pair_setup, NCOL x NLAY from SEED: a GCM step's recipe
    on columns that all differ, every third column clear, mu0 clipped to
    [0.05, 1]; SW on the 128_128 sw-synth56-lut pair at 56 g-points, LW on
    the 18 -> 64 -> 64 -> 256 net), in both cloud flavours: the float64 ssa
    and g quantiles and the day cells and columns within 1e-3 of k*mu0 = 1;
    the fused cores (K1 and K2 once each in the flavour's cloud mode) and
    the staged cores (K3 + K7 once, K5 once a call, the log-depth adding K5
    once), each with the counts set to 0 just before and read just after
    and every twin raising, each within LW_ATOL / SW_ATOL of the port's
    float64 CPU run in every column; K2 and K1 in both cloud modes against
    their twins on the same CUDA tensors (float64 deciding beyond) and,
    with every cloud field 0, against their clear mode (1e-3 W/m2: the
    cloud combine's float32 guard), their times, their twins' and their
    bounds. P2: allsky_lw / allsky_sw on a
    synthetic Garand file with the same nets and coefficient files at NCOL
    and ALLSKY_PAIR_WIDE columns on every route, counted, against float64
    (6 columns, which the file's 2 profiles and the 3-column cloud pattern
    repeat), and the all-sky cores' times at both sizes (the log-depth
    ones at NCOL only). Returns (the four
    kernel entries, their launches, their times) for the kernels line."""
    import tempfile

    import torch

    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky, fused
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.ops.sw_solver import pifm_eigenvalue
    from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

    t_phase = time.perf_counter()
    cpu, f64 = torch.device("cpu"), torch.float64
    results, launches, timed = {}, {}, {}
    modes = (("lut", "cld_lut"), ("pade", "cld_bands"))
    with tempfile.TemporaryDirectory() as tmp:
        p = testing.allsky_pair_setup(tmp, "128_128", NCOL, NLAY, SEED, dev)
        p64 = testing.allsky_pair_setup(tmp, "128_128", NCOL, NLAY, SEED, cpu, f64)
        garand = os.path.join(tmp, "garand-synthetic.nc")
        write_nc(garand, *testing.garand_nc_variables(testing.synthesize_garand(NLAY, SEED)))
        pair, lw_model = p["sw"], p["lw_models"][0]
        sw_spec, lw_spec = pair["spectral"], p["lw_spectral"]
        day = p64["day"]
        print(f"allsky-pair P1 {NCOL}x{NLAY}: SW {os.path.basename(pair['paths'][0])} and its "
              f"Rayleigh net, {sw_spec.ngpt} g-points, {sw_spec.nband} bands; LW "
              f"{testing.LW_NET_64} ({lw_model.dims}); {int(day.sum())} day columns, "
              f"{int((~torch.as_tensor(p['cloud_col'])).sum())} clear ones")
        ncell, rows = NCOL * NLAY, NCOL * NLAY
        for flavour, mode in modes:
            # the float64 optics after the clouds' increment, and the resonance
            op = testing.allsky_pair_optics64(p64, flavour)
            dist = (pifm_eigenvalue(op.ssa, op.g)[2] * p64["mu0"][:, None, None] - 1.0).abs()
            near = dist[day] <= 1e-3
            q = lambda a: " ".join(f"{v:.6g}" for v in np.quantile(a.numpy(),
                                                                  [0.0, 0.05, 0.5, 0.95, 1.0]))
            print(f"allsky-pair {flavour}: float64 ssa quantiles 0/5/50/95/100% {q(op.ssa)}; g "
                  f"{q(op.g)}; {int(near.sum())} of {near.numel()} day cells within 1e-3 of "
                  f"k*mu0 = 1, in {int(near.any(2).any(1).sum())} of {int(day.sum())} day "
                  f"columns; smallest |k*mu0 - 1| {float(dist[day].min()):.3e}")
            require(float(op.ssa.min()) < 1e-3 and float(op.ssa.max()) > 0.99
                    and float(op.g.max()) > 0.3, "P1's ssa does not span [0, 1] or no cloud g")

            # every route, counted, no twin, against the port's float64 run
            refs = testing.allsky_pair_cores(p64, flavour)
            ref = {"lw": refs["lw_lay_major"](), "sw": refs["sw_staged"]()}
            expect = {"lw_fused": {"k1": 1, f"k1_{mode}": 1},
                      "sw_fused": {"k2": 1, f"k2_{mode}": 1},
                      "lw_staged": {"fused_predict_lw_both": 1, "k7": 1, "k7_angles": 1},
                      "sw_staged": {"fused_predict_sw": 1},
                      "sw_parallel": {"fused_predict_sw": 1}}
            cores, out, counted = testing.allsky_pair_cores(p, flavour), {}, {}
            with no_twins():
                for name, want in expect.items():
                    reset_counts()
                    out[name] = cores[name]()
                    counted[name] = read_mode_counts()
                    require(counted[name] == want, f"allsky-pair {flavour} {name}: launches "
                                                   f"{counted[name]}, expected {want}")
            print(f"allsky-pair {flavour} launches (no twin ran): "
                  + "; ".join(f"{n} {w}" for n, w in expect.items()))
            for name, fb in out.items():
                band = name[:2]
                for n in LW_FLUXES + (("flux_dn_dir",) if band == "sw" else ()):
                    v = getattr(fb, n)
                    require(v.device.type == dev.type and tuple(v.shape) == (NCOL, NLAY + 1)
                            and bool(torch.isfinite(v).all()),
                            f"allsky-pair {name}.{n}: {tuple(v.shape)} or not finite")
            errs = {}
            for name, fb in out.items():
                lw = name.startswith("lw")
                err = col_err(fb, ref[name[:2]], LW_FLUXES if lw else SW_FLUXES)
                errs[name] = (hold_columns(f"allsky-pair {flavour} {name}", err,
                                           LW_ATOL if lw else SW_ATOL), int(np.argmax(err)))
            e_lw = hold_columns(f"allsky-pair {flavour} LW fused vs staged",
                                col_err(out["lw_fused"], out["lw_staged"], LW_FLUXES), LW_ATOL)
            e_sw = hold_sw(out["sw_fused"], out["sw_staged"], f"allsky-pair {flavour} SW fused "
                                                              "vs staged")
            print(f"allsky-pair {flavour} vs float64 on the CPU, in every column (LW tol "
                  f"{LW_ATOL}, SW {SW_ATOL}): "
                  + ", ".join(f"{n} {e:.3e} at column {c}" for n, (e, c) in errs.items())
                  + f"; fused vs staged LW {e_lw:.3e}, SW {e_sw:.3e} W/m2 | {card}")
            sw_dn = out["sw_fused"].flux_dn[:, -1] * p["day"]
            print(f"allsky-pair {flavour}: mean surface SW down (night masked) "
                  f"{float(sw_dn.mean()):.4f}, LW down {float(out['lw_fused'].flux_dn[:, -1].mean()):.4f}"
                  f", OLR {float(out['lw_fused'].flux_up[:, 0].mean()):.4f} W/m2")
            launches[f"k2_{mode}_pair"] = counted["sw_fused"][f"k2_{mode}"]
            launches[f"k1_{mode}_64"] = counted["lw_fused"][f"k1_{mode}"]

            # the kernels against their twins on the same CUDA tensors
            cld = p["lw_canon"][6:10]
            sargs, skw = fused.sw_args(*testing.allsky_pair_fused(p, "sw", flavour))
            largs, lkw = fused.lw_args(*testing.allsky_pair_fused(p, "lw", flavour))
            cases = {
                f"k2_{mode}_pair": (k2.sw_clearsky_megakernel, k2.sw_clearsky_megakernel_plain,
                                    sargs, skw, SW_ATOL),
                f"k1_{mode}_64": (k1.lw_clearsky_mega4, k1.lw_clearsky_mega4_plain, largs, lkw,
                                  LW_ATOL),
            }
            for key, (kernel, plain, args, kw, tol) in cases.items():
                got = kernel(*args, **kw)
                torch.cuda.synchronize()
                twin = plain(*args, **kw)
                e = max(maxabs(a, b) for a, b in zip(got, twin))

                def ref64(args=args, kw=kw, plain=plain):
                    a, k = in_float64(args, kw)
                    return plain(*a, **k)

                adjudicate_lazy(f"{key} ({mode})", e, tol, got, twin, ref64)
                # the cloud combine's float32 guard: no cloud gives the clear mode
                bare = max(maxabs(a, b) for a, b in zip(
                    kernel(*args, **testing.without_clouds(kw)), kernel(*args)))
                require(bare <= 1e-3, f"{key} without clouds is {bare:.3e} W/m2 off its clear "
                                      "mode")
                if key.startswith("k2"):
                    plan = k2.launch_plan(NLAY, args[2].shape[-1], [m.dims[1] for m in args[:2]],
                                          [m.dims[2] for m in args[:2]], sw_spec.ngpt)
                    b = bound(nbytes(*args[2:4], *args[5:], list(kw.values()))
                              + model_bytes(*pair["models"]) + 3 * NCOL * (NLAY + 1) * 4,
                              sum(mlp_flops(m, rows) for m in pair["models"])
                              + ELEMENT_FLOPS["sw"] * ncell * sw_spec.ngpt
                              + cloud_flops("sw", mode, cld, sw_spec.nband, sw_spec.ngpt))
                else:
                    plan = k1.launch_plan(NLAY, args[1].shape[-1], lw_model.dims[1],
                                          lw_model.dims[2], lw_spec.ngpt)
                    b = bound(nbytes(*args[1:3], *args[5:9], args[11], list(kw.values()))
                              + model_bytes(lw_model)
                              + nbytes(p["table"].totplnk, p["table"].totplnk_diff)
                              + 2 * NCOL * (NLAY + 1) * 4,
                              mlp_flops(lw_model, rows) + ELEMENT_FLOPS["lw"] * ncell * lw_spec.ngpt
                              + cloud_flops("lw", mode, cld, lw_spec.nband, lw_spec.ngpt))
                results[key] = {"max_abs_err": e, **b}
                timed[key] = cuda_ms(lambda: kernel(*args, **kw))
                timed[f"{key}_plain"] = cuda_ms(lambda: plain(*args, **kw), reps=5, batch=5)
                print(f"allsky-pair {key}: max|kernel-twin| {e:.3e} W/m2 (tol {tol}); without "
                      f"clouds vs the clear mode {bare:.3e}; plan "
                      f"{plan.threads} threads, {plan.groups} groups of {plan.layers_per_group} "
                      f"layers, {plan.smem_bytes} B shared; {timed[key]:.4f} ms, twin "
                      f"{timed[f'{key}_plain']:.4f} ms; bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']} ({b['bound_ms'] / timed[key]:.3f} of it) | {card}")

        # P2: the entry points on a Garand file with the same nets and files
        tile = torch.arange(ALLSKY_PAIR_WIDE) % 6
        sw_kw = dict(spectral=sw_spec, solar_source=pair["solar"])
        solar_sum = float(np.sum(pair["solar"]))
        for flavour, mode in modes:
            lw_co, sw_co = (p["cloud_paths"][f"{b}_{flavour}"] for b in ("lw", "sw"))
            ref_lw = allsky.allsky_lw(garand, lw_co, p64["lw_models"], ncol=6, device=cpu,
                                      dtype=f64)
            ref_sw = allsky.allsky_sw(garand, sw_co, p64["sw"]["models"], ncol=6, device=cpu,
                                      dtype=f64, **sw_kw)
            routes = {"fused": (dict(use_megakernel=True), {}),
                      "staged": (dict(use_megakernel=False), {}),
                      "parallel": ({}, dict(scan_mode="parallel"))}
            want = {"fused": ({"k1": 1, f"k1_{mode}": 1}, {"k2": 1, f"k2_{mode}": 1}),
                    "staged": ({"fused_predict_lw_both": 1, "k7": 1, "k7_angles": 1},
                               {"fused_predict_sw": 1}),
                    "parallel": ({"fused_predict_lw_both": 1}, {"fused_predict_sw": 1})}
            for ncol in (NCOL, ALLSKY_PAIR_WIDE):
                line = []
                for route, (cfg, kw) in routes.items():
                    with config_override(**cfg), no_twins():
                        reset_counts()
                        lw = allsky.allsky_lw(garand, lw_co, p["lw_models"], ncol=ncol,
                                              device=dev, **kw)
                        c_lw = read_mode_counts()
                        reset_counts()
                        sw = allsky.allsky_sw(garand, sw_co, pair["models"], ncol=ncol,
                                              device=dev, **sw_kw, **kw)
                        c_sw = read_mode_counts()
                    require((c_lw, c_sw) == want[route],
                            f"allsky-pair P2 {flavour} {route} at {ncol}: launches LW {c_lw}, "
                            f"SW {c_sw}, expected {want[route]}")
                    t = tile[:ncol]
                    ref_t = lambda fb, names: type(fb)(**{n: getattr(fb, n)[t] for n in names})
                    e_lw = hold_columns(f"allsky-pair P2 {flavour} {route} LW at {ncol}",
                                        col_err(lw, ref_t(ref_lw, LW_FLUXES), LW_FLUXES), LW_ATOL)
                    e_sw = hold_sw(sw, ref_t(ref_sw, SW_FLUXES),
                                   f"allsky-pair P2 {flavour} {route} SW at {ncol}")
                    toa = float((sw.flux_dn[:, 0].double() - solar_sum * ALLSKY_MU0).abs().max()
                                / (solar_sum * ALLSKY_MU0))
                    require(toa <= 1e-5, f"allsky-pair P2 SW TOA down off sum(solar)*mu0 by "
                                         f"{toa:.2e}")
                    line.append(f"{route} LW {e_lw:.3e} SW {e_sw:.3e} (launches {c_lw}, {c_sw})")
                print(f"allsky-pair P2 {flavour} {ncol} columns vs float64, every column: "
                      + "; ".join(line))

        # the all-sky cores' times at both sizes (lookup-table clouds)
        paths = {"garand": garand, "lw_lut": p["cloud_paths"]["lw_lut"],
                 "sw_lut": p["cloud_paths"]["sw_lut"]}
        # (samples, calls a sample) by route: fewer where a call takes tens of ms
        for ncol, plan in ((NCOL, {"fused": (25, 10), "staged": (9, 10), "parallel": (9, 10)}),
                           (ALLSKY_PAIR_WIDE, {"fused": (9, 3), "staged": (5, 2)})):
            closures = allsky_core_closures(dev, lw_model, pair["models"], paths, ncol, sw_spec,
                                            pair["solar"])
            ms = {k: cuda_ms(fn, *plan[k.rsplit("_", 1)[1]]) for k, fn in closures.items()
                  if k.rsplit("_", 1)[1] in plan}
            print(f"timing allsky-pair P2 cores at {ncol}x{NLAY}, ms: "
                  + ", ".join(f"{k[7:]} {v:.4f}" for k, v in ms.items()) + f" | {card}")
            for route in plan:
                both = ms[f"allsky_lw_core_{route}"] + ms[f"allsky_sw_core_{route}"]
                print(f"timing allsky-pair P2 LW+SW cores at {ncol}, {route}: {both:.4f} ms, "
                      f"{ncol / both * 1e3:.0f} columns/s | {card}")
    print(f"allsky-pair phase: {time.perf_counter() - t_phase:.1f} s | {card}")
    return results, launches, timed


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    try:
        import rte_rrtmgp_nn_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script: {e}")
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, spectral_for, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import NNModel, load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    # ---- 1. environment ----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    nvcc_ver = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc [{nvcc_ver}] device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"env: tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} (both off)")
    print(f"card: {card}")
    # phase 22 forks its ranks from this server: started now, its imports
    # (torch, torch._dynamo) overlap the build and the phases before it
    from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist

    pdist.start_rank_server()

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    info = build.BUILD_INFO
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s, "
          f"cached={info.get('cached', False)}) -> {os.path.relpath(info['path'], HERE)}")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    lw_spec = spectral_for("lw", [lw_model], entry="chip_smoke.py", accepts=(lw_spectral_g128,))
    sw_spec = spectral_for("sw", [sw_model, sw_model], entry="chip_smoke.py",
                           accepts=(sw_spectral_g112,))
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    data = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=True))
    lw_in = rfmip.lw_canonical_inputs(data, lw_spec, dev)
    sw_in = rfmip.sw_canonical_inputs(data, dev)
    lw_args = fused.lw_args([lw_model], table, lw_spec, *lw_in)[0]
    sw_args = fused.sw_args([sw_model, sw_model], None, *rfmip.sw_fused_inputs(solar, *sw_in))[0]
    results = {}

    def model64(m: NNModel) -> NNModel:
        return NNModel([w.double() for w in m.weights], [b.double() for b in m.biases],
                       m.activations, m.input_names, m.input_min.double(),
                       m.input_max.double(), m.output_mean.double(), m.output_std.double())

    # ---- 3. K1 vs plain -----------------------------------------------------
    up_k, dn_k = k1.lw_clearsky_mega4(*lw_args)
    torch.cuda.synchronize()
    up_p, dn_p = k1.lw_clearsky_mega4_plain(*lw_args)
    a64 = in_float64(lw_args, {})[0]
    up_64, dn_64 = k1.lw_clearsky_mega4_plain(*a64)
    require(bool(torch.isfinite(up_k).all() and torch.isfinite(dn_k).all()), "K1 output not finite")
    e1 = max(maxabs(up_k, up_p), maxabs(dn_k, dn_p))
    print(f"K1 lw_clearsky_mega4 {NCOL}x{NLAY}: max|kernel-plain| up {maxabs(up_k, up_p):.3e} "
          f"dn {maxabs(dn_k, dn_p):.3e} W/m2 (tol {LW_ATOL}); vs float64 plain: kernel "
          f"{max(maxabs(up_k, up_64), maxabs(dn_k, dn_64)):.3e}, plain "
          f"{max(maxabs(up_p, up_64), maxabs(dn_p, dn_64)):.3e}; mean dn {float(dn_k.mean()):.4f}")
    adjudicate("K1", e1, LW_ATOL, (up_k, dn_k), (up_p, dn_p), (up_64, dn_64))
    ncell = NCOL * NLAY
    results["k1"] = {"max_abs_err": e1, **bound(
        nbytes(*lw_args[1:3], *lw_args[5:9], lw_args[11]) + model_bytes(lw_model)
        + nbytes(table.totplnk, table.totplnk_diff) + 2 * NCOL * (NLAY + 1) * 4,
        mlp_flops(lw_model, ncell) + ELEMENT_FLOPS["lw"] * ncell * lw_spec.ngpt)}

    # ---- 4. K2 vs plain -----------------------------------------------------
    outs_k = k2.sw_clearsky_megakernel(*sw_args)
    torch.cuda.synchronize()
    outs_p = k2.sw_clearsky_megakernel_plain(*sw_args)
    s64 = in_float64(sw_args, {})[0]
    outs_64 = k2.sw_clearsky_megakernel_plain(*s64)
    names = ("up", "dn", "dn_dir")
    require(all(bool(torch.isfinite(o).all()) for o in outs_k), "K2 output not finite")
    errs = {n: maxabs(a, b) for n, a, b in zip(names, outs_k, outs_p)}
    e2 = max(errs.values())
    print(f"K2 sw_clearsky_megakernel {NCOL}x{NLAY}: max|kernel-plain| "
          + " ".join(f"{n} {v:.3e}" for n, v in errs.items())
          + f" W/m2 (tol {SW_ATOL}); vs float64 plain: kernel "
          f"{max(maxabs(a, b) for a, b in zip(outs_k, outs_64)):.3e}, plain "
          f"{max(maxabs(a, b) for a, b in zip(outs_p, outs_64)):.3e}")
    adjudicate("K2", e2, SW_ATOL, outs_k, outs_p, outs_64)
    usecol = sw_in[5]
    fb = rfmip._sw_core_mega_canon([sw_model, sw_model], solar, *sw_in, top_at_1=True)
    night = ~usecol
    require(int(night.sum()) > 0, "the synthesized atmosphere has no night column")
    for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        require(bool((getattr(fb, n)[night] == 0).all()), f"night columns of {n} not zero")
    print(f"K2 night columns: {int(night.sum())} of {NCOL}, all fluxes exactly 0")
    results["k2"] = {"max_abs_err": e2, **bound(
        nbytes(*sw_args[2:4], *sw_args[5:]) + 2 * model_bytes(sw_model) + 3 * NCOL * (NLAY + 1) * 4,
        2 * mlp_flops(sw_model, ncell) + ELEMENT_FLOPS["sw"] * ncell * sw_spec.ngpt)}

    # ---- 5. main path: the fused kernels -------------------------------------
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    main = {}
    for top in (True, False):
        d = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=top))
        lw = rfmip.rfmip_clear_sky_lw(d, [lw_model], device=dev)
        sw = rfmip.rfmip_clear_sky_sw(d, [sw_model, sw_model], device=dev)
        torch.cuda.synchronize()
        main[top] = (d, lw, sw)
    launches = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES}
    print(f"main path launches: lw_clearsky_mega4 {launches['k1']}, "
          f"sw_clearsky_megakernel {launches['k2']}")
    require(launches["k1"] > 0 and launches["k2"] > 0, "a kernel of the main path was not launched")
    for top, (d, lw, sw) in main.items():
        for name, fbx in (("lw", lw), ("sw", sw)):
            for n in ("flux_up", "flux_dn", "flux_net"):
                v = getattr(fbx, n)
                require(v.device.type == dev.type and tuple(v.shape) == (NCOL, NLAY + 1),
                        f"{name}.{n}: {v.device} {tuple(v.shape)}")
                require(bool(torch.isfinite(v).all()), f"{name}.{n} not finite")
        # mu0 as the driver takes it (float32 cosine of the float32 angle)
        mu0 = torch.as_tensor(np.cos(np.deg2rad(d.sza)), dtype=torch.float64)
        day = torch.as_tensor(d.sza < 90.0 - 0.5 * np.finfo(np.float32).eps)
        toa = 0 if top else NLAY
        expect = torch.as_tensor(d.tsi, dtype=torch.float64) * mu0
        got = sw.flux_dn[:, toa].double().cpu()
        rel = float(((got - expect).abs() / expect)[day].max())
        require(rel <= 1e-3, f"SW TOA dn differs from TSI*mu0 by {rel:.3e} relative")
        require(bool((sw.flux_dn.cpu()[~day] == 0).all()), "night SW fluxes not zero")
        print(f"main top_at_1={top}: LW mean up {float(lw.flux_up.mean()):.4f} dn "
              f"{float(lw.flux_dn.mean()):.4f}; SW mean up {float(sw.flux_up.mean()):.4f} dn "
              f"{float(sw.flux_dn.mean()):.4f} dir {float(sw.flux_dn_dir.mean()):.4f} W/m2; "
              f"SW TOA dn vs TSI*mu0 max rel {rel:.2e}")
    (_, lw1, sw1), (_, lw0, sw0) = main[True], main[False]
    flip = max(maxabs(lw1.flux_up, lw0.flux_up.flip(1)), maxabs(lw1.flux_dn, lw0.flux_dn.flip(1)),
               maxabs(sw1.flux_up, sw0.flux_up.flip(1)), maxabs(sw1.flux_dn, sw0.flux_dn.flip(1)))
    print(f"main orientation check: max|top_at_1 - flipped bottom-first| {flip:.3e}")
    require(flip <= 1e-6, "the two vertical orientations disagree")

    # ---- 6. timing of the fused path, before the general phases -------------
    lw_core = lambda: fused.lw_core([lw_model], table, lw_spec, *lw_in, top_at_1=True)
    sw_core = lambda: rfmip._sw_core_mega_canon([sw_model, sw_model], solar, *sw_in,
                                                top_at_1=True)
    timed = {
        "k1": cuda_ms(lambda: k1.lw_clearsky_mega4(*lw_args)),
        "k1_plain": cuda_ms(lambda: k1.lw_clearsky_mega4_plain(*lw_args)),
        "k2": cuda_ms(lambda: k2.sw_clearsky_megakernel(*sw_args)),
        "k2_plain": cuda_ms(lambda: k2.sw_clearsky_megakernel_plain(*sw_args)),
        "lw_core": cuda_ms(lw_core),
        "sw_core": cuda_ms(sw_core),
    }
    d1 = main[True][0]
    t0 = time.perf_counter()
    for _ in range(5):
        rfmip.rfmip_clear_sky_lw(d1, [lw_model], device=dev)
        rfmip.rfmip_clear_sky_sw(d1, [sw_model, sw_model], device=dev)
    torch.cuda.synchronize()
    timed["drivers_host"] = (time.perf_counter() - t0) / 5 * 1e3

    # ---- 7. K3 / K4 / K5 vs plain ------------------------------------------
    mlp_errs, mlp_timers, mlp_bounds = mlp_phase(dev, lw_model, sw_model, data)
    for k, e in mlp_errs.items():
        results[k] = {"max_abs_err": e, **mlp_bounds[k]}

    # ---- 8. K7 vs plain -----------------------------------------------------
    k7_results, k7_timers = k7_phase(dev, lw_model, table, lw_spec, data)
    results.update(k7_results)

    # ---- 9. main path: the general RTE path ---------------------------------
    launches.update(general_main_path(dev, lw_model, sw_model, main))

    small = rfmip_data_from_arrays(synthesize_rfmip(64, NLAY, SEED + 1, top_at_1=True))
    cpu, f64 = torch.device("cpu"), torch.float64
    lw_cpu = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw_cpu = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    ref_lw = rfmip.rfmip_clear_sky_lw(small, [lw_cpu], device=cpu, dtype=f64)
    ref_sw = rfmip.rfmip_clear_sky_sw(small, [sw_cpu, sw_cpu], device=cpu, dtype=f64)
    got_lw = rfmip.rfmip_clear_sky_lw(small, [lw_model], device=dev)
    got_sw = rfmip.rfmip_clear_sky_sw(small, [sw_model, sw_model], device=dev)
    el = max(maxabs(got_lw.flux_up.cpu(), ref_lw.flux_up), maxabs(got_lw.flux_dn.cpu(), ref_lw.flux_dn))
    es = max(maxabs(getattr(got_sw, n).cpu(), getattr(ref_sw, n))
             for n in ("flux_up", "flux_dn", "flux_dn_dir"))
    print(f"reference 64x{NLAY}: CUDA drivers vs the staged plain path in float64 on the CPU: "
          f"LW {el:.3e} (tol {LW_ATOL}), SW {es:.3e} (tol {SW_ATOL}) W/m2")
    require(el <= LW_ATOL and es <= SW_ATOL, "CUDA main path disagrees with the CPU reference")
    ref_lw = rfmip.rfmip_clear_sky_lw(small, [lw_cpu], n_gauss_angles=N_ANGLES, device=cpu,
                                      dtype=f64)
    got_lw = rfmip.rfmip_clear_sky_lw(small, [lw_model], n_gauss_angles=N_ANGLES, device=dev)
    with config_override(use_megakernel=False):
        got_sw = rfmip.rfmip_clear_sky_sw(small, [sw_model, sw_model], device=dev)
    el = max(maxabs(got_lw.flux_up.cpu(), ref_lw.flux_up), maxabs(got_lw.flux_dn.cpu(), ref_lw.flux_dn))
    require(el <= LW_ATOL, "CUDA general LW path disagrees with the CPU reference")
    es = hold_sw(got_sw, ref_sw)
    print(f"reference 64x{NLAY}: CUDA general path vs float64 on the CPU: LW {N_ANGLES} angles "
          f"{el:.3e} (tol {LW_ATOL}), staged SW {es:.3e} W/m2 (tol {SW_ATOL} in every column)")

    # ---- 10. timing of the general path -------------------------------------
    timed.update({k: cuda_ms(fn, reps=9 if k.startswith("k7") and k.endswith("_plain") else 25)
                  for k, fn in {**mlp_timers, **k7_timers}.items()})
    lw_gen_in = rfmip.lw_staged_inputs(d1, lw_spec, dev)
    sw_gen_in = rfmip.sw_staged_inputs(d1, dev)
    timed["lw_core_general"] = cuda_ms(lambda: rfmip._lw_core(
        [lw_model], table, lw_spec, *lw_gen_in, top_at_1=True, n_gauss_angles=N_ANGLES))
    timed["sw_core_staged"] = cuda_ms(lambda: rfmip._sw_core_lay_major(
        [sw_model, sw_model], solar, *sw_gen_in, top_at_1=True))
    # the fused cores again, after phases 7-9 have run
    timed["lw_core_late"], timed["sw_core_late"] = cuda_ms(lw_core), cuda_ms(sw_core)
    for k, ms in timed.items():
        print(f"timing {k}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s at {NCOL}x{NLAY} | {card}")
    for tag, lw_k, sw_k in (("", "lw_core", "sw_core"),
                            (" after phases 7-9", "lw_core_late", "sw_core_late")):
        ms = timed[lw_k] + timed[sw_k]
        print(f"timing LW+SW cores{tag}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s | {card}")
    print(f"timing general LW core ({N_ANGLES} angles, K3 + K7) "
          f"{timed['lw_core_general']:.4f} ms, staged SW core (K5) {timed['sw_core_staged']:.4f} "
          f"ms | {card}")
    # ---- 11. cloud modes of K1/K2, K8, K9 ------------------------------------
    mode_results, mode_launches, mode_timers = modes_phase(
        dev, lw_model, sw_model, table, lw_spec, sw_spec, solar, data, lw_in, sw_in)
    results.update(mode_results)
    launches.update(mode_launches)

    # ---- 12. the all-sky main path ---------------------------------------------
    allsky_launches, allsky_timers = allsky_main_path(dev, lw_model, sw_model, float(solar.double().sum()))
    launches.update(allsky_launches)

    # ---- 13. timing of the new modes and the all-sky cores ---------------------
    # kernels and cores: the median of 25 samples; the plain twins, which
    # are launch-bound and slow, of 9
    late = {k: cuda_ms(fn, reps=9 if k.endswith(("_plain", "_parallel")) else 25)
            for k, fn in {**mode_timers, **allsky_timers}.items()}
    for k, ms in late.items():
        print(f"timing {k}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s at {NCOL}x{NLAY} | {card}")
    for route in ("fused", "staged", "parallel"):
        ms = late[f"allsky_lw_core_{route}"] + late[f"allsky_sw_core_{route}"]
        print(f"timing all-sky LW+SW cores, {route} route: {ms:.4f} ms, "
              f"{NCOL / ms * 1e3:.0f} columns/s | {card}")
    timed.update(late)

    # ---- 14 / 15. K6 and the prep LW core --------------------------------------
    results["k6"], prep_launches, prep_timed = prep_phase(
        dev, lw_model, table, lw_spec, lw_in, main, model64, a64[9], card)
    launches.update(prep_launches)
    timed.update(prep_timed)
    print(f"timing LW cores: prep (K6 + K7 fields mode) {timed['lw_core_prep']:.4f} ms, fused (K1) "
          f"{timed['lw_core_late']:.4f}, general ({N_ANGLES} angles, K3 + K7) "
          f"{timed['lw_core_general']:.4f} | {card}")

    # ---- 16. parallel scans through the RFMIP drivers ------------------------------
    parallel_phase(dev, lw_model, sw_model, main)

    # ---- 17. the lookup-table gas optics ---------------------------------------------
    timed.update(lut_phase(dev, card))

    # ---- 18. the fused kernels' geometry ------------------------------------------------
    for k, g in geometry_phase(dev, card, lw_model, sw_model, table, lw_spec, sw_spec, solar,
                               lw_args, sw_args).items():
        results[k].update(g)

    # ---- 19. K3-K6: geometry, and their times at four times the columns ---------------
    geometry, wide = kernels_wide_phase(dev, card, lw_model, sw_model, table, lw_spec)
    for k, g in geometry.items():
        results[k].update(g, ms_wide=wide[k])

    # ---- 20. the GCM sweep at 1,036,800 columns -------------------------------------------
    gcm_phase(dev, lw_model, sw_model, card)

    # ---- 21. NN training with radiation-in-the-loop evaluation --------------------------------
    training_phase(dev, card)

    # ---- 22. the column split over ranks: sharded cores, dry run, multichip bench -------------
    sharded_phase(dev, card, lw_model, sw_model, table, lw_spec, sw_spec, solar, lw_in, sw_in)

    # ---- 23. SW training from the lookup table through K5 --------------------------------------
    training_sw_phase(dev, card)

    # ---- 24. the command-line entry points, and the lay-major K7 route -------------------------
    timed.update(cli_phase(dev, card, lw_model, table, lw_spec, data))

    # ---- 25. the distillation demos and the SW calibrations -------------------------------------
    demos_phase(dev, card)

    # ---- 26. the benchmark entry points -----------------------------------------------------------
    bench_phase(card)

    # ---- 27. the SW main path on a real absorption + Rayleigh pair --------------------------------
    results["k2_pair"], pair_launches, pair_timed = sw_pair_phase(dev, card)
    launches.update(pair_launches)
    timed.update(pair_timed)

    # ---- 28. the all-sky path at the real net shapes --------------------------------------------
    allsky_results, allsky_launches, allsky_timed = allsky_pair_phase(dev, card)
    results.update(allsky_results)
    launches.update(allsky_launches)
    timed.update(allsky_timed)

    for k in results:
        results[k].update(launches=launches[k], ms=timed[k], plain_ms=timed[f"{k}_plain"])
        r = results[k]
        print(f"bound {k}: {r['bound_ms']:.4f} ms by {r['bound_by']}, measured {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.3f} of it) | {card}")
    results["card"] = card
    return results


def main() -> int:
    t0 = time.perf_counter()
    try:
        r = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED with an exception", file=sys.stderr)
        return 1
    import torch

    kernels = [
        {"name": "lw_clearsky_mega4", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:558", **r["k1"],
         "counted_around": "rfmip_clear_sky_lw, both orientations; also launched, not counted "
                           "here: lw_mega_core_sharded, once a rank a call at world size 1 and "
                           "on two ranks (phase 22); scripts/torch_run_rfmip.py and "
                           "torch_eval_rfmip.py, once a run (phase 24); "
                           "scripts/torch_train_demo.py, once a run (phase 25); "
                           "bench_torch.py, once a core or driver call (phase 26)"},
        {"name": "sw_clearsky_megakernel", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:391", **r["k2"],
         "counted_around": "rfmip_clear_sky_sw, both orientations; also launched, not counted "
                           "here: sw_mega_core_sharded, once a rank a call at world size 1 and "
                           "on two ranks (phase 22); scripts/torch_run_rfmip.py, once a run "
                           "(phase 24); bench_torch.py, once a core or driver call "
                           "(phase 26); rfmip_clear_sky_sw on the real 56-g-point pair, "
                           "once a call (phase 27, its own entry below)"},
        {"name": "fused_predict_lw_both", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/mlp.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/mlp.py:116", **r["k3"],
         "counted_around": "rfmip_clear_sky_lw(n_gauss_angles=3), both orientations; also "
                           "launched, not counted here: the dry run's g-point-split forward, "
                           "once a rank (phase 22); scripts/torch_train_demo.py, once an "
                           "epoch's eval (phase 25); bench_torch.py --core staged, once a "
                           "call (phase 26)"},
        {"name": "fused_predict_tau", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/mlp.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/mlp.py:156", **r["k4"],
         "counted_around": "rfmip_clear_sky_lw, two models, use_megakernel=False; also "
                           "launched, not counted here: scripts/torch_calibrate_sw_g112.py, "
                           "twice a run, on a 112- and a 224-output SW net (phase 25)"},
        {"name": "fused_predict_sw", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/mlp.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/mlp.py:179", **r["k5"],
         "counted_around": "rfmip_clear_sky_sw(use_megakernel=False), both orientations; also "
                           "launched, not counted here: the SW training eval, once an epoch "
                           "(phase 23); scripts/torch_train_demo_sw.py, once an epoch's eval "
                           "and once for the teacher's fluxes (phase 25); bench_torch.py "
                           "--core staged, once a call (phase 26); "
                           "rfmip_clear_sky_sw(use_megakernel=False) on the real 56-g-point "
                           "pair, once a call (phase 27)"},
        {"name": "lw_prep", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_prep.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:134", **r["k6"],
         "counted_around": "drivers.rfmip._lw_core_prep, both orientations: a core, no driver "
                           "routes to it"},
        {"name": "lw_noscat_broadband", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_noscat.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py:89", **r["k7"],
         "counted_around": "rfmip_clear_sky_lw(use_megakernel=False), one and two models: "
                           "one angle; also launched, not counted here: the dry run's "
                           "g-point-split forward, once a rank (phase 22); bench_torch.py "
                           "--core staged, once a call (phase 26)"},
        {"name": "lw_noscat_broadband[angles]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_noscat.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py:89", **r["k7_angles"],
         "counted_around": "rfmip_clear_sky_lw(n_gauss_angles=3), both orientations: all "
                           "three angles in one launch; also launched, not counted here: "
                           "scripts/torch_run_regression.py, once each of its nine broadband "
                           "LUT LW solves (one angle, three angles, per-(column, g-point) "
                           "optimal angles, the vertical reverse), and "
                           "lw_solver_noscat_lay_major, once a call (phase 24); "
                           "scripts/torch_train_demo.py, once an epoch's eval (phase 25)"},
        {"name": "lw_noscat_broadband[fields]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_noscat.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_solver.py:89", **r["k7_fields"],
         "counted_around": "drivers.rfmip._lw_core_prep, both orientations: a core, no driver "
                           "routes to it"},
        {"name": "lw_clearsky_mega4[cld_lut]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:431", **r["k1_cld_lut"],
         "counted_around": "allsky_lw, lookup-table cloud optics; also launched, not counted "
                           "here: scripts/torch_run_allsky.py, once a loop (phase 24); "
                           "scripts/torch_bench_allsky.py, once a call, and "
                           "torch_bench_gcm.py, once a block (phase 26)"},
        {"name": "lw_clearsky_mega4[cld_bands]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:448", **r["k1_cld_bands"],
         "counted_around": "allsky_lw, Pade cloud optics"},
        {"name": "sw_clearsky_megakernel[cld_lut]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:303", **r["k2_cld_lut"],
         "counted_around": "allsky_sw, lookup-table cloud optics; also launched, not counted "
                           "here: scripts/torch_run_allsky.py, once a loop (phase 24); "
                           "scripts/torch_calibrate_sw_solar.py, once a band on a source in "
                           "that band alone, 14 a run (phase 25); "
                           "scripts/torch_bench_allsky.py, once a call, and "
                           "torch_bench_gcm.py, once a block (phase 26)"},
        {"name": "sw_clearsky_megakernel[cld_bands]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:321", **r["k2_cld_bands"],
         "counted_around": "allsky_sw, Pade cloud optics"},
        {"name": "sw_clearsky_megakernel[ngpt=56]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:391", **r["k2_pair"],
         "counted_around": "rfmip_clear_sky_sw on the real absorption + Rayleigh pair "
                           "(sw-synth56-lut 128_128, 56 g-points), once a call (phase 27)"},
        *({"name": f"sw_clearsky_megakernel[{mode},ngpt=56]", "route": "cuda",
           "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
           "replaces": f"rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:{line}",
           **r[f"k2_{mode}_pair"],
           "counted_around": "fused.sw_core on the all-sky problem of the real pair "
                             "(sw-synth56-lut 128_128, 56 g-points, 1800 x 60 varied "
                             "columns), once a call (phase 28); also launched, not counted "
                             "here: allsky_sw on the pair, once a call (phase 28)"}
          for mode, line in (("cld_lut", 303), ("cld_bands", 321))),
        *({"name": f"lw_clearsky_mega4[{mode},h=64]", "route": "cuda",
           "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_megakernel.cu",
           "replaces": f"rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:{line}",
           **r[f"k1_{mode}_64"],
           "counted_around": "fused.lw_core on the all-sky problem with the 18 -> 64 "
                             "-> 64 -> 256 LW net (1800 x 60 varied columns), once a call "
                             "(phase 28); also launched, not counted here: allsky_lw on that "
                             "net, once a call (phase 28)"}
          for mode, line in (("cld_lut", 431), ("cld_bands", 448))),
        {"name": "lw_clearsky_mega5", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/lw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:931", **r["k8"],
         "counted_around": "drivers.rfmip._lw_core_mega5: a core, no driver routes to it"},
        {"name": "sw_clearsky_megakernel[lanes]", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:491", **r["k9"],
         "counted_around": "sw_clearsky_megakernel(input_mode='lanes'): the wrapper, no driver route"},
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(r["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
