#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, RFMIP clear-sky LW + SW with NN gas optics at
1800 columns x 60 layers, through its hand-written CUDA kernels, and checks
it. Phases (any failure exits non-zero and prints no result line):

  1. environment: torch / CUDA / nvcc versions, the card and its power
     limit; TF32 off for matmuls and convolutions;
  2. build: nvcc compiles rte_rrtmgp_nn_tpu_torch/csrc/*.cu for sm_90a;
  3. K1 (lw_clearsky_mega4) against its plain PyTorch twin on the card,
     and both against the twin in float64;
  4. K2 (sw_clearsky_megakernel) likewise; night columns zero after the core;
  5. main path: rfmip_clear_sky_lw / _sw on CUDA in both vertical
     orientations, with each kernel's launch count read around it; outputs
     finite, (ncol, nlay+1), SW TOA down flux = TSI * mu0 on day columns,
     the two orientations mirror each other; then a small input against the
     staged plain path in float64 on the CPU;
  6. timing with CUDA events after warm-up (the median of 25 samples, each
     10 back-to-back calls): each kernel, its plain twin, and each driver
     core on device-resident inputs; both drivers on the host clock.

The models are the repository's in-repo stand-ins (artifacts/): the g-128
LW demo net, and the g-112 SW absorption demo net used as both the
absorption and the Rayleigh net. Atmospheres are synthesized from a seed
(rte_rrtmgp_nn_tpu_torch.testing). The last line of standard output is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

NCOL, NLAY, SEED = 1800, 60, 0
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the JAX package's kernel-vs-staged bounds
HERE = os.path.dirname(os.path.abspath(__file__))
LW_MODEL = os.path.join(HERE, "artifacts", "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_MODEL = os.path.join(HERE, "artifacts", "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")


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
    CUDA-event time of ``batch`` back-to-back calls divided by ``batch``.
    The host queues ahead of the card, so a call reads its device time
    unless its host-side launches are slower than the card."""
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


def to64(args):
    import torch

    out = []
    for a in args:
        if torch.is_tensor(a) and a.is_floating_point():
            out.append(a.double())
        else:
            out.append(a)
    return out


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    try:
        import rte_rrtmgp_nn_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script: {e}")
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
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

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    info = build.BUILD_INFO
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s, "
          f"cached={info.get('cached', False)}) -> {os.path.relpath(info['path'], HERE)}")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    data = rfmip_data_from_arrays(synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=True))
    lw_in = rfmip.lw_canonical_inputs(data, lw_spec, dev)
    sw_in = rfmip.sw_canonical_inputs(data, dev)
    lw_args = rfmip.lw_mega_args([lw_model], table, lw_spec, *lw_in)
    sw_args = rfmip.sw_mega_args([sw_model, sw_model], solar, *sw_in)
    results = {}

    def model64(m: NNModel) -> NNModel:
        return NNModel([w.double() for w in m.weights], [b.double() for b in m.biases],
                       m.activations, m.input_names, m.input_min.double(),
                       m.input_max.double(), m.output_mean.double(), m.output_std.double())

    # ---- 3. K1 vs plain -----------------------------------------------------
    up_k, dn_k = k1.lw_clearsky_mega4(*lw_args)
    torch.cuda.synchronize()
    up_p, dn_p = k1.lw_clearsky_mega4_plain(*lw_args)
    a64 = to64(lw_args)
    a64[0] = model64(lw_model)
    a64[9] = PlanckTable(table.totplnk.double(), table.totplnk_diff.double(),
                         table.temp_ref_min, table.totplnk_delta)
    up_64, dn_64 = k1.lw_clearsky_mega4_plain(*a64)
    require(bool(torch.isfinite(up_k).all() and torch.isfinite(dn_k).all()), "K1 output not finite")
    e1 = max(maxabs(up_k, up_p), maxabs(dn_k, dn_p))
    print(f"K1 lw_clearsky_mega4 {NCOL}x{NLAY}: max|kernel-plain| up {maxabs(up_k, up_p):.3e} "
          f"dn {maxabs(dn_k, dn_p):.3e} W/m2 (tol {LW_ATOL}); vs float64 plain: kernel "
          f"{max(maxabs(up_k, up_64), maxabs(dn_k, dn_64)):.3e}, plain "
          f"{max(maxabs(up_p, up_64), maxabs(dn_p, dn_64)):.3e}; mean dn {float(dn_k.mean()):.4f}")
    adjudicate("K1", e1, LW_ATOL, (up_k, dn_k), (up_p, dn_p), (up_64, dn_64))
    results["k1"] = {"max_abs_err": e1}

    # ---- 4. K2 vs plain -----------------------------------------------------
    outs_k = k2.sw_clearsky_megakernel(*sw_args)
    torch.cuda.synchronize()
    outs_p = k2.sw_clearsky_megakernel_plain(*sw_args)
    s64 = to64(sw_args)
    s64[0] = s64[1] = model64(sw_model)
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
    results["k2"] = {"max_abs_err": e2}

    # ---- 5. main path -------------------------------------------------------
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

    # ---- 6. timing ----------------------------------------------------------
    lw_core = lambda: rfmip._lw_core_mega4_canon([lw_model], table, lw_spec, *lw_in, top_at_1=True)
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
    for k, ms in timed.items():
        print(f"timing {k}: {ms:.4f} ms, {NCOL / ms * 1e3:.0f} columns/s at {NCOL}x{NLAY} | {card}")
    print(f"timing LW+SW cores: {timed['lw_core'] + timed['sw_core']:.4f} ms, "
          f"{NCOL / (timed['lw_core'] + timed['sw_core']) * 1e3:.0f} columns/s | {card}")
    results["k1"].update(launches=launches["k1"], ms=timed["k1"], plain_ms=timed["k1_plain"])
    results["k2"].update(launches=launches["k2"], ms=timed["k2"], plain_ms=timed["k2_plain"])
    results["card"] = card
    return results


def main() -> int:
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
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/lw_megakernel.py:558", **r["k1"]},
        {"name": "sw_clearsky_megakernel", "route": "cuda",
         "source": "rte_rrtmgp_nn_tpu_torch/csrc/sw_megakernel.cu",
         "replaces": "rte_rrtmgp_nn_tpu/ops/pallas/sw_megakernel.py:391", **r["k2"]},
    ]
    print(r["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
