#!/usr/bin/env python3
"""Time the kernels built on the tiled MLP (the fused K1 / K2,
csrc/lw_megakernel.cu and csrc/sw_megakernel.cu; the MLP kernel of K3 / K5,
csrc/mlp.cu; K6, csrc/lw_prep.cu) at several tile shapes and block
geometries on one NVIDIA GPU.

    python3 scripts/tune_megakernel_tiles.py [--quick] [--k7]

A variant sets some of: layers per MLP pass, row padding, the register tile
(rows x columns) of the hidden layers and of the last layer, layer groups per
block (K1, K2, K6), the threads and rows per block of the MLP kernel (its
plan's choice narrowed). For each, edited copies of csrc/common.cuh and the sources
are built into a temporary directory and loaded in place of the package's
library, and the wrappers' launch plans are told the same constants; K1 and
K2 (clear-sky and in the lookup-table cloud mode), K3, K5 and K6 are checked
against the plain twins' results and timed (chip_smoke.cuda_ms around the
wrappers' calls) at chip_smoke.py's size (1800 x 60, the g-128 and g-112 demo
nets). The variants run in one order and then in the reverse order, so that
a drift of the card shows. Prints the card and, per build, the registers and
spill ptxas reports, the blocks per SM the CUDA runtime's occupancy call
gives, each kernel's error against its twin (the fused kernels' in W/m2,
K3 / K5 / K6 as the largest ratio to their bound) and its time.
``--quick`` builds the shipped configuration only, checks it at a ragged size
too and prints where the kernels' time goes: copies of the sources that
return after a phase (STOPS) are built and timed like the kernel itself, at
four times the columns, and a phase's time is the difference of two such
times. Beside each time stands the host's time to queue one call: a reading
near it is the host's, not the card's.

The LW transport (K7, csrc/lw_noscat.cu) is swept on its own, after the
others or, with ``--k7``, alone: its plan's geometry (4, 8 or 16 layers per
thread, and twice and half the segments per g-point) for one angle, three angles and
the fields mode at 128 g-points and one and three angles at 256, at 7200 x
60, each variant
checked against the twin and printed with its blocks per SM; in both
passes. With ``--quick`` the shipped plan only, and where its time goes:
copies of the source that return after phase A (loads, trans and the
sources, the segments' maps) and after the down sweep, and ablation copies
(no divide, no exponential, no level sums) timed for what each costs.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    K6_SRC_REL, K6_TRANS_ATOL, LW_MODEL, MLP_RTOL, NCOL, NLAY, SEED, SW_MODEL, cuda_ms,
    gpu_line, k6_args, maxabs, mlp_inputs, mode_cases)

# the constants of csrc/common.cuh a variant may set, with the shipped values,
# the most layer groups a plan may take and the threads and rows per block
# the MLP kernel's plan may take (None: its shipped choices)
PLAN_KEYS = ("groups", "mlp_threads", "mlp_rows")
SHIPPED = {"kMegaRows": 16, "kRowPad": 4, "kTileR": 8, "kTileC": 2, "kOutR": 8, "kOutC": 4,
           "groups": 4, "mlp_threads": None, "mlp_rows": None}
SHIPPED_CONSTANTS = {k: v for k, v in SHIPPED.items() if k not in PLAN_KEYS}
SOURCES = ("lw_megakernel", "sw_megakernel", "mlp", "lw_prep", "lw_noscat", "errors")
VARIANTS = (
    {},                             # the shipped configuration
    {"kOutR": 16, "kOutC": 2},      # the last layer as 16 x 2 tiles
    {"kOutC": 2},                   # as 8 x 2 tiles, two per thread
    {"kOutR": 16},                  # as 16 x 4 tiles: 64 sums, half the threads
    {"kTileR": 4, "kTileC": 4},     # hidden layers as 4 x 4 tiles
    {"kTileR": 4, "kTileC": 4, "kOutR": 16, "kOutC": 2},  # both
    {"kTileC": 4},                  # as 8 x 4 tiles, half the threads
    {"kRowPad": 0},                 # no padding: the activations' stores conflict
    {"groups": 2},                  # 256 threads
    {"mlp_threads": 512},           # the MLP kernel as one block of 512 threads an SM
    {"mlp_threads": 512, "mlp_rows": 32},
    {"mlp_threads": 512, "mlp_rows": 128},
    {"mlp_rows": 64},               # two blocks of 256 at 64 rows (K3's slabs shrink to fit)
    {"mlp_rows": 128},              # K5 at 128 rows in two blocks of 256; K3 takes 512 threads
)


# --quick: where a copy of a kernel returns, by the source line that opens
# what it leaves out; in the kernels' order, so that the differences of the
# copies' times are the phases' times
STOPS = {
    "lw_megakernel.cu": (
        ("nets", "  // The level-top source of the first layer of the group below, from the\n"),
        ("sources", "  // The sweeps are recurrences down and up the column, one thread per\n"),
        ("sweeps", "  // ---- per-level spectral sums ------------------------------------------\n"),
    ),
    "sw_megakernel.cu": (
        ("nets", "  // ---- phase A, second loop: tau, ssa (+ clouds) -> PIFM coefficients ------\n"),
        ("coefficients", "  // The sweeps are recurrences down the column, one thread per g-point (four\n"),
        ("direct beam", "  if (sweeper) {\n    // ---- phase C: surface-to-top cumulative albedo"),
        ("sweeps", "  // ---- per-level spectral sums ------------------------------------------\n"),
    ),
    "mlp.cu": (
        ("hidden layers", "      // the last layer is linear; its epilogue writes device memory\n"),
    ),
    "lw_prep.cu": (
        ("nets", "  // ---- transmittance and sources, stored -------------------------------------\n"),
    ),
}
LAST_PHASES = {"mlp.cu": "last layer and stores", "lw_prep.cu": "sources and stores"}
LAST_PHASE = "level sums"  # what the whole kernel runs beyond the last stop


def edited(text: str, values: dict) -> str:
    """csrc/common.cuh with the constants of ``values`` set."""
    for name, v in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in common.cuh")
    return text


def stopped(text: str, name: str, phase: str) -> str:
    """A fused kernel's source that returns once ``phase`` is done."""
    (anchor,) = [a for p, a in STOPS[name] if p == phase]
    if text.count(anchor) != 1:
        raise RuntimeError(f"{name}: the line that follows {phase!r} is not there once")
    # (a copy still on its way into shared memory lands before the block ends)
    return text.replace(anchor, '  asm volatile("cp.async.wait_all;" ::: "memory");\n  return;\n'
                        + anchor)


def build_variant(build, tmp: str, tag: str, values, stops=None) -> tuple[ctypes.CDLL, str]:
    """nvcc the sources, with the constants of ``values`` set and each kernel
    returning after the phase ``stops`` names for its file, into ``tmp``/
    ``tag``; returns (library, ptxas output)."""
    d = os.path.join(tmp, tag)
    os.makedirs(d, exist_ok=True)
    for name in ("common.cuh",) + tuple(f"{n}.cu" for n in SOURCES):
        text = (build.CSRC_DIR / name).read_text()
        if name == "common.cuh":
            text = edited(text, values)
        elif stops and name in stops:
            text = stopped(text, name, stops[name])
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    jobs = []
    for name in SOURCES:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-c", os.path.join(d, f"{name}.cu"), "-o",
               os.path.join(d, f"{name}.o")]
        jobs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True))
    log = ""
    for j in jobs:
        log += j.communicate()[0]
        if j.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
    so = os.path.join(d, "kernels.so")
    subprocess.run([build._nvcc(), "-shared", "-o", so]
                   + [os.path.join(d, f"{n}.o") for n in SOURCES], check=True)
    lib = ctypes.CDLL(so)
    build._declare(lib)
    return lib, log


# K7's stop copies: the line a copy returns before (its first occurrence),
# in the kernel's order
K7_STOPS = (
    ("phase A (loads, trans and sources, maps)",
     "    __syncthreads();\n#pragma unroll\n    for (int k = 0; k < NA; ++k) rad[k] = t == 0"),
    ("down sweep", "  // ---- surface, then the up sweep"),
)
# K7's ablation copies (timing only, wrong results): what a part of the
# arithmetic costs, by the text it replaces
K7_ABLATIONS = {
    "no divide": ("(1.0f - trans) / tl - trans", "(1.0f - trans) * tl - trans"),
    "no exponential": ("trans = expf(-tl);", "trans = 1.0f - tl;"),
    "no level sums": ("    transpose_sums<L, 16, L, NA>(rb, lane);\n", ""),
}


def k7_stopped(text: str, phase: str) -> str:
    """csrc/lw_noscat.cu returning once ``phase`` is done."""
    (anchor,) = [a for p, a in K7_STOPS if p == phase]
    if anchor not in text:
        raise RuntimeError(f"lw_noscat.cu: the line after {phase!r} is not there")
    return text.replace(anchor, "  return;\n" + anchor, 1)


def k7_cases(dev, lw_model, table, lw_spec, ncol):
    """{label: (mode, angles, call, twin)} of K7 at ``ncol`` x NLAY: the
    angles mode on gas_optics_lw_nn's fields (the diffusivity angle, three
    Gauss angles; 256 g-points from the fields repeated twice along g), the
    fields mode on K6's output."""
    import torch

    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, NLAY, SEED, top_at_1=True))
    play, plev, tlay, tlev, tsfc, emis_band, concs = rfmip.lw_staged_inputs(data, lw_spec, dev)
    tau, src = go.gas_optics_lw_nn([lw_model], play, plev, tlay, tsfc, GasConcs(concs),
                                   lw_spec, table, tlev=tlev)
    emis = lw_spec.expand(emis_band).contiguous()
    a128 = (tau, src.lay_source, src.lev_source, emis, src.sfc_source)
    a256 = tuple(torch.cat([a, a], -1).contiguous() for a in a128)
    fields = k6.lw_prep(*k6_args(dev, data, lw_model, table, lw_spec))
    gauss = lambda n: ([float(d) for d in plw.GAUSS_DS[n - 1, :n]],
                       [float(w) for w in plw.GAUSS_WTS[n - 1, :n]])
    out = {}
    for g, a in ((128, a128), (256, a256)):
        for n in (1, 3):
            out[f"K7 {n} angle(s) {g} g-points"] = (
                "angles", n, lambda a=a, n=n: k7.lw_noscat_broadband_angles(*a, *gauss(n)),
                lambda a=a, n=n: k7.lw_noscat_broadband_angles_plain(*a, *gauss(n)))
    sweeps = fields[:3] + (emis, fields[3])
    out["K7 fields 128 g-points"] = (
        "fields", 1, lambda: tuple(k7.lw_broadband_sweeps_kernel(*sweeps)[:2]),
        lambda: tuple(plw.lw_broadband_sweeps(*sweeps)[:2]))
    return out


def k7_sweep(build, tmp, dev, lw_model, table, lw_spec, quick: bool) -> int:
    """K7's geometry sweep (the shipped plan alone with ``quick``, then the
    stop copies). Returns the number of results beyond the bound."""
    import functools

    import torch

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    cases = k7_cases(dev, lw_model, table, lw_spec, 4 * NCOL)
    twins = {k: twin() for k, (_, _, _, twin) in cases.items()}
    smem = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    shipped = k7.lw_noscat_plan
    bad = 0

    def variants(nang, ngpt):
        """(seg_layers, segments): the shipped plan, the other layers per
        thread, and twice and half the shipped segments."""
        if quick:
            return [(None, None)]
        L = k7.seg_layers_for(nang)
        nseg = shipped(NLAY, ngpt, nang, smem).segments
        most = min(-(-NLAY // L), k7.max_threads(L) // max(ngpt, 32))
        return ([(None, None)] + [(other, None) for other in k7.SEG_LAYERS if other != L]
                + [(L, n) for n in (2 * nseg, nseg // 2) if 1 <= n <= most])

    for pass_no in range(1 if quick else 2):
        for name, (mode, nang, call, _) in cases.items():
            ngpt = 256 if "256" in name else 128
            vs = variants(nang, ngpt)
            for seg_layers, cap in (vs if pass_no == 0 else vs[::-1]):
                k7.lw_noscat_plan = functools.partial(shipped, seg_layers=seg_layers,
                                                      segments=cap)
                try:
                    plan = k7.lw_noscat_plan(NLAY, ngpt, nang, smem)
                    got = call()
                    torch.cuda.synchronize()
                    err = max(maxabs(a, b) for a, b in zip(got, twins[name]))
                    ok = err <= 2e-3 and all(bool(torch.isfinite(o).all()) for o in got)
                    bad += not ok
                    blocks = build.blocks_per_sm("lw_noscat_broadband", plan,
                                                 k7.MODE_CODES[mode], dev.index)
                    print(f"  {name} (pass {pass_no}) {plan.segments} segments of {plan.seg_layers} "
                          f"layers ({plan.threads} threads{', set' if cap else ''}), "
                          f"{plan.kept_tiers} tier(s) kept, {plan.smem_bytes} B, {blocks} block(s)/SM"
                          f": max|kernel-twin| {err:.3e} ({'ok' if ok else 'BEYOND'} 2e-3), "
                          f"{cuda_ms(call):.4f} ms at {4 * NCOL}x{NLAY}", flush=True)
                finally:
                    k7.lw_noscat_plan = shipped
    if quick:
        whole, rows = build._lib, {}

        def copy_with(tag, edit):
            d = os.path.join(tmp, f"k7_{tag.replace(' ', '_')}")
            os.makedirs(d, exist_ok=True)
            for name in ("common.cuh",) + tuple(f"{n}.cu" for n in SOURCES):
                text = (build.CSRC_DIR / name).read_text()
                with open(os.path.join(d, name), "w") as f:
                    f.write(edit(text) if name == "lw_noscat.cu" else text)
            return compile_dir(build, d)

        for tag, (old, new) in K7_ABLATIONS.items():
            def ablate(text, old=old, new=new):
                if old not in text:
                    raise RuntimeError(f"lw_noscat.cu: {old!r} is not there")
                return text.replace(old, new)
            build._lib = copy_with(tag, ablate)
            print("  K7 ablation " + tag + " (timing only): " + ", ".join(
                f"{k} {cuda_ms(c[2]):.4f} ms" for k, c in cases.items()), flush=True)
        for phase, _ in K7_STOPS:
            build._lib = copy_with(phase.split(" (")[0], lambda text, phase=phase: k7_stopped(text, phase))
            rows[phase] = {k: cuda_ms(c[2]) for k, c in cases.items()}
        build._lib = whole
        rows["up sweep and level sums"] = {k: cuda_ms(c[2]) for k, c in cases.items()}
        for k in cases:
            total, before = rows["up sweep and level sums"][k], 0.0
            print(f"  {k} by phase at {4 * NCOL}x{NLAY}, of {total:.4f} ms:")
            for phase, ms in rows.items():
                host = host_ms(cases[k][2])
                print(f"    through {phase}: {ms[k]:.4f} ms (host {host:.4f} ms per call): "
                      f"{phase} {ms[k] - before:.4f} ms, {(ms[k] - before) / total:.4f}",
                      flush=True)
                before = ms[k]
    return bad


def compile_dir(build, d: str) -> ctypes.CDLL:
    """nvcc every source in directory ``d`` into one library and load it."""
    jobs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c", os.path.join(d, f"{n}.cu"),
                              "-o", os.path.join(d, f"{n}.o")], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for n in SOURCES]
    for j in jobs:
        log = j.communicate()[0]
        if j.returncode != 0:
            raise RuntimeError(f"nvcc failed in {d}:\n{log}")
    so = os.path.join(d, "kernels.so")
    subprocess.run([build._nvcc(), "-shared", "-o", so]
                   + [os.path.join(d, f"{n}.o") for n in SOURCES], check=True)
    lib = ctypes.CDLL(so)
    build._declare(lib)
    return lib


def host_ms(fn, calls=50) -> float:
    """Milliseconds the host takes to queue one fn() call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_megakernel_tiles: no CUDA device", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.testing import bound_excess, synthesize_rfmip

    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev = torch.device("cuda", 0)
    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)

    if "--k7" in sys.argv[1:]:
        build.library()
        with tempfile.TemporaryDirectory() as tmp:
            bad = k7_sweep(build, tmp, dev, lw_model, table, lw_spec, quick)
        if bad:
            print(f"tune_megakernel_tiles: {bad} result(s) beyond the bound", file=sys.stderr)
        return 1 if bad else 0

    names = {"k1": "K1", "k1_cld_lut": "K1 cld_lut", "k2": "K2", "k2_cld_lut": "K2 cld_lut"}

    def cases(ncol, nlay):
        """{name: (wrapper, twin, args, keywords, tolerance)} at one size: the
        fused kernels' tolerance in W/m2, K3 / K5 / K6's as (rtol, atol) per
        output held (K5: tau)."""
        every = mode_cases(dev, ncol, nlay, lw_model, sw_model, table, lw_spec, sw_spec, solar)
        out = {label: every[k] for k, label in names.items()}
        data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, SEED, top_at_1=True))
        col_dry, x_lw, x_sw = mlp_inputs(dev, data, lw_model, sw_model)
        args6 = k6_args(dev, data, lw_model, table, lw_spec)
        src = K6_SRC_REL * max(float(r.abs().max()) for r in k6.lw_prep_plain(*args6)[1:])
        out["K3"] = (mlp.fused_predict_lw_both, mlp.fused_predict_lw_both_plain,
                     (lw_model, x_lw, col_dry), {}, [(MLP_RTOL, 1e-8), (MLP_RTOL, 1e-9)])
        out["K5"] = (mlp.fused_predict_sw, mlp.fused_predict_sw_plain,
                     (sw_model, sw_model, x_sw, col_dry), {}, [(MLP_RTOL, 1e-8)])
        out["K6"] = (k6.lw_prep, k6.lw_prep_plain, args6, {},
                     [(MLP_RTOL, K6_TRANS_ATOL)] + [(0.0, src)] * 3)
        return out

    def error(got, twin, tol):
        """(error, within the bound): W/m2 for the fused kernels, the largest
        ratio to the bound for the others."""
        if isinstance(tol, list):
            err = max(bound_excess(a, b, *t) for a, b, t in zip(got, twin, tol))
            return err, err <= 1.0
        err = max(maxabs(a, b) for a, b in zip(got, twin))
        return err, err <= tol

    full = cases(NCOL, NLAY)
    ragged = {f"{k} 37x{n}": v for n in (13, 61) for k, v in cases(37, n).items()} if quick else {}
    twins = {k: plain(*args, **kw) for k, (_, plain, args, kw, _) in {**full, **ragged}.items()}
    order = ({},) if quick else VARIANTS
    bad = 0
    entries = {"K1": "lw_clearsky_mega4", "K2": "sw_clearsky_megakernel", "K3": "mlp_predict",
               "K5": "mlp_predict", "K6": "lw_prep"}
    row_choices, thread_choices = mlp.ROW_CHOICES, mlp.THREAD_CHOICES
    built = {}
    with tempfile.TemporaryDirectory() as tmp:
        for pass_no, variants in enumerate((order,) if quick else (order, order[::-1])):
            for changed in variants:
                values = {**SHIPPED, **changed}
                groups, threads, rows = (values.pop(k) for k in PLAN_KEYS)
                tag = "_".join(str(v) for v in values.values())
                if tag not in built:  # a variant of the plans alone takes the same build
                    built[tag] = build_variant(build, tmp, tag, values)
                lib, log = built[tag]
                build._lib = lib  # the wrappers launch from this library from here on
                k1.ROWS_PER_PASS, k1.ROW_PAD = values["kMegaRows"], values["kRowPad"]
                mlp.ROW_PAD = values["kRowPad"]
                k1.GROUP_CHOICES = tuple(g for g in (4, 2, 1) if g <= groups)
                mlp.ROW_CHOICES = (rows,) if rows else row_choices
                mlp.THREAD_CHOICES = (threads,) if threads else thread_choices
                mlp.mlp_launch_plan.cache_clear()
                regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
                spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
                plans = {"K1": k1.launch_plan(NLAY, 9, 128, 128, lw_spec.ngpt),
                         "K2": k2.launch_plan(NLAY, 7, 48, 48, sw_spec.ngpt),
                         "K3": mlp.mlp_launch_plan(tuple(lw_model.dims)),
                         "K5": mlp.mlp_launch_plan(tuple(sw_model.dims), tuple(sw_model.dims)),
                         "K6": k6.lw_prep_plan(NLAY, 18, 128, 128, lw_spec.ngpt)}
                print(f"variant {changed or 'shipped'} (pass {pass_no}): registers {regs} spill "
                      f"{spill}; "
                      + "; ".join(f"{n} {p.threads} threads, {p.smem_bytes} B"
                                  + (f", {p.rows} rows" if n in ("K3", "K5") else "")
                                  + f", {build.blocks_per_sm(entries[n], p, 0, dev.index)} "
                                  "block(s)/SM by the runtime's occupancy call"
                                  for n, p in plans.items()), flush=True)
                for name, (fn, _, args, kw, tol) in {**full, **ragged}.items():
                    got = fn(*args, **kw)
                    torch.cuda.synchronize()
                    err, ok = error(got, twins[name], tol)
                    ok = ok and all(bool(torch.isfinite(o).all()) for o in got)
                    bad += not ok
                    line = f"  {name}: max|kernel-twin| {err:.3e} ({'ok' if ok else 'BEYOND'} {tol})"
                    if name in full:
                        line += f", {cuda_ms(lambda: fn(*args, **kw)):.4f} ms"
                    print(line, flush=True)
                if quick:
                    for line in log.splitlines():
                        if "registers" in line or "spill" in line or "Compiling entry" in line:
                            print(f"  ptxas: {line.strip()}")
        if quick:
            # where the time goes: the kernels cut short after each phase, no
            # result to check; the whole kernel (still loaded) comes last
            # at four times the columns, so that the shortest copy still
            # takes the card longer than a call takes the host
            whole, wide = build._lib, cases(4 * NCOL, NLAY)
            for name, f in (("K1", "lw_megakernel.cu"), ("K2", "sw_megakernel.cu"),
                            ("K3", "mlp.cu"), ("K6", "lw_prep.cu")):
                fn, _, args, kw, _ = wide[name]
                run = lambda: fn(*args, **kw)
                rows = []
                for phase, _ in STOPS[f]:
                    build._lib, _ = build_variant(build, tmp, f"{name}_stop{len(rows)}",
                                                  SHIPPED_CONSTANTS, {f: phase})
                    rows.append((phase, cuda_ms(run), host_ms(run)))
                build._lib = whole
                rows.append((LAST_PHASES.get(f, LAST_PHASE), cuda_ms(run), host_ms(run)))
                total, before = rows[-1][1], 0.0
                print(f"  {name} by phase at {4 * NCOL}x{NLAY}, of {total:.4f} ms:")
                for phase, ms, host in rows:
                    print(f"    through {phase}: {ms:.4f} ms (host {host:.4f} ms per call): "
                          f"{phase} {ms - before:.4f} ms, {(ms - before) / total:.4f}", flush=True)
                    before = ms
        build._lib = None  # the package's own build for K7
        build.library()
        bad += k7_sweep(build, tmp, dev, lw_model, table, lw_spec, quick)
    if bad:
        print(f"tune_megakernel_tiles: {bad} result(s) beyond the bound", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
