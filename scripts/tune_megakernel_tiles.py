#!/usr/bin/env python3
"""Time the two fused kernels (csrc/lw_megakernel.cu, csrc/sw_megakernel.cu)
at several tile shapes and block geometries on one NVIDIA GPU.

    python3 scripts/tune_megakernel_tiles.py [--quick]

A variant sets some of: layers per MLP pass, row padding, the register tile
(rows x columns) of the hidden layers and of the last layer, layer groups per
block. For each, edited copies of csrc/common.cuh and the two sources are
built into a temporary directory and loaded in place of the package's
library, and the wrappers' launch plan is told the same constants; K1 and K2
are checked against the plain twins' results and timed (chip_smoke.cuda_ms
around the wrappers' calls), clear-sky and in the lookup-table cloud mode, at
chip_smoke.py's size (1800 x 60, the g-128 and g-112 demo nets). The variants
run in one order and then in the reverse order, so that a drift of the card
shows. Prints the card and, per build, the registers and spill ptxas reports,
the blocks per SM the CUDA runtime's occupancy call gives, each kernel's
error against its twin and its time.
``--quick`` builds the shipped configuration only, checks it at a ragged size
too and prints where the kernels' time goes: copies of the two sources that
return after a phase (STOPS) are built and timed like the kernel itself, at
four times the columns, and a phase's time is the difference of two such
times. Beside each time stands the host's time to queue one call: a reading
near it is the host's, not the card's.
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
    LW_MODEL, NCOL, NLAY, SW_MODEL, cuda_ms, gpu_line, maxabs, mode_cases)

# the constants of csrc/common.cuh a variant may set, with the shipped values,
# and the most layer groups a plan may take
SHIPPED = {"kMegaRows": 16, "kRowPad": 4, "kTileR": 8, "kTileC": 2, "kOutR": 8, "kOutC": 4,
           "groups": 4}
SHIPPED_CONSTANTS = {k: v for k, v in SHIPPED.items() if k != "groups"}
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
}
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
    return text.replace(anchor, "  return;\n" + anchor)


def build_variant(build, tmp: str, tag: str, values, stops=None) -> tuple[ctypes.CDLL, str]:
    """nvcc the sources, with the constants of ``values`` set and each kernel
    returning after the phase ``stops`` names for its file, into ``tmp``/
    ``tag``; returns (library, ptxas output)."""
    d = os.path.join(tmp, tag)
    os.makedirs(d, exist_ok=True)
    for name in ("common.cuh", "lw_megakernel.cu", "sw_megakernel.cu", "errors.cu"):
        text = (build.CSRC_DIR / name).read_text()
        if name == "common.cuh":
            text = edited(text, values)
        elif stops and name in stops:
            text = stopped(text, name, stops[name])
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    jobs = []
    for name in ("lw_megakernel", "sw_megakernel", "errors"):
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
                   + [os.path.join(d, f"{n}.o") for n in ("lw_megakernel", "sw_megakernel", "errors")],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I = build.P, build.I
    for fn in (lib.lw_clearsky_mega4_launch, lib.sw_clearsky_megakernel_launch):
        fn.argtypes = [P] * 6 + [I, I, P]
        fn.restype = I
    for fn in (lib.lw_clearsky_mega4_blocks_per_sm, lib.sw_clearsky_megakernel_blocks_per_sm):
        fn.argtypes = [P, I, I, P]
        fn.restype = I
    lib.rte_cuda_error_string.argtypes = [I]
    lib.rte_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


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
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g128, sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line())
    dev = torch.device("cuda", 0)
    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    lw_model = load_model_netcdf(LW_MODEL, device=dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)

    names = {"k1": "K1", "k1_cld_lut": "K1 cld_lut", "k2": "K2", "k2_cld_lut": "K2 cld_lut"}

    def cases(ncol, nlay):
        """{name: (wrapper, twin, args, keywords, tolerance)} at one size."""
        every = mode_cases(dev, ncol, nlay, lw_model, sw_model, table, lw_spec, sw_spec, solar)
        return {label: every[k] for k, label in names.items()}

    full = cases(NCOL, NLAY)
    ragged = {f"{k} 37x{n}": v for n in (13, 61) for k, v in cases(37, n).items()} if quick else {}
    twins = {k: plain(*args, **kw) for k, (_, plain, args, kw, _) in {**full, **ragged}.items()}
    order = ({},) if quick else VARIANTS
    bad = 0
    entries = {"K1": "lw_clearsky_mega4", "K2": "sw_clearsky_megakernel"}
    with tempfile.TemporaryDirectory() as tmp:
        for pass_no, variants in enumerate((order,) if quick else (order, order[::-1])):
            for changed in variants:
                values = {**SHIPPED, **changed}
                groups = values.pop("groups")
                tag = "_".join(str(v) for v in values.values())
                lib, log = build_variant(build, tmp, tag, values)
                build._lib = lib  # the wrappers launch from this library from here on
                k1.ROWS_PER_PASS, k1.ROW_PAD = values["kMegaRows"], values["kRowPad"]
                k1.GROUP_CHOICES = tuple(g for g in (4, 2, 1) if g <= groups)
                regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
                spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
                plans = {"K1": k1.launch_plan(NLAY, 9, 128, 128, lw_spec.ngpt),
                         "K2": k2.launch_plan(NLAY, 7, 48, 48, sw_spec.ngpt)}
                print(f"variant {changed or 'shipped'} (pass {pass_no}): registers {regs} spill "
                      f"{spill}; "
                      + "; ".join(f"{n} {p.threads} threads, {p.smem_bytes} B, "
                                  f"{build.blocks_per_sm(entries[n], p, 0, dev.index)} block(s)/SM "
                                  "clear-sky by the runtime's occupancy call"
                                  for n, p in plans.items()), flush=True)
                for name, (fn, _, args, kw, tol) in {**full, **ragged}.items():
                    got = fn(*args, **kw)
                    torch.cuda.synchronize()
                    err = max(maxabs(a, b) for a, b in zip(got, twins[name]))
                    ok = err <= tol and all(bool(torch.isfinite(o).all()) for o in got)
                    bad += not ok
                    line = f"  {name}: max|kernel-twin| {err:.3e} W/m2 ({'ok' if ok else 'BEYOND'} {tol})"
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
            for name, f in (("K1", "lw_megakernel.cu"), ("K2", "sw_megakernel.cu")):
                fn, _, args, kw, _ = wide[name]
                run = lambda: fn(*args, **kw)
                rows = []
                for phase, _ in STOPS[f]:
                    build._lib, _ = build_variant(build, tmp, f"{name}_stop{len(rows)}",
                                                  SHIPPED_CONSTANTS, {f: phase})
                    rows.append((phase, cuda_ms(run), host_ms(run)))
                build._lib = whole
                rows.append((LAST_PHASE, cuda_ms(run), host_ms(run)))
                total, before = rows[-1][1], 0.0
                print(f"  {name} by phase at {4 * NCOL}x{NLAY}, of {total:.4f} ms:")
                for phase, ms, host in rows:
                    print(f"    through {phase}: {ms:.4f} ms (host {host:.4f} ms per call): "
                          f"{phase} {ms - before:.4f} ms, {(ms - before) / total:.4f}", flush=True)
                    before = ms
    if bad:
        print(f"tune_megakernel_tiles: {bad} result(s) beyond the bound", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
