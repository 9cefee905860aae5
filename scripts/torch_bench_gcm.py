#!/usr/bin/env python3
"""GCM-scale streamed sweep benchmark of the PyTorch/CUDA port: about a
million columns through the host -> device streaming pipeline
(drivers/gcm.py on parallel/streaming.py), on one card.

The counterpart of scripts/bench_gcm.py, with its flags and defaults
(``--ncol 1036800``, ``--block 57600``, ``--lw-only``, ``--resident``,
``--precision f32|mixed``). Columns are synthesized by tiling and
perturbing an RFMIP-size atmosphere (``gcm.synthesize_gcm_columns``);
blocks of ``--block`` columns stream to the card while the previous block
computes. Prints ONE JSON line for the all-sky LW + SW sweep
(``gcm_sweep_allsky``, unless ``--lw-only``) and one for the clear-sky LW
sweep (``gcm_sweep_lw``), each with bench_gcm.py's keys and metric names
(``_resident`` appended under ``--resident``: every block on the card
before the timer, which then times the steps and the fetch alone). Each
sweep warms up on block 0 first; the synthesis and the kernels' build stay
outside every timer.

The port's own keys: ``device`` (name, count, power limit), ``inputs``
and ``seed``, ``build_s``, ``route`` (the sweep's, by the drivers'
dispatch: on CUDA K1 and K2 in their lookup-table cloud mode once a block,
K1 clear once a block for the LW sweep), ``blocks``,
``bytes_per_column`` (host -> device), and the output check: the same
sweep on the first min(ncol, 1800) columns on the card and in float64 on
the CPU, the reduced means held within LW 2e-3 and SW 2e-2 W/m2
(``max_abs_dflux_lw`` / ``_sw``, ``correct``; false exits 1).

Inputs: ``testing.synthesize_rfmip(1800, 60, --seed)`` with the gases a
Garand file carries, and synthetic lookup-table cloud-coefficient files,
with the in-repo demo nets; or the reference's files through ``--rfmip``,
``--lw-cloud-coeffs``, ``--sw-cloud-coeffs``, ``--lw-model`` and
``--sw-models``. The entry runs the g-128 LW and g-112 SW mappings, as
scripts/bench_gcm.py does: other nets are refused with a ValueError before
any column is synthesized (utils/bench.load_nets).

    python3 scripts/torch_bench_gcm.py                     # on the card
    python3 scripts/torch_bench_gcm.py --resident
    python3 scripts/torch_bench_gcm.py --device cpu --ncol 64 --block 32
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rte_rrtmgp_nn_tpu_torch import testing  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.drivers import gcm  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.drivers.allsky_io import GARAND_GASES  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip, rfmip_data_from_arrays  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.utils import bench, cli  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc  # noqa: E402

NCOL, NLAY = 1800, 60  # the synthetic RFMIP-size atmosphere the columns are tiled from


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncol", type=int, default=1_036_800,  # 576 x 1800
                    help="total columns (default ~1.04M)")
    ap.add_argument("--block", type=int, default=57_600,
                    help="streaming block size (columns per device step)")
    ap.add_argument("--lw-only", action="store_true", help="skip the all-sky LW+SW sweep")
    ap.add_argument("--resident", action="store_true",
                    help="stage every block on the card first and time the compute loop alone")
    ap.add_argument("--precision", choices=["f32", "mixed"], default="f32",
                    help="'mixed' uint16-quantizes the tolerant lanes (about half the "
                         "streamed bytes a column)")
    ap.add_argument("--rfmip", help="the reference's " + cli.RFMIP_INPUT_IN_REFERENCE +
                    " (default: synthetic, 1800 x 60)")
    bench.add_input_arguments(ap, clouds=True)
    return ap, ap.parse_args(argv)


def gcm_columns(args):
    """(the sweep's host columns, the base atmosphere, "files" or
    "synthetic")."""
    if args.rfmip:
        base, inputs = read_rfmip(args.rfmip), "files"
    else:
        arrays = testing.synthesize_rfmip(NCOL, NLAY, args.seed)
        arrays["gases"] = {g: v for g, v in arrays["gases"].items() if g in GARAND_GASES}
        base, inputs = rfmip_data_from_arrays(arrays), "synthetic"
    return gcm.synthesize_gcm_columns(base, args.ncol, seed=args.seed), base, inputs


def cloud_files(args, specs: dict, directory: str) -> dict:
    """The LW and SW cloud-coefficient files: the flags', else synthetic
    lookup tables from the seed on the mappings ``specs`` ("lw", "sw")
    written into ``directory``."""
    paths = {"lw": args.lw_cloud_coeffs, "sw": args.sw_cloud_coeffs}
    for band, spec in specs.items():
        if not paths[band]:
            paths[band] = os.path.join(directory, f"cloud-coeffs-{band}-lut.nc")
            write_nc(paths[band], *testing.cloud_optics_nc_variables(
                testing.synthesize_cloud_optics(spec, args.seed, "lut")))
    return paths


# per sweep: its metric, and the means its check holds as LW and as SW
SWEEPS = {"allsky": ("gcm_allsky_lw_sw_columns_per_s_per_chip",
                     ("mean_olr", "mean_lw_sfc_dn"), ("mean_sw_sfc_dn",)),
          "lw": ("gcm_clearsky_lw_columns_per_s_per_chip", ("mean_olr", "mean_sfc_dn"), ())}


def run_sweep(sweep, args, host: dict, nets: tuple, nets64: tuple, dev, **kw) -> tuple:
    """The timed sweep of ``host`` on ``dev`` (warm-up on block 0), then
    the same sweep on its first min(ncol, 1800) columns on ``dev`` and in
    float64 on the CPU (``nets64``): (its stats, the card's check stats,
    the float64 stats)."""
    head = {k: v[:bench.CHECK_NCOL] for k, v in host.items()}
    nchk = head["play"].shape[0]
    with torch.no_grad():
        stats = sweep(host, *nets, block_size=args.block, warmup=True, resident=args.resident,
                      device=dev, **kw)
        card = sweep(head, *nets, block_size=nchk, device=dev, **kw)
    ref = sweep(head, *nets64, block_size=nchk, dtype=torch.float64, device="cpu", **kw)
    return stats, card, ref


def main(argv=None) -> int:
    ap, args = parse(argv)
    dev = cli.resolve_device(ap, args.device)
    lw_models, sw_models, specs = bench.load_nets("torch_bench_gcm.py", args.lw_model,
                                                  args.sw_models, dev)
    build_s = bench.build_seconds(dev)
    host, base, inputs = gcm_columns(args)
    lw64, sw64 = bench.float64_models(args.lw_model, args.sw_models)
    routes = bench.routes("auto", lw_models, sw_models, dev)
    kw = dict(top_at_1=base.top_at_1, precision=args.precision)
    runs = {}
    if not args.lw_only:
        with tempfile.TemporaryDirectory() as tmp:
            paths = cloud_files(args, specs, tmp)
            co = [load_cloud_optics_checked(paths[b], device=dev) for b in ("lw", "sw")]
            co64 = [load_cloud_optics_checked(paths[b], device="cpu", dtype=torch.float64)
                    for b in ("lw", "sw")]
        runs["allsky"] = run_sweep(gcm.gcm_sweep_allsky, args, host, (lw_models, sw_models, *co),
                                   (lw64, sw64, *co64), dev, **kw)
    runs["lw"] = run_sweep(gcm.gcm_sweep_lw, args, host, (lw_models,), (lw64,), dev, **kw)

    ok = True
    for kind, (stats, card, ref) in runs.items():
        metric, lw_means, sw_means = SWEEPS[kind]
        check = bench.hold_fluxes(*({"lw": {k: s[k] for k in lw_means},
                                     **({"sw": {k: s[k] for k in sw_means}} if sw_means else {})}
                                    for s in (card, ref)))
        ok = ok and check["correct"]
        print(json.dumps({
            "metric": bench.metric(metric + ("_resident" if args.resident else ""), dev),
            "value": stats["columns_per_s"], "unit": "columns/s", "ncol": stats["ncol"],
            "block": args.block, "elapsed_s": stats["elapsed_s"],
            **{k: stats[k] for k in lw_means + sw_means},
            "precision": args.precision, "backend": dev.type,
            "route": "+".join(routes) if kind == "allsky" else routes[0],
            "timing": "host clock around the sweep after a warm-up on block 0 (streamed: "
                      "staging, copies, steps, fetch and the one synchronize; resident: the "
                      "steps and the fetch)",
            "device": bench.device_info(dev), "inputs": inputs,
            "seed": None if args.rfmip else args.seed,
            "models": [os.path.basename(p) for p in (args.lw_model, *args.sw_models)],
            "build_s": build_s, "blocks": -(-args.ncol // args.block),
            "bytes_per_column": stats["bytes_per_column"],
            "check_ncol": card["ncol"], **check}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
