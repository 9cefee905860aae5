#!/usr/bin/env python3
"""What the port's spans (``rte_rrtmgp_nn_tpu_torch/utils/timing.span``)
cost, where the host time of a benchmark cell goes by span, and where the
host waits for the card.

    python3 scripts/probe_spans.py [--cells a,b] [--seed N] [--calls N]

For each cell of BENCHMARK.json (set up as ``radbench/run.py`` sets it up,
on CUDA card 0):
  - the host-clock time of a call, median over three blocks of ``--calls``
    calls in turns: with no profiler; with no profiler and no spans (each
    module's ``span`` a ``with`` of nothing); with a CPU + CUDA
    ``torch.profiler`` recording; and with it recording and the spans off;
  - from the profiled calls: each span's count and self time a call, the
    count a call of every ``rte.*`` range (those ``radbench/spans.py`` does
    not list too, such as ``rte.stage.pool``), and the card's idle time by
    the innermost span over each gap's middle;
  - the calls that make the host wait for the card in one call
    (``torch.cuda.set_sync_debug_mode``), by the port's frames they come
    from.
Then the cost of entering and leaving one span with no profiler recording
and with one recording, against a ``with`` of nothing. Prints one JSON
object as its last line.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import os
import statistics
import sys
import time
import timeit
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from radbench import harness, spans as S, trace as T  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.utils import timing  # noqa: E402


def _calls(cell, n: int, k0: int, device) -> list:
    """Host-clock seconds of n calls, each ending when the card is done."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        with record_function("radbench.call"):
            cell.call((k0 + i) % cell.n_states)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append(time.perf_counter() - t0)
    return out


# the port's modules that open spans
SPAN_USERS = ("drivers.fused", "drivers.gcm", "drivers.rfmip", "gasoptics.lut_gas_optics",
              "gasoptics.nn_gas_optics", "gasoptics.planck", "ops.cuda.lut_gas_optics",
              "ops.cuda.mlp", "ops.gas_optics_lut", "parallel.streaming", "rte")


@contextlib.contextmanager
def _no_spans():
    """Each module's ``span`` replaced by a ``with`` of nothing."""
    mods = [importlib.import_module(f"rte_rrtmgp_nn_tpu_torch.{m}") for m in SPAN_USERS]
    saved = [m.span for m in mods]
    for m in mods:
        m.span = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.span = s


@contextlib.contextmanager
def _spans_off():
    saved = timing.record_function
    timing.record_function = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        timing.record_function = saved


def _by_span(tw) -> dict:
    """Count and self ms a call of each span; idle ms a call by the
    innermost span over each idle gap's middle (where there is none, by the
    innermost host range or op there)."""
    agg = collections.defaultdict(lambda: [0, 0.0])
    for name, us in S.self_us(tw):
        agg[name][0] += 1
        agg[name][1] += us
    spans = S.spans(tw)
    busy = tw.busy_intervals()
    edges = [tw.start] + [x for iv in busy for x in iv] + [tw.end]
    idle = collections.defaultdict(float)
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        cover = [sp for sp in spans if sp[0] <= mid < sp[1]]
        if cover:
            name = min(cover, key=lambda sp: sp[1] - sp[0])[2]
        else:  # the innermost host range or op there
            ops = [(float(h["dur"]), h["name"]) for h in tw.host
                   if float(h["ts"]) <= mid < float(h["ts"]) + float(h.get("dur", 0.0))]
            name = "(no span) " + (min(ops)[1] if ops else "-")
        idle[name] += (e - s) * 1e-3
    ranges = collections.Counter(e["name"] for e in tw.host if e.get("cat") == "user_annotation"
                                 and e["name"].startswith("rte."))
    return {"self_ms": {n: [c / tw.calls, us * 1e-3 / tw.calls] for n, (c, us) in
                        sorted(agg.items(), key=lambda kv: -kv[1][1])},
            "count": {n: c / tw.calls for n, c in sorted(ranges.items())},
            "idle_ms": {n: v / tw.calls for n, v in sorted(idle.items(), key=lambda kv: -kv[1])},
            "window_ms": tw.window_s * 1e3 / tw.calls, "busy_ms": tw.busy_s * 1e3 / tw.calls}


def _syncs(cell, device) -> dict:
    """The port's frames (file:line function, innermost three) of each
    synchronising call in one call, counted."""
    found = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "rte_rrtmgp_nn_tpu_torch" in f.filename and "timing" not in f.filename]
        found[" < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                         for f in reversed(frames[-3:])) or str(message)[:80]] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.call(0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    return dict(found)


def _span_cost() -> dict:
    """Microseconds to enter and leave a span, and a ``with`` of nothing."""
    n = 200_000
    null = contextlib.nullcontext()

    def bare():
        with null:
            pass

    def one():
        with timing.span("rte.probe"):
            pass

    out = {"nullcontext_us": min(timeit.repeat(bare, number=n, repeat=5)) / n * 1e6,
           "span_off_us": min(timeit.repeat(one, number=n, repeat=5)) / n * 1e6}
    with profile(activities=[ProfilerActivity.CPU]):
        m = 20_000
        out["span_on_us"] = min(timeit.repeat(one, number=m, repeat=3)) / m * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="gcm-allsky-025deg.step,rfmip-clearsky.c1800")
    ap.add_argument("--seed", type=int, default=2147480001)
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--device", default="cuda:0", help="cpu: a rehearsal of the script")
    args = ap.parse_args()
    torch.set_num_threads(1)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    result = {"card": torch.cuda.get_device_name(device) if cuda else "cpu",
              "torch": torch.__version__, "cells": {}}
    for name in args.cells.split(","):
        _, config, workload, _ = harness.find_cell(name)
        with torch.no_grad():
            cell = harness.entry_module(config).setup(config, workload, args.seed, device,
                                                      harness.ROOT)
            _calls(cell, cell.n_states, 0, device)  # every shape and kernel built
            times = {"off": [], "off_no_spans": [], "on": [], "on_spans_off": []}
            windows = []
            for _ in range(3):
                times["off"] += _calls(cell, args.calls, 0, device)
                with _no_spans():
                    times["off_no_spans"] += _calls(cell, args.calls, 0, device)
                with profile(activities=acts) as prof:
                    times["on"] += _calls(cell, args.calls + 1, 0, device)[1:]
                windows.append(T.TraceWindow(T.read_chrome_trace(prof), {}, skip=1))
                with _spans_off(), profile(activities=acts):
                    times["on_spans_off"] += _calls(cell, args.calls + 1, 0, device)[1:]
            syncs = _syncs(cell, device) if cuda else {}
        r = {f"call_ms_{k}": statistics.median(v) * 1e3 for k, v in times.items()}
        r["by_span"] = _by_span(windows[-1])
        r["metrics"] = {m: harness.metric_reader(m)(windows[-1]) for m in (
            "host_prep_ms_per_call", "host_enqueue_ms_per_call", "host_stage_ms_per_call",
            "host_wait_ms_per_call", "rebuilds_per_call", "idle_unattributed_share",
            "device_idle_share", "launches_per_call")}
        r["syncs"] = syncs
        result["cells"][name] = r
        print(name, json.dumps(r, indent=1), file=sys.stderr)
        cell.free_program()
        if cuda:
            torch.cuda.empty_cache()
    result["span_cost"] = _span_cost()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
