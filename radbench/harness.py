"""One run of one cell: set-up, the measured (or profiled) window of calls,
then the output check against the plain reference.

Everything that belongs to a cell is data found by name:
  - ``BENCHMARK.json`` names the cell's configuration and traffic;
  - ``configs/<config>.json``: the configuration (nets, layers, the entry
    module ``entries/<entry>.py`` that makes and calls it);
  - ``workloads/<cell>.json``: the traffic (columns a call, blocks, input
    states) and the limits of the output check;
  - ``metrics/<name>.py``: the reader of a per-layer metric, ``read(trace)``
    returning a number, or None where the trace holds nothing to read.

A window is a closed loop of one caller: call i runs on input state i mod
``states``, each call from the host arrays handed in to the results on the
host. The window opens with the first call and closes after the first call
that ends ``seconds`` later.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from radbench import trace as T
from radbench.reference import physics as P

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that must not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "rte_rrtmgp_nn_tpu")
TRACE_SECONDS = 4.0   # the profiled window's length at most
TRACE_CALLS = (3, 32)  # the profiled calls, at least and at most


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: str = ROOT) -> tuple:
    """(the cell's BENCHMARK.json entry, its configuration file, its
    workload file, the manifest)."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    cell = cells[name]
    bench = os.path.join(root, "radbench")
    config = load_json(os.path.join(bench, "configs", f"{cell['config']}.json"))
    workload = load_json(os.path.join(bench, "workloads", f"{name}.json"))
    return cell, config, workload, manifest


def entry_module(config: dict):
    return importlib.import_module(f"radbench.entries.{config['entry']}")


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"radbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _one(cell, k: int, log: list):
    """cell.call(k) inside the call range; None if it raised (the first
    traceback is kept in ``log``)."""
    from torch.profiler import record_function

    try:
        with record_function("radbench.call"):
            return cell.call(k)
    except Exception:  # a failed call is counted, and the run goes on
        if not log:
            log.append(traceback.format_exc())
        return None


def window(cell, seconds: float, device) -> dict:
    """Calls back to back until ``seconds`` have passed since the first
    began: their states, outputs (None: failed) and host-clock spans."""
    calls, log = [], []
    w0 = None
    i = 0
    while True:
        k = i % cell.n_states
        t0 = time.perf_counter()
        w0 = t0 if w0 is None else w0
        out = _one(cell, k, log)
        _sync(device)
        t1 = time.perf_counter()
        calls.append((k, out, t0, t1))
        i += 1
        if t1 - w0 >= seconds:
            return {"calls": calls, "log": log}


def traced_window(cell, seconds: float, device, call_s: float) -> tuple:
    """A profiled window of whole calls, after one profiled call that the
    window leaves out: (window dict as ``window``, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile

    n = int(min(max(math.ceil(min(seconds, TRACE_SECONDS) / max(call_s, 1e-6)), TRACE_CALLS[0]),
                TRACE_CALLS[1]))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(device).type == "cuda" else [])
    calls, log = [], []
    with profile(activities=acts) as prof:
        for i in range(n + 1):
            k = i % cell.n_states
            t0 = time.perf_counter()
            out = _one(cell, k, log)
            _sync(device)
            t1 = time.perf_counter()
            if i:
                calls.append((k, out, t0, t1))
    return {"calls": calls, "log": log}, T.read_chrome_trace(prof)


def p95_ms(calls: list) -> float:
    """The 95th percentile of the host-clock time of every call in the
    window, ms."""
    return float(np.percentile([(t1 - t0) * 1e3 for _, _, t0, t1 in calls], 95))


def check(cell, calls: list, limits: dict, device, prec=P.REFERENCE) -> dict:
    """The numbers the check compares, each the largest |program -
    reference| over every compared call, beside its limit."""
    got = {name: 0.0 for name in cell.CHECKS}
    refs = {}
    for k, out, _, _ in calls:
        if out is None:
            continue
        if k not in refs:
            refs[k] = cell.reference(k, prec, device)
        for name, keys in cell.CHECKS.items():
            for key in keys:
                d = np.abs(np.asarray(out[key], np.float64) - refs[k][key])
                worst = float(np.max(d)) if d.size else 0.0
                got[name] = max(got[name], math.inf if math.isnan(worst) else worst)
    return {name: {"value": got[name], "limit": limits[name]} for name in cell.CHECKS}


def device_kind(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: str = ROOT, overrides: dict | None = None, log=sys.stderr) -> dict:
    """One run of the cell ``name``: returns the result line's object (the
    last key, ``check``, the compared numbers beside their limits), with
    ``t_start`` the host clock at the process's start."""
    _, config, workload, manifest = find_cell(name, root)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    workload = {**workload, **overrides.get("workload", {})}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        cell = entry_module(config).setup(config, workload, seed, device, root)
        # warm-up: every input state once, so every shape and kernel is
        # built before the window
        times, warm_log = [], []
        for k in range(cell.n_states):
            t0 = time.perf_counter()
            _one(cell, k, warm_log)
            _sync(device)
            times.append(time.perf_counter() - t0)
        call_s = min(times)
        if warm_log:
            print(warm_log[0], file=log)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        if trace:
            run, events = traced_window(cell, seconds, device, call_s)
        else:
            run = window(cell, seconds, device)
    calls = run["calls"]
    if run["log"]:
        print(run["log"][0], file=log)
    dev = device_kind(device)
    if dev["platform"] == "gpu":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that the run may not load: {bad}")

    failed = sum(out is None for _, out, _, _ in calls)
    metrics = {}
    result = {"correct": False, "attempted": len(calls), "failed": failed}
    if trace:
        work = {}
        for k, *_ in calls:
            for part, (f, b) in cell.work(k).items():
                f0, b0 = work.get(part, (0.0, 0.0))
                work[part] = (f0 + f, b0 + b)
        tw = T.TraceWindow(events, work, skip=1)
        for m in manifest["per_layer"]:
            v = metric_reader(m["name"])(tw)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tw.busy_s, window_s=tw.window_s)
        result["breakdown"] = tw.breakdown()
    else:
        span = calls[-1][3] - calls[0][2]
        done = len(calls) - failed
        values = {"columns_per_s": done * cell.columns_per_call / span,
                  "call_ms_p95": p95_ms(calls),
                  "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=dev)
    # the program's state goes before the reference runs
    cell.free_program()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        numbers = check(cell, calls, workload["limits"], device)
    result["correct"] = bool(failed == 0 and calls and all(
        v["value"] <= v["limit"] for v in numbers.values()))
    result["check"] = numbers
    return result


def summary_lines(result: dict) -> list:
    """The compared numbers beside their limits, one a line."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}" for k, v in result["check"].items()]
