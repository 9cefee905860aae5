"""The profiled window of a ``--trace 1`` run: a ``torch.profiler`` trace of
whole calls, read into device intervals and host ranges, and what the
per-layer metric readers (``radbench/metrics/<name>.py``) take from it.

Time runs in microseconds on the trace's own clock, which kineto shares
between host ranges and device events. The window is from the start of the
first profiled call's ``radbench.call`` range to the end of the last one's.
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def read_chrome_trace(prof) -> list:
    """The profiler's events as dicts (name, cat, ts, dur), through its
    chrome-trace export in a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def short_name(name: str) -> str:
    """A device operation's name without its return type and argument list
    (a copy or memset keeps its whole name)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.removeprefix("void ").strip()[:160]


def merge(intervals) -> list:
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceWindow:
    """What the readers see: ``calls`` profiled calls (the first ``skip``
    calls' ranges left out), the device events of the window, the host
    ranges, and ``work`` (operations, bytes) of the window's calls by part
    ("lw", "sw")."""

    def __init__(self, events: list, work: dict, skip: int = 0):
        calls = sorted((e for e in events if e.get("name") == "radbench.call"
                        and e.get("cat") == "user_annotation"), key=lambda e: float(e["ts"]))
        calls = calls[skip:]
        if not calls:
            raise RuntimeError("the trace holds no radbench.call range")
        self.start = min(float(e["ts"]) for e in calls)
        self.end = max(float(e["ts"]) + float(e["dur"]) for e in calls)
        self.calls = len(calls)
        inside = lambda e: self.start <= float(e["ts"]) < self.end
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and inside(e)]
        self.work = work

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list:
        return merge((max(float(e["ts"]), self.start),
                      min(float(e["ts"]) + float(e["dur"]), self.end)) for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def seconds_of(self, names, cats=("kernel",)) -> float:
        """Device seconds of the events of ``cats`` whose name holds one of
        ``names``."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") in cats and any(n in e["name"] for n in names)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps by
        the host operation (the innermost one) running at each gap's middle,
        each summed by name in seconds."""
        ops = {}
        for e in self.device:
            name = short_name(e["name"])
            ops[name] = ops.get(name, 0.0) + float(e["dur"]) * 1e-6
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            cover = [h for h in self.host
                     if float(h["ts"]) <= mid < float(h["ts"]) + float(h["dur"])]
            name = min(cover, key=lambda h: float(h["dur"]))["name"] if cover else "(no host range)"
            gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
        best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(gaps)}
