"""Device operations by the port's span that launched them: each kernel,
copy or memset of a profiled window (``trace.TraceWindow``) is matched to
the runtime or driver call that enqueued it through the trace's correlation
id, and that call to the ``rte.*`` spans (``utils/timing.span``) whose
range holds it on its thread. A window without such spans, or a trace
without correlation ids, matches nothing.
"""
from __future__ import annotations

import bisect

from radbench.trace import merge

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _correlation(e):
    args = e.get("args") or {}
    return args.get("correlation")


def launched_under(t, prefix: str) -> list:
    """The window's device events whose launch lies in a span named
    ``prefix``..., by thread."""
    ranges = {}
    for e in t.host:
        if e.get("cat") == "user_annotation" and e["name"].startswith(prefix):
            ts = float(e["ts"])
            ranges.setdefault(e.get("tid"), []).append((ts, ts + float(e["dur"])))
    if not ranges:
        return []
    merged = {tid: merge(r) for tid, r in ranges.items()}
    starts = {tid: [s for s, _ in m] for tid, m in merged.items()}
    ids = set()
    for e in t.host:
        if e.get("cat") not in LAUNCH_CATS or e.get("tid") not in merged:
            continue
        corr = _correlation(e)
        if corr is None:
            continue
        ts, tid = float(e["ts"]), e.get("tid")
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and ts < merged[tid][i][1]:
            ids.add(corr)
    return [e for e in t.device if _correlation(e) in ids]


def ms_per_call(t, prefix: str):
    """Device milliseconds a call of the operations launched under spans
    named ``prefix``...; None where there are none."""
    ops = launched_under(t, prefix)
    if not ops:
        return None
    return sum(float(e["dur"]) for e in ops) * 1e-3 / t.calls
