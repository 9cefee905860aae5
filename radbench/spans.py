"""The port's named spans in a profiled window: the ``rte.*`` ranges of
``rte_rrtmgp_nn_tpu_torch/utils/timing.span`` around the host stages of its
drivers and staging ring, as the host-stage readers
(``radbench/metrics/host_*``, ``rebuilds_per_call``,
``idle_unattributed_share``) take them from a ``TraceWindow``.

Each span belongs to one category of host work: ``prep`` (Python and numpy
on the host), ``enqueue`` (queueing work for the card), ``stage`` (copies
between host and card) or ``wait`` (the host blocked on the card). A span's
self time is its length less the union of the spans nested in it, on its
thread, and less the host's synchronizing runtime calls (``SYNCS``) that
run directly under it: those are ``wait`` wherever they fall, since a
blocking copy from pageable memory, an ``.item()`` or an event's
synchronize makes the host wait for all the work queued before it. The
categories' self times therefore split the time under the window's
outermost spans between them. A span of a name missing here counts in its
parent's self time. ``REBUILDS`` are the spans of work made again every
call that could be made once.
"""
from __future__ import annotations

import bisect

from radbench.trace import merge

CATEGORY = {
    "rte.rfmip.lw": "prep", "rte.rfmip.sw": "prep", "rte.check": "prep", "rte.canon": "prep",
    "rte.solar": "prep", "rte.gcm.sweep": "prep", "rte.pack": "prep", "rte.stream": "prep",
    "rte.gather": "prep",
    # the table's quadrature runs in numpy on the host (planck_band_radiance)
    "rte.planck": "prep",
    "rte.prep": "enqueue", "rte.kernel.lw": "enqueue",
    "rte.kernel.sw": "enqueue", "rte.first_layer.miss": "enqueue",
    "rte.kernel_net.miss": "enqueue", "rte.replicate": "enqueue", "rte.step": "enqueue",
    "rte.h2d": "stage", "rte.ring": "stage", "rte.stage": "stage", "rte.d2h": "stage",
    "rte.wait": "wait",
}
REBUILDS = frozenset({"rte.planck", "rte.solar", "rte.first_layer.miss", "rte.kernel_net.miss",
                      "rte.replicate", "rte.ring"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"})


def category(name: str) -> str:
    """The category of a span, or of a synchronizing runtime call."""
    return "wait" if name in SYNCS else CATEGORY[name]


def spans(t) -> list:
    """The window's spans as [start, end, name, thread], microseconds,
    sorted by start (the longer first where two start together)."""
    out = [[float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid")]
           for e in t.host if e.get("cat") == "user_annotation" and e["name"] in CATEGORY]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def self_us(t) -> list:
    """(name, self time in microseconds) of each span of the window, and of
    each synchronizing runtime call directly under a span of another
    category than ``wait``. A child reaching past its parent's end is cut at
    it, so the self times sum to the length of the outermost spans."""
    syncs = [[float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid")]
             for e in t.host if e.get("cat") == "cuda_runtime" and e["name"] in SYNCS]
    out, stacks = [], {}
    for s in sorted(spans(t) + syncs, key=lambda s: (s[0], -s[1])):
        stack = stacks.setdefault(s[3], [])
        while stack and s[0] >= stack[-1][1][1]:
            stack.pop()
        sync = s[2] in SYNCS
        if sync and (not stack or category(stack[-1][1][2]) == "wait"):
            continue
        if stack:
            parent = stack[-1]
            s[1] = min(s[1], parent[1][1])
            out[parent[0]][1] -= s[1] - s[0]
        out.append([s[2], s[1] - s[0]])
        if not sync:
            stack.append((len(out) - 1, s))
    return out


def ms_per_call(t, cat: str):
    """Self time of category ``cat``, milliseconds a call; None where the
    window holds no span."""
    times = self_us(t)
    if not times:
        return None
    return sum(us for name, us in times if category(name) == cat) * 1e-3 / t.calls


def rebuilds_per_call(t):
    names = [s[2] for s in spans(t)]
    if not names:
        return None
    return sum(n in REBUILDS for n in names) / t.calls


def idle_unattributed_share(t):
    """Percent of the card's idle time in the window that lies in gaps
    whose middle no span covers; None without spans or idle time."""
    covered = merge((s[0], s[1]) for s in spans(t))
    if not covered:
        return None
    starts = [s for s, _ in covered]
    busy = t.busy_intervals()
    edges = [t.start] + [x for iv in busy for x in iv] + [t.end]
    idle = lost = 0.0
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        idle += e - s
        if i < 0 or mid >= covered[i][1]:
            lost += e - s
    return 100.0 * lost / idle if idle > 0 else None
