"""The whole radiation call: the counted operations of the profiled calls
(counts.lw_work + counts.sw_work) over the window at the float32 peak,
percent. It bounds any gain of a kernel, also once a kernel has left the
path."""

from radbench.counts import PEAK_F32_FLOPS


def read(t):
    flops = sum(f for f, _ in t.work.values())
    if flops <= 0:
        return None
    return 100.0 * flops / (t.window_s * PEAK_F32_FLOPS)
