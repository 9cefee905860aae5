"""Kernels: K2, the fused SW kernel (ops/cuda/sw_megakernel.py,
csrc/sw_megakernel.cu), in any mode. The least time the SW work of the
profiled calls needs (counts.sw_work) over K2's device time, percent."""

from radbench.counts import least_seconds

KERNELS = ("sw_mega_kernel",)


def read(t):
    seconds = t.seconds_of(KERNELS)
    if seconds <= 0 or "sw" not in t.work:
        return None
    return 100.0 * least_seconds(*t.work["sw"]) / seconds
