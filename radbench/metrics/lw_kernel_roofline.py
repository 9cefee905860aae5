"""Kernels: K1, the fused LW kernel (ops/cuda/lw_megakernel.py,
csrc/lw_megakernel.cu), in any mode. The least time the LW work of the
profiled calls needs (counts.lw_work) over K1's device time, percent."""

from radbench.counts import least_seconds

KERNELS = ("lw_mega_kernel",)


def read(t):
    seconds = t.seconds_of(KERNELS)
    if seconds <= 0 or "lw" not in t.work:
        return None
    return 100.0 * least_seconds(*t.work["lw"]) / seconds
