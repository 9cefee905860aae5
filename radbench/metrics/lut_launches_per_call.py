"""Gas optics (gasoptics/lut_gas_optics.py, ops/cuda/lut_gas_optics.py):
kernels, copies and memsets launched under the port's ``rte.lut.*`` spans,
over the profiled calls."""

from radbench.launched import launched_under


def read(t):
    ops = launched_under(t, "rte.lut.")
    return len(ops) / t.calls if ops else None
