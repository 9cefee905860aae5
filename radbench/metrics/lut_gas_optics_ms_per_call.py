"""Gas optics (gasoptics/lut_gas_optics.py, ops/cuda/lut_gas_optics.py):
device time of the kernels, copies and memsets launched under the port's
``rte.lut.*`` spans (the lookup-table gas optics and its Planck sources),
milliseconds a call."""

from radbench.launched import ms_per_call


def read(t):
    return ms_per_call(t, "rte.lut.")
