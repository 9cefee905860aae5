"""Solvers (rte.py rte_sw, ops/sw_solver.py, ops/cuda/sw_2stream.py):
device time of the kernels, copies and memsets launched under the port's
``rte.solve.sw`` span, milliseconds a call."""

from radbench.launched import ms_per_call


def read(t):
    return ms_per_call(t, "rte.solve.sw")
