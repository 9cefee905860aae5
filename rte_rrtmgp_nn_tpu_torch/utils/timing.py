"""Named spans of the port's host stages, and a trace of them on demand.

Port of rte_rrtmgp_nn_tpu/utils/timing.py. Reference parity: the GPTL
region timers compiled in with ``-DUSE_TIMING`` (build/Makefile:53-62;
instrumentation points across the solver and gas-optics phases, e.g.
mo_rte_solver_kernels.F90:167-168) and the always-on ``system_clock`` wall
timing with per-run reports (rrtmgp_rfmip_lw.F90:354-472).

Here: ``span(name)``, a ``torch.profiler.record_function`` range around a
stage of the drivers and the staging ring, named ``rte.<stage>``. While a
profiler records, a span lands in its trace as a ``user_annotation`` event
on the clock the card's kernels, copies and runtime calls share, so an idle
stretch of the card can be put down to the host stage over it; the times
live in the profiler and are written when the profile ends. While none
records, entering a span checks one flag and makes nothing. A count is the
number of a span's events in a trace. ``start_trace`` / ``stop_trace``
write a TensorBoard / Perfetto trace of what runs between them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function


class span:
    """``with span("rte.<stage>"):`` a named range in the profiler's trace,
    or nothing while no profiler records."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False


_PROFILER: Optional[torch.profiler.profile] = None


def start_trace(logdir: str) -> None:
    """Begin a torch.profiler capture (the CPU, and the card where there is
    one) written to ``logdir`` as a TensorBoard / Perfetto trace when
    stop_trace is called."""
    global _PROFILER
    if _PROFILER is not None:
        raise RuntimeError("start_trace: a trace is already being captured")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _PROFILER = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    _PROFILER.__enter__()


def stop_trace() -> None:
    """End the capture start_trace began and write its trace."""
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("stop_trace: no trace is being captured")
    prof, _PROFILER = _PROFILER, None
    prof.__exit__(None, None, None)
