"""Profiling and throughput instrumentation.

Port of rte_rrtmgp_nn_tpu/utils/timing.py. Reference parity: the GPTL
region timers compiled in with ``-DUSE_TIMING`` (build/Makefile:53-62;
instrumentation points across the solver and gas-optics phases, e.g.
mo_rte_solver_kernels.F90:167-168) and the always-on ``system_clock`` wall
timing with per-run reports (rrtmgp_rfmip_lw.F90:354-472).

Here: named ``torch.profiler.record_function`` ranges that show up in
torch.profiler traces, a region timer with a GPTL-style report (the host
clock, or CUDA events on the card's stream for a region given a CUDA
device), and a columns/s helper that times batches of back-to-back calls
with CUDA events when the function's outputs are on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class RegionTimers:
    """GPTL-style named region timers (call counts and seconds). A region
    timed on a CUDA device is the time between two CUDA events recorded on
    the current stream around it: the card's time, read when a report is
    made; other regions take the host's clock."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._pending: list = []

    @contextlib.contextmanager
    def region(self, name: str, annotate: bool = True, device=None) -> Iterator[None]:
        """Time a region; also emits a named range into profiler traces so
        device activity is attributable (``annotate``)."""
        events = None
        if _on_cuda(device):
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name) if annotate else contextlib.nullcontext():
            yield
        if events is None:
            self.totals[name] += time.perf_counter() - t0
        else:
            events[1].record()
            self._pending.append((name, *events))
        self.counts[name] += 1

    def _collect(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self.totals[name] += start.elapsed_time(end) / 1e3
        self._pending.clear()

    def report(self) -> str:
        """Text report (the analogue of gptlpr_file output)."""
        self._collect()
        lines = [f"{'region':40s} {'calls':>8s} {'total_s':>10s} {'per_call_ms':>12s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:40s} {n:8d} {tot:10.4f} {1e3 * tot / n:12.4f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._pending.clear()
        self.totals.clear()
        self.counts.clear()


timers = RegionTimers()


@contextlib.contextmanager
def trace(name: str):
    """Bare named range for profiler traces (no timing bookkeeping)."""
    with torch.profiler.record_function(name):
        yield


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor in a function's result: a tensor, or one inside a
    tuple (named too), list, dict or dataclass (the drivers' fluxes)."""
    if torch.is_tensor(out):
        return out
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    for o in out if isinstance(out, (list, tuple)) else ():
        t = _first_tensor(o)
        if t is not None:
            return t
    return None


def columns_per_second(ncol: int, fn, *args, n_iter: int = 10, warmup: int = 1) -> float:
    """Steady-state throughput of a column-batch function: ``n_iter``
    back-to-back calls after ``warmup`` ones, timed with CUDA events when
    the function's first output tensor is on the card (the host queues
    ahead of it), else with the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn(*args)
        end.record()
        end.synchronize()
        return ncol * n_iter / (start.elapsed_time(end) / 1e3)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn(*args)
    return ncol * n_iter / (time.perf_counter() - t0)


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
