"""Multi-process initialization, process-group meshes, a rank launcher and
a persistent rank group.

Port of rte_rrtmgp_nn_tpu/parallel/distributed.py on ``torch.distributed``.
The reference has no distributed backend (one process and OpenMP). The
scaling path: initialize one process per card, build a ('col', 'gpt') mesh
over the ranks (parallel/sharding ``make_mesh`` in its process-group form),
give each rank its own block of columns (halo-free), and let only flux
statistics and, under a g-point split, the broadband sums cross ranks.

Backends, chosen by ``initialize``: NCCL for CUDA ranks, one rank per card;
gloo for CPU ranks, or when this host's ranks outnumber its cards (NCCL
refuses two ranks on one GPU), where gloo stages its CUDA collectives
through the host.

Ranks start one way: forked from a server that has imported torch, each
bound to its own equal share of the host's cores with the caller's number
of intra-op threads (``core_shares``), as an MPI launcher binds ranks, and
with the kernel library built before any of them starts. ``launch`` runs a
function once on new ranks; ``RankGroup`` keeps its ranks, the caller
being rank 0, and hands them one step after another, each ended at a
host-side barrier, as a GCM keeps its ranks for a run.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.timing import span
from .sharding import Mesh, make_mesh, set_rank_device


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def rank_device(device=None, local_rank: Optional[int] = None) -> torch.device:
    """This process's device: the CPU when ``device`` says so; otherwise
    ``cuda:<local rank>`` (``local_rank``, else LOCAL_RANK, else 0), or
    ``cuda:0`` when the host has a single card (two ranks sharing it).
    Raises when CUDA is asked for and there is none."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device; pass device='cpu' for CPU ranks")
    n = torch.cuda.device_count()
    local = local_rank if local_rank is not None else (_env_int("LOCAL_RANK") or 0)
    return torch.device("cuda", 0 if n == 1 else local % n)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: Optional[float] = None,
) -> None:
    """Initialize ``torch.distributed`` (a no-op in a single-process setup).

    The coordinator ("host:port"), the number of processes and this
    process's rank come from the arguments, else from torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK). With none of
    them this is a single-process run and nothing happens; a group that is
    already initialized is left as it is. ``device`` None means this rank's
    card (``rank_device``). The backend is gloo for the CPU or when this
    host's ranks (LOCAL_WORLD_SIZE, else the world) outnumber its cards,
    NCCL otherwise.

    If the caller asked for more than one process and the world cannot be
    made (no coordinator, no rank), this raises: silently degrading to one
    process would compute a fraction of the problem. A world of one
    process with a coordinator is made, as it is a real process group.
    ``timeout_s`` bounds the wait for the other ranks (torch's default
    otherwise)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    multi = num_processes is not None and num_processes > 1
    if coordinator_address is None or num_processes is None or process_id is None:
        if multi or (coordinator_address is not None and num_processes is None):
            missing = [n for n, v in (("coordinator_address", coordinator_address),
                                      ("num_processes", num_processes),
                                      ("process_id", process_id)) if v is None]
            raise ValueError(f"initialize: a world of {num_processes} processes needs "
                             f"{', '.join(missing)} (arguments or torchrun's environment)")
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize: process_id {process_id} outside a world of {num_processes}")
    dev = rank_device(device)
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or num_processes
    shared = dev.type == "cpu" or local_ranks > torch.cuda.device_count()
    backend = "gloo" if shared else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    set_rank_device(dev)


def global_mesh(n_gpt: int = 1) -> Mesh:
    """A ('col', 'gpt') mesh over every rank of the world, in JAX's device
    order (rank r at (r // n_gpt, r % n_gpt)): 'col' spans the hosts, and a
    'gpt' group is ``n_gpt`` consecutive ranks, which torchrun places on
    one host, so the broadband sums never cross hosts. Without a process
    group: the one-process mesh over this host's cards."""
    if not dist.is_initialized():
        return make_mesh(n_gpt=n_gpt)
    local = _env_int("LOCAL_WORLD_SIZE")
    if local is not None and local % n_gpt:
        raise ValueError(f"global_mesh(n_gpt={n_gpt}): a 'gpt' group would cross hosts "
                         f"({local} ranks a host)")
    return make_mesh(n_col=dist.get_world_size() // n_gpt, n_gpt=n_gpt)


def local_column_slice(ncol_global: int) -> tuple[int, int]:
    """This process's contiguous column range (start, size) under even
    splitting over the processes; the last one takes the remainder."""
    p, n = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    per = ncol_global // n
    start = p * per
    size = per if p < n - 1 else ncol_global - start
    return start, size


def free_port() -> int:
    """A free TCP port on localhost for a coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# What every rank imports (torch.optim's step imports torch._dynamo): the
# server that ``launch`` forks its ranks from imports them once.
_RANK_PRELOAD = ["torch", "torch.distributed", "torch._dynamo"]


def _rank_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_RANK_PRELOAD)
    if not _SERVER_STOP:
        _SERVER_STOP.append(atexit.register(_stop_rank_server))
    return ctx


_SERVER_STOP: list = []


def _stop_rank_server() -> None:
    """At exit: stop the server and reap it. Left alone it exits only once
    this process has gone, and then nobody waits for it."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def start_rank_server() -> None:
    """Start the process that ``launch`` forks its ranks from, which
    imports torch once, and return at once: a later ``launch`` then waits
    for no import. ``launch`` starts it itself when it is not running. The
    ranks get the environment of the moment it starts."""
    from multiprocessing import forkserver

    _rank_context()
    forkserver.ensure_running()


def core_shares(nprocs: int) -> list:
    """This process's allowed cores split into ``nprocs`` disjoint, equal,
    contiguous shares, rank r taking share r (with fewer cores than ranks,
    the ranks beyond them share the last)."""
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // nprocs)
    return [cores[r * k:(r + 1) * k] or cores[-k:] for r in range(nprocs)]


def _bind(cores, threads: int) -> None:
    """Bind this process to ``cores`` and run ``threads`` intra-op threads."""
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(threads)


def _start(nprocs: int, device) -> tuple:
    """What every way of starting ranks shares: the process context, a
    coordinator address, and each rank's binding (its share of the cores,
    and the caller's intra-op threads, at most the share). On the cards the
    kernel library is built first, so that the ranks never race to build
    it."""
    if (device is None or torch.device(device).type == "cuda") and torch.cuda.is_available():
        from ..ops.cuda import build

        build.build()
    shares = core_shares(nprocs)
    threads = min(torch.get_num_threads(), len(shares[0]))
    return _rank_context(), f"127.0.0.1:{free_port()}", [(c, threads) for c in shares]


def _rank_env(rank: int, nprocs: int) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)


def _rank_main(rank, nprocs, address, device, binding, fn, arg_queue, results):
    _bind(*binding)
    args = arg_queue.get()
    _rank_env(rank, nprocs)
    try:
        initialize(address, nprocs, rank, device=device)
        out = fn(*args)
    except BaseException:  # noqa: BLE001 - the parent reports the rank's traceback
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *args, device=None, timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` new processes, each a rank of one
    process group on localhost (forked from ``start_rank_server``'s
    process, which has imported torch but touched no card, so CUDA may be
    used; ``fn`` and the arguments are pickled as for a spawn), and return
    their results in rank order (they must pickle: numpy arrays, CPU
    tensors). ``device`` goes to ``initialize``: None puts each rank on its
    card (ranks beyond the host's cards share them, over gloo), "cpu" on
    the host. Each rank is bound as ``core_shares`` says. A rank that
    raises makes this raise with its traceback; every process is joined or
    killed before it returns."""
    ctx, address, bindings = _start(nprocs, device)
    results, arg_queue = ctx.Queue(), ctx.Queue()
    # the arguments go through a queue: in the process object a large one
    # would hold start() until the child has read it all
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, address, device, bindings[r], fn, arg_queue, results))
             for r in range(nprocs)]
    for p in procs:
        arg_queue.put(args)
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < nprocs:
            try:
                rank, ok, out = results.get(timeout=timeout_s)
            except queue_mod.Empty:
                raise TimeoutError(f"launch: no result from {nprocs - len(got)} rank(s) "
                                   f"in {timeout_s} s") from None
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("launch: a rank failed\n" + "\n".join(errors))
    return [got[r] for r in range(nprocs)]


# the longest a rank group's set-up may take: imports, the kernel library,
# nets and inputs on every rank at once
SETUP_TIMEOUT_S = 600.0


def _views(out_raw, counters_raw, nprocs: int, shape: tuple) -> tuple:
    """The group's shared buffers as arrays: (nprocs, *shape) float32
    results; (2, nprocs) float64 counters, a step's host-clock ms and the
    card's peak bytes allocated so far (0 on the CPU), a rank a column."""
    return (np.frombuffer(out_raw, np.float32).reshape(nprocs, *shape),
            np.frombuffer(counters_raw, np.float64).reshape(2, nprocs))


def _run_step(rank: int, fn, state, args, out, counters, dev) -> None:
    """One rank's share of a step: ``fn(state, *args)`` into its row of the
    shared results, its time and peak into the counters."""
    t0 = time.perf_counter()
    out[rank] = fn(state, *args)
    counters[0, rank] = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        counters[1, rank] = torch.cuda.max_memory_allocated(dev)


def _report(conn, barrier) -> None:
    """Hand the caller this rank's traceback, then break the barrier so
    that its wait ends at once."""
    conn.send(traceback.format_exc())
    barrier.abort()


def _group_rank(rank, nprocs, address, device, binding, make, fn, conn, barrier, out_raw,
                counters_raw, shape, step_timeout_s):
    """A rank of a RankGroup other than the caller: set up once, then one
    step a message until the caller closes the group or goes."""
    _bind(*binding)
    _rank_env(rank, nprocs)
    out, counters = _views(out_raw, counters_raw, nprocs, shape)
    try:
        try:
            dev = rank_device(device)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            state = make(rank, dev)
        except Exception:  # noqa: BLE001 - the caller raises with this traceback
            return _report(conn, barrier)
        barrier.wait(SETUP_TIMEOUT_S)
        initialize(address, nprocs, rank, device=dev, timeout_s=SETUP_TIMEOUT_S)
        while (args := conn.recv()) is not None:
            try:
                _run_step(rank, fn, state, args, out, counters, dev)
            except Exception:  # noqa: BLE001 - the caller raises with this traceback
                return _report(conn, barrier)
            barrier.wait(step_timeout_s)
    except (threading.BrokenBarrierError, EOFError, OSError):
        return  # the caller broke the group off, or has gone
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """``nprocs`` ranks of one process group on this host, set up once and
    handed one step after another, as a model keeps its ranks for a run.

    The calling process is rank 0, so a profiler it opens sees one whole
    rank; the others are forked as ``launch`` forks its ranks, each on its
    own card (``rank_device``; ``device="cpu"``: CPU ranks over gloo; the
    ranks' devices in rank order are ``devices``), and
    every rank, rank 0 included, is bound to its share of the cores
    (``core_shares``) with rank 0's intra-op threads, at most the share
    (the caller's binding comes back at ``close``). Each rank runs
    ``make(rank, device) -> state`` once, its set-up, before the process
    group forms. ``step(*args)`` then hands every other rank its step,
    runs ``fn(state, *args)`` of rank 0 here, and ends at a host-side
    barrier, so no kernel spins on a card while rank 0 waits: it returns
    once every rank's result, an array of ``shape`` carried as float32
    through host buffers shared and allocated once, is in host memory, as
    (nprocs, *shape) in rank order. ``make`` and ``fn`` must pickle (a
    module's functions, ``functools.partial`` of them).

    A rank that raises, in set-up or a step, makes the constructor or
    ``step`` raise with that rank's traceback; a set-up that outlasts
    ``SETUP_TIMEOUT_S``, or a step ``step_timeout_s``, raises TimeoutError.
    Either closes the group. ``close`` (also at exit, and on leaving a ``with`` block) ends every
    rank, killing those that do not end at once."""

    def __init__(self, make: Callable, fn: Callable, nprocs: int, shape, *, device=None,
                 step_timeout_s: float = 300.0):
        if dist.is_initialized():
            raise RuntimeError("RankGroup: this process is a rank of a process group already")
        self.nprocs, self.shape = nprocs, tuple(shape)
        self.state = None
        self._fn, self._step_timeout_s = fn, step_timeout_s
        self._procs, self._conns, self._ms = [], [], []
        self._closed = self._broken = self._grouped = False
        self._caller_binding = (os.sched_getaffinity(0), torch.get_num_threads())
        ctx, address, bindings = _start(nprocs, device)
        size = nprocs * int(np.prod(self.shape, dtype=np.int64))
        self._out_raw, self._counters_raw = ctx.RawArray("f", size), ctx.RawArray("d", 2 * nprocs)
        self._out, self._counters = _views(self._out_raw, self._counters_raw, nprocs, self.shape)
        self._barrier = ctx.Barrier(nprocs)
        atexit.register(self.close)
        try:
            for r in range(1, nprocs):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_group_rank, daemon=True,
                                args=(r, nprocs, address, device, bindings[r], make, fn, theirs,
                                      self._barrier, self._out_raw, self._counters_raw,
                                      self.shape, step_timeout_s))
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(mine)
            _bind(*bindings[0])
            self.devices = [rank_device(device, r) for r in range(nprocs)]
            self._device = self.devices[0]
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            self.state = make(0, self._device)
        except BaseException:
            self._break_off()
            raise
        self._wait(SETUP_TIMEOUT_S, "set-up")
        try:
            initialize(address, nprocs, 0, device=self._device, timeout_s=SETUP_TIMEOUT_S)
        except BaseException:
            self._break_off()
            raise
        self._grouped = True

    def step(self, *args) -> np.ndarray:
        """One step of every rank on ``args``: the results (nprocs, *shape)
        in rank order, a copy."""
        if self._closed:
            raise RuntimeError("RankGroup.step: the group is closed")
        with span("rte.rank.dispatch"):
            for r, (c, p) in enumerate(zip(self._conns, self._procs), 1):
                try:
                    c.send(args)
                except OSError:
                    self._break_off()
                    raise RuntimeError(f"RankGroup.step: rank {r} has gone "
                                       f"(exit {p.exitcode})") from None
        try:
            _run_step(0, self._fn, self.state, args, self._out, self._counters, self._device)
        except BaseException:
            self._break_off()
            raise
        with span("rte.rank.barrier"):
            self._wait(self._step_timeout_s, "step")
        self._ms.append(self._counters[0].copy())
        return self._out.copy()

    def stats(self) -> dict:
        """The steps' counters: each rank's step time by the host clock
        (ms, a row a step), the slowest rank and the skew (slowest less
        fastest, ms) of each step, and each card's peak bytes allocated
        (0 on the CPU)."""
        ms = np.asarray(self._ms, np.float64).reshape(-1, self.nprocs)
        return {"step_ms": ms.tolist(), "slowest_rank": ms.argmax(axis=1).tolist(),
                "skew_ms": (ms.max(axis=1) - ms.min(axis=1)).tolist(),
                "peak_bytes": [int(b) for b in self._counters[1]]}

    def _wait(self, timeout_s: float, what: str) -> None:
        try:
            self._barrier.wait(timeout_s)
        except threading.BrokenBarrierError:
            errors = [f"rank {r}:\n{c.recv()}" for r, c in enumerate(self._conns, 1)
                      if c.poll(0)]
            ranks = ", ".join(f"rank {r} " + ("alive" if p.is_alive() else f"exit {p.exitcode}")
                              for r, p in enumerate(self._procs, 1))
            self._break_off()
            if errors:
                raise RuntimeError(f"RankGroup: a rank failed in its {what}\n"
                                   + "\n".join(errors)) from None
            raise TimeoutError(f"RankGroup: the {what} did not reach the barrier in "
                               f"{timeout_s} s ({ranks})") from None

    def _break_off(self) -> None:
        self._broken = True
        self._barrier.abort()
        self.close()

    def close(self) -> None:
        """End every rank (those that do not end at once are killed), leave
        the process group and give the caller its binding back."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        for c in self._conns:
            try:
                c.send(None)
            except OSError:
                pass
        deadline = time.monotonic() + (1.0 if self._broken else 30.0)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        for c in self._conns:
            c.close()
        if self._grouped:
            dist.destroy_process_group()
        _bind(*self._caller_binding)
        self.state = None

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
