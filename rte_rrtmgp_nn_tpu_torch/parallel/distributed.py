"""Multi-process initialization, process-group meshes and a rank launcher.

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
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import queue as queue_mod
import socket
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh, set_rank_device


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def rank_device(device=None) -> torch.device:
    """This process's device: the CPU when ``device`` says so; otherwise
    ``cuda:LOCAL_RANK``, or ``cuda:0`` when the host has a single card (two
    ranks sharing it). Raises when CUDA is asked for and there is none."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device; pass device='cpu' for CPU ranks")
    n = torch.cuda.device_count()
    local = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", 0 if n == 1 else local % n)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
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
    process with a coordinator is made, as it is a real process group."""
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
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
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


def _rank_main(rank, nprocs, address, device, fn, arg_queue, results):
    args = arg_queue.get()
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    if device is not None and torch.device(device).type == "cpu":  # the ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
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
    the host. A rank that raises makes this raise with its traceback;
    every process is joined or killed before it returns."""
    ctx = _rank_context()
    results, arg_queue = ctx.Queue(), ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    # the arguments go through a queue: in the process object a large one
    # would hold start() until the child has read it all
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, address, device, fn, arg_queue, results))
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
