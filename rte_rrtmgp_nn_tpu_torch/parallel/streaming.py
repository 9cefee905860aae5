"""Host -> device block streaming for problems larger than device memory.

Port of rte_rrtmgp_nn_tpu/parallel/streaming.py (the reference's OpenMP
block loop over columns held in host memory, rrtmgp_rfmip_lw.F90:364-446).

On a CUDA device each block travels through a ring of two staging slots,
each one flat pinned host buffer and one flat device buffer. The host
writes the block's rows of every host array into the slot field-major, one
region after another (``_slot_layout``: each region starts on a 256-byte
boundary), one contiguous copy per array, since the arrays are
column-leading; a slot of ``_POOL_MIN_BYTES`` or more is written by the
process's copy threads, each taking an equal share of every region's rows
(``_fill``). A copy stream of the device's own then copies the slot's used
bytes into its device buffer as ONE copy without blocking, and the compute
stream (the device's current stream, on which the kernels launch) waits for
that copy's event before it runs the step on one view per array of the
device buffer.

Block 0 is staged and run at once. Block k+1 is staged after block k's step
is queued and the caller has queued its reads of block k's results (after
the ``yield``), so the card waits for the host through one fill a sweep and
every later fill overlaps the step before it. A pinned buffer is refilled
only after the event of its previous copy has completed. A device buffer's
next copy waits only for the compute-stream work that read the buffer: the
step of the block that last used the slot and the reads of its results (a
step may return views of its inputs). An event recorded on the compute
stream when the following block is staged, before that block's step is
queued, marks that work; so block k+1's copy overlaps block k's step, and
neither side overwrites data still in use. The device buffers are allocated
once, before the sweep, so the caching allocator never hands the copy
stream memory that the compute stream still reads. Each block's results
come back as a non-blocking copy into pinned host memory; ``stream_reduce``
synchronizes once, at the end.

On the CPU it is a plain loop over blocks, in the same order.

The last block runs at its own size, without padding: the kernels mask
ragged columns, so the stitched result is the result without blocks.
With a column sharding each block is split over the mesh's devices in
order (parallel/sharding.py), each device runs its share on its own
streams, and the shares are joined in column order.
"""
from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from ..utils.timing import span
from .sharding import ColumnSharding, Mesh, column_sharding


def iter_blocks(ncol: int, block_size: int) -> Iterator[tuple[int, int]]:
    """(start, size) pairs covering [0, ncol); the reference's nblocks
    split (block loop, rrtmgp_rfmip_lw.F90:213-215)."""
    for start in range(0, ncol, block_size):
        yield start, min(block_size, ncol - start)


def _sharding(sharding, device) -> ColumnSharding:
    if sharding is not None:
        if sharding.mesh.ranks is not None:
            raise ValueError("stream_blocks: a process-group mesh; each rank streams its own "
                             "columns (parallel.distributed.local_column_slice) on one device")
        return sharding
    if device is None:
        raise ValueError("stream_blocks needs a device or a sharding")
    return column_sharding(Mesh((torch.device(device),)), 2)


# bytes: every region of a staging slot starts on this boundary, so each
# view keeps its dtype's alignment and its rows coalesce
_SLOT_ALIGN = 256
# bytes: a slot's fill of less than this stays on the calling thread, where
# handing it to threads would cost about what it saves
_POOL_MIN_BYTES = 8 << 20
# the most copy threads a process keeps: on an H100 host one thread fills a
# 64 MB slot in 13.4 ms, two in 7.8, four in 4.6 and eight in 4.0
# (scripts/probe_stage_copy.py), and a rank of a four-card host has 8 cores
_POOL_MAX_THREADS = 4
# (pid, executor or None, threads) of the process's copy threads
_POOL: tuple = (None, None, 1)


def _slot_layout(arrays: Sequence[np.ndarray], n: int) -> list[tuple[int, tuple, np.dtype]]:
    """Where a block of ``n`` rows of each column-leading array lies in a flat
    staging slot: (byte offset, shape (n,) + shape[1:], dtype) per array, in
    order, each region right after the previous one, rounded up to
    ``_SLOT_ALIGN`` bytes."""
    layout, offset = [], 0
    for a in arrays:
        shape = (n,) + tuple(a.shape[1:])
        layout.append((offset, shape, a.dtype))
        offset += -(-_region_bytes(shape, a.dtype) // _SLOT_ALIGN) * _SLOT_ALIGN
    return layout


def _region_bytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


def _slot_bytes(layout) -> int:
    """The bytes a slot's layout uses, up to the end of its last region."""
    offset, shape, dtype = layout[-1]
    return offset + _region_bytes(shape, dtype)


def _slot_views(buf: torch.Tensor, layout) -> list[torch.Tensor]:
    """One view per region of ``layout`` over the flat uint8 buffer ``buf``,
    of the region's shape and dtype."""
    return [buf[offset:offset + _region_bytes(shape, dtype)].view(_torch_dtype(dtype)).view(shape)
            for offset, shape, dtype in layout]


def _copy_pool() -> tuple:
    """(executor, threads) of this process's copy threads, made at the
    process's first pooled fill: at most ``_POOL_MAX_THREADS`` and no more
    than the cores the process may run on; no executor where that is one
    thread. Keyed by the process id, so a forked process makes its own."""
    global _POOL
    pid, pool, threads = _POOL
    if pid != os.getpid():
        threads = min(_POOL_MAX_THREADS, len(os.sched_getaffinity(0)))
        pool = ThreadPoolExecutor(threads, "rte-stage") if threads > 1 else None
        _POOL = (os.getpid(), pool, threads)
    return pool, threads


def _fill(regions: Sequence[np.ndarray], parts: Sequence[np.ndarray]) -> None:
    """Copy each of ``parts`` into its region of a staging slot: on the
    calling thread below ``_POOL_MIN_BYTES``, else by the process's copy
    threads (span ``rte.stage.pool``)."""
    pool, threads = (_copy_pool() if sum(a.nbytes for a in parts) >= _POOL_MIN_BYTES
                     else (None, 1))
    if pool is None:
        for region, a in zip(regions, parts):
            np.copyto(region, a)
        return
    with span("rte.stage.pool"):
        _fill_pooled(regions, parts, pool, threads)


def _fill_pooled(regions, parts, pool: ThreadPoolExecutor, threads: int) -> None:
    """``_fill`` on ``threads`` threads of ``pool``: thread i copies rows
    [n i / t, n (i + 1) / t) of every region, so each copies the same bytes
    to a row. The views are made here; the threads only copy."""
    n = regions[0].shape[0]
    t = max(1, min(threads, n))
    cuts = [n * i // t for i in range(t + 1)]
    chunks = [[(r[lo:hi], a[lo:hi]) for r, a in zip(regions, parts)]
              for lo, hi in zip(cuts, cuts[1:])]
    done, _ = wait([pool.submit(_copy_pairs, c) for c in chunks])
    for f in done:
        f.result()


def _copy_pairs(pairs) -> None:
    for dst, src in pairs:
        np.copyto(dst, src)


class _CudaStager:
    """The staging ring of one CUDA device for a sweep whose blocks give it
    ``shares`` shares each: two blocks' worth of flat pinned host buffers,
    each with a flat device buffer, the event of its last copy and the event
    after which the compute stream no longer reads its device buffer, sized
    for ``rows`` rows of the host arrays laid out by ``_slot_layout``.
    Shares are staged and run in the same order, so a counter each names
    the slot."""

    def __init__(self, device, host_arrays, rows: int, shares: int):
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.shares = shares
        nbytes = _slot_bytes(_slot_layout(host_arrays, rows))
        with span("rte.ring"), torch.cuda.device(device):
            self.copy = torch.cuda.Stream(device)
            self.slots = [{
                "pinned": torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                "dev": torch.empty(nbytes, dtype=torch.uint8, device=device),
                "copied": None, "read": None, "layout": None} for _ in range(2 * shares)]
        self.staged = self.ran = 0

    def stage(self, parts: Sequence[np.ndarray]) -> None:
        """Copy ``parts`` (one row block per host array) into the next slot,
        field-major, and that slot to the device in one copy."""
        i = self.staged % len(self.slots)
        slot = self.slots[i]
        self.staged += 1
        with span("rte.stage"):
            if slot["copied"] is not None:
                with span("rte.wait"):
                    slot["copied"].synchronize()  # the pinned buffer's last copy has left it
            layout = _slot_layout(parts, parts[0].shape[0])
            _fill([v.numpy() for v in _slot_views(slot["pinned"], layout)], parts)
            used = _slot_bytes(layout)
            with torch.cuda.device(self.device), torch.cuda.stream(self.copy):
                if slot["read"] is not None:
                    # the step of the block that last used this slot, and the
                    # reads of its results, are done with the device buffer
                    self.copy.wait_event(slot["read"])
                slot["dev"][:used].copy_(slot["pinned"][:used], non_blocking=True)
                slot["copied"] = torch.cuda.Event()
                slot["copied"].record(self.copy)
                # the compute stream holds the previous block's work and none
                # of this one's yet: what the same share of the next block
                # waits for, in the slot this share used last
                read = torch.cuda.Event()
                read.record(self.compute)
                self.slots[(i + self.shares) % len(self.slots)]["read"] = read
        slot["layout"] = layout

    def run(self, fn: Callable):
        """fn on the oldest staged slot's views of its device buffer, one per
        host array, on the compute stream."""
        slot = self.slots[self.ran % len(self.slots)]
        self.ran += 1
        with torch.cuda.device(self.device), torch.cuda.stream(self.compute):
            self.compute.wait_event(slot["copied"])
            return fn(*_slot_views(slot["dev"], slot["layout"]))


class _HostStager:
    """A device without a staging ring (the CPU): each share's rows made
    tensors as they are staged, and run in the same order."""

    def __init__(self, device):
        self.device = device
        self.staged = collections.deque()

    def stage(self, parts: Sequence[np.ndarray]) -> None:
        self.staged.append([torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                            for p in parts])

    def run(self, fn: Callable):
        return fn(*self.staged.popleft())


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _join(results: list):
    """Results of a block's shares joined in column order (a tensor, or a
    tuple / list of tensors)."""
    if len(results) == 1:
        return results[0]
    if torch.is_tensor(results[0]):
        return torch.cat([r.to(results[0].device) for r in results])
    return type(results[0])(_join([r[i] for r in results]) for i in range(len(results[0])))


def stream_blocks(
    fn: Callable,
    host_arrays: Sequence[np.ndarray],
    block_size: int,
    sharding=None,
    *,
    device=None,
):
    """Run ``fn`` over column blocks with transfer/compute overlap.

    fn: function of one tensor per host array (column axis leading, on one
    device) returning a tensor or a tuple of tensors, column-leading.
    host_arrays: column-leading numpy arrays of equal ncol. The blocks go to
    ``device``, or are split over ``sharding``'s devices. Yields (start,
    size, result) triples; with a sharding of several devices a result is
    the shares' results joined in column order on the first device's. A
    result may be a view of the block's staging slot: read it, or queue its
    reads, before the next block is asked for."""
    shards = _sharding(sharding, device)
    ncol = host_arrays[0].shape[0]
    blocks = list(iter_blocks(ncol, block_size))
    share = shards.split(block_size)
    stagers = {}
    for d, _, rows in share:
        if d not in stagers:
            stagers[d] = (_CudaStager(d, host_arrays, rows, sum(e == d for e, _, _ in share))
                          if d.type == "cuda" else _HostStager(d))

    def put(start: int, size: int) -> None:
        for d, s, n in shards.split(size):
            stagers[d].stage([a[start + s:start + s + n] for a in host_arrays])

    if blocks:
        put(*blocks[0])
    for k, (start, size) in enumerate(blocks):
        with span("rte.step"):
            results = [stagers[d].run(fn) for d, _, _ in shards.split(size)]
        yield start, size, _join(results)
        if k + 1 < len(blocks):
            put(*blocks[k + 1])  # the caller has queued its reads of block k's results


def stream_reduce(
    fn: Callable,
    host_arrays: Sequence[np.ndarray],
    block_size: int,
    out_builder: Callable[[int], list],
    sharding=None,
    *,
    device=None,
) -> list[np.ndarray]:
    """Stream blocks and gather the results into host output arrays.

    out_builder(ncol) -> list of preallocated host outputs, one per output
    of fn (all column-leading). On CUDA each block's results are copied
    into pinned host memory without blocking, and the sweep synchronizes
    once at its end; only the results are kept, so fn should return
    per-column diagnostics, not whole profiles."""
    with span("rte.stream"):
        ncol = host_arrays[0].shape[0]
        outs = out_builder(ncol)
        pinned, cuda_devices = None, set()
        for start, size, res in stream_blocks(fn, host_arrays, block_size, sharding,
                                              device=device):
            res = list(res) if isinstance(res, (tuple, list)) else [res]
            if res[0].device.type == "cuda":
                with span("rte.d2h"):
                    cuda_devices.add(res[0].device)
                    if pinned is None:
                        pinned = [torch.empty(o.shape, dtype=r.dtype, pin_memory=True)
                                  for o, r in zip(outs, res)]
                    for p, r in zip(pinned, res):
                        p[start:start + size].copy_(r, non_blocking=True)
            else:
                with span("rte.gather"):
                    for o, r in zip(outs, res):
                        o[start:start + size] = r.numpy()
        if pinned is not None:
            with span("rte.wait"):
                for d in cuda_devices:
                    torch.cuda.synchronize(d)
            with span("rte.gather"):
                for o, p in zip(outs, pinned):
                    o[...] = p.numpy()
        return outs
