"""Column splitting over devices, in one process or over the ranks of a
process group.

Port of rte_rrtmgp_nn_tpu/parallel/sharding.py. Columns are independent
(no halo), so a block of columns is split over the mesh in order, each
device solves its share, and the shares' results are joined in column
order. One H100 is a mesh of one.

Two forms of ``Mesh``:
  - one process: a list of devices that share the columns ('gpt' of size
    1). The JAX package can also split the g-points over a second axis,
    where XLA inserts the collective for the broadband sum; one process
    here has no such collective, so a g-point split is refused;
  - a process group (``torch.distributed``, parallel/distributed): the
    ranks laid out (n_col, n_gpt) as JAX orders devices, each rank holding
    its own block of columns and, under a 'gpt' split, of g-points; the
    broadband sums meet by ``all_reduce`` over the rank's 'gpt' group.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_GPT_SPLIT = ("a split of the g-points over devices needs a collective for the broadband "
              "sum; one process has none: initialize torch.distributed "
              "(parallel.distributed.initialize) and make the mesh over its ranks")

_RANK_DEVICE: dict = {}


def set_rank_device(device) -> None:
    """Record the device of this process's rank (parallel.distributed.initialize)."""
    _RANK_DEVICE["device"] = torch.device(device)


def _rank_device() -> torch.device:
    if "device" in _RANK_DEVICE:
        return _RANK_DEVICE["device"]
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """The process-group form of a mesh: the world's ranks laid out
    (n_col, n_gpt) row-major, this rank's place in it, and the groups that
    span its two axes (None: the whole world, or no other rank)."""

    n_col: int
    n_gpt: int
    rank: int
    col_group: object = None  # the ranks of this rank's 'gpt' index, along 'col'
    gpt_group: object = None  # the ranks of this rank's 'col' index, along 'gpt'

    @property
    def col_index(self) -> int:
        return self.rank // self.n_gpt

    @property
    def gpt_index(self) -> int:
        return self.rank % self.n_gpt


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('col', 'gpt') device mesh. One process: ``devices`` share the
    columns in order and 'gpt' has size 1. Process group (``ranks`` set):
    ``devices`` is this rank's device alone and ``ranks`` the layout."""

    devices: tuple  # of torch.device
    ranks: Optional[RankGrid] = None

    axis_names = ("col", "gpt")

    @property
    def shape(self) -> dict:
        if self.ranks is not None:
            return {"col": self.ranks.n_col, "gpt": self.ranks.n_gpt}
        return {"col": len(self.devices), "gpt": 1}

    @property
    def size(self) -> int:
        return self.shape["col"] * self.shape["gpt"]


def _process_mesh(n_col: Optional[int], n_gpt: int) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_col is None:
        n_col = world // n_gpt
    if n_col * n_gpt != world:
        raise ValueError(f"mesh {n_col}x{n_gpt} needs {n_col*n_gpt} ranks; a process-group mesh "
                         f"spans the world of {world}")
    col_group = gpt_group = None
    if n_gpt > 1:  # every rank makes every group, in the same order
        for g in range(n_gpt):
            grp = dist.new_group([c * n_gpt + g for c in range(n_col)])
            col_group = grp if g == rank % n_gpt else col_group
        if n_col > 1:
            for c in range(n_col):
                grp = dist.new_group([c * n_gpt + g for g in range(n_gpt)])
                gpt_group = grp if c == rank // n_gpt else gpt_group
    return Mesh((_rank_device(),), RankGrid(n_col, n_gpt, rank, col_group, gpt_group))


def make_mesh(n_col: Optional[int] = None, n_gpt: int = 1, devices=None) -> Mesh:
    """A mesh of ``n_col`` devices on the column axis (default: all of
    ``devices``). ``devices`` defaults to every CUDA device; with none
    present this raises, it does not fall back to the CPU (pass
    ``devices=["cpu", ...]`` for that). With ``torch.distributed``
    initialized and no ``devices``, the mesh spans the process group's
    ranks, n_col x n_gpt = the world size, and may split the g-points."""
    if devices is None and dist.is_available() and dist.is_initialized():
        return _process_mesh(n_col, n_gpt)
    if n_gpt != 1:
        raise NotImplementedError(f"make_mesh(n_gpt={n_gpt}): {_GPT_SPLIT}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_col is None:
        n_col = len(devices) // n_gpt
    if n_col * n_gpt > len(devices):
        raise ValueError(f"mesh {n_col}x{n_gpt} needs {n_col*n_gpt} devices, have {len(devices)}")
    return Mesh(tuple(devices[:n_col]))


def _shares(n: int, parts: int) -> list[tuple[int, int]]:
    """(start, size) of each non-empty share of ``n`` split in ``parts``
    shares of ceil(n / parts), in order."""
    per = -(-n // parts)
    return [(s, min(per, n - s)) for s in range(0, n, per)] if n else []


@dataclasses.dataclass(frozen=True)
class ColumnSharding:
    """Axis 0 (columns) of ``ndim``-dimensional arrays split over the
    mesh in order, in shares of ceil(ncol / n_col); on a process-group mesh
    also axis ``gpt_axis`` (g-points) over 'gpt', in shares of
    ceil(ngpt / n_gpt)."""

    mesh: Mesh
    ndim: int
    gpt_axis: Optional[int] = None

    def split(self, ncol: int) -> list[tuple[torch.device, int, int]]:
        """(device, start, size) of each non-empty share of ``ncol``
        columns, in column order; on a process-group mesh only this rank's
        share (none when it has no columns)."""
        ranks = self.mesh.ranks
        if ranks is None:
            return [(d, s, n) for d, (s, n) in zip(self.mesh.devices,
                                                   _shares(ncol, self.mesh.size))]
        mine = _shares(ncol, ranks.n_col)[ranks.col_index:ranks.col_index + 1]
        return [(self.mesh.devices[0], s, n) for s, n in mine]

    def gpt_slice(self, ngpt: int) -> tuple[int, int]:
        """(start, size) of this rank's g-points (all of them without a
        g-point split)."""
        ranks = self.mesh.ranks
        if self.gpt_axis is None or ranks is None or ranks.n_gpt == 1:
            return 0, ngpt
        per = -(-ngpt // ranks.n_gpt)
        start = min(ranks.gpt_index * per, ngpt)
        return start, min(per, ngpt - start)

    def local(self, x) -> torch.Tensor:
        """This rank's block of the whole array ``x`` (process-group mesh):
        its columns and, with ``gpt_axis``, its g-points, contiguous on its
        device."""
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        ((dev, s, n),) = self.split(x.shape[0]) or ((self.mesh.devices[0], 0, 0),)
        x = x.narrow(0, s, n)
        if self.gpt_axis is not None:
            gs, gn = self.gpt_slice(x.shape[self.gpt_axis])
            x = x.narrow(self.gpt_axis, gs, gn)
        return x.to(dev).contiguous()


def gather_columns(mesh: Mesh, x: torch.Tensor, ncol: Optional[int] = None) -> torch.Tensor:
    """The whole column range of a column-leading array from each rank's
    block ``x`` (process-group mesh), by ``all_gather`` over this rank's
    'col' axis: every rank gets the (ncol, ...) array on its device, the
    blocks in rank order. With ``ncol`` the blocks are ``column_sharding``'s
    split of it; without, they may be of any sizes, which are gathered
    first."""
    n_col, group = mesh.ranks.n_col, mesh.ranks.col_group
    if ncol is None:
        mine = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        got = [torch.empty_like(mine) for _ in range(n_col)]
        dist.all_gather(got, mine, group=group)
        sizes = [int(n) for n in got]
    else:
        sizes = [n for _, n in _shares(ncol, n_col)]
        sizes += [0] * (n_col - len(sizes))
    padded = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(n_col)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every device of the mesh holds the whole value."""

    mesh: Mesh

    def put(self, value) -> dict:
        """{device: the value on that device} for each distinct device of
        the mesh. A value already there is not copied; a module elsewhere
        is copied, never moved (``nn.Module.to`` moves in place); other
        values with a ``to(device)`` method and tensors are moved with it;
        lists and tuples are walked."""
        return {d: _place(value, d) for d in dict.fromkeys(self.mesh.devices)}


def _device_of(value) -> Optional[torch.device]:
    if torch.is_tensor(value):
        return value.device
    if isinstance(value, torch.nn.Module):
        t = next(iter(value.parameters()), None)
        t = t if t is not None else next(iter(value.buffers()), None)
        return None if t is None else t.device
    return None


def _place(value, device: torch.device):
    if isinstance(value, (list, tuple)):
        return type(value)(_place(v, device) for v in value)
    if isinstance(value, torch.nn.Module):
        return value if _device_of(value) == device else copy.deepcopy(value).to(device)
    if torch.is_tensor(value) or hasattr(value, "to"):
        return value.to(device)
    return value


def column_sharding(mesh: Mesh, ndim: int, gpt_axis: Optional[int] = None) -> ColumnSharding:
    """Axis 0 = columns over the mesh's 'col' axis; ``gpt_axis`` (a
    process-group mesh only) over 'gpt'."""
    if gpt_axis is not None and mesh.ranks is None:
        raise NotImplementedError(f"column_sharding(gpt_axis={gpt_axis}): {_GPT_SPLIT}")
    return ColumnSharding(mesh, ndim, gpt_axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_columns(tree, mesh: Mesh, gpt_minor: bool = False):
    """Put every column-leading array of ``tree`` (dicts, lists and tuples
    are walked) on the mesh: each leaf becomes a tuple of its shares, one
    tensor per device in column order (``torch.cat`` joins them again);
    0-d leaves become one copy per device. On a process-group mesh each
    leaf becomes this rank's block (with ``gpt_minor`` the last axis of a
    leaf of 2 or more dimensions split over 'gpt'), a 0-d leaf its copy."""
    if gpt_minor and mesh.ranks is None:
        raise NotImplementedError(f"shard_columns(gpt_minor=True): {_GPT_SPLIT}")

    def put(x):
        if mesh.ranks is not None:
            if x.ndim == 0:
                return x.to(mesh.devices[0])
            gpt_axis = x.ndim - 1 if gpt_minor and x.ndim >= 2 else None
            return column_sharding(mesh, x.ndim, gpt_axis).local(x)
        if x.ndim == 0:
            return tuple(x.to(d) for d in mesh.devices)
        return tuple(x[s:s + n].to(d) for d, s, n in column_sharding(mesh, x.ndim).split(x.shape[0]))

    return _map_leaves(tree, put)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree if torch.is_tensor(tree) else torch.as_tensor(np.asarray(tree)))


def pad_to_multiple(tree, multiple: int):
    """Pad the leading (column) axis of every array of ``tree`` to a
    multiple of ``multiple`` by repeating the last column, so the column
    count divides the mesh. Returns (padded tree, original ncol)."""
    leaves = _leaves(tree)
    ncol = np.shape(leaves[0])[0]
    pad = (-ncol) % multiple

    def padfn(x):
        if isinstance(x, dict):
            return {k: padfn(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(padfn(v) for v in x)
        if pad == 0 or np.ndim(x) == 0:
            return x
        return np.pad(np.asarray(x), [(0, pad)] + [(0, 0)] * (np.ndim(x) - 1), mode="edge")

    return padfn(tree), ncol


def _leaves(tree) -> Sequence:
    if isinstance(tree, dict):  # in sorted key order, as jax.tree_util
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]
