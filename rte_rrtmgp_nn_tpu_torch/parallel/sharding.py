"""Column splitting over a list of devices.

Port of rte_rrtmgp_nn_tpu/parallel/sharding.py. Columns are independent
(no halo), so a block of columns is split over the mesh's devices in
order, each device solves its share, and the shares' results are joined
in column order. One H100 is a mesh of one.

The JAX package can also split the g-points over a second mesh axis
('gpt'), where XLA inserts the collective for the broadband sum. In one
process here there is no such collective: a mesh with more than one
g-point shard, and any g-point split, is refused. It comes with the
multi-process part of the parallel package (``torch.distributed``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

_GPT_SPLIT = ("a split of the g-points over devices needs a collective for the broadband "
              "sum; it comes with the multi-process part of the parallel package "
              "(torch.distributed), which is not in the port yet")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('col', 'gpt') device mesh whose 'gpt' axis has size 1: the
    devices that share the columns, in column order."""

    devices: tuple  # of torch.device

    axis_names = ("col", "gpt")

    @property
    def shape(self) -> dict:
        return {"col": len(self.devices), "gpt": 1}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_col: Optional[int] = None, n_gpt: int = 1, devices=None) -> Mesh:
    """A mesh of ``n_col`` devices on the column axis (default: all of
    ``devices``). ``devices`` defaults to every CUDA device; with none
    present this raises, it does not fall back to the CPU (pass
    ``devices=["cpu", ...]`` for that)."""
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


@dataclasses.dataclass(frozen=True)
class ColumnSharding:
    """Axis 0 (columns) of ``ndim``-dimensional arrays split over the
    mesh's devices in order, in shares of ceil(ncol / ndevices)."""

    mesh: Mesh
    ndim: int

    def split(self, ncol: int) -> list[tuple[torch.device, int, int]]:
        """(device, start, size) of each non-empty share of ``ncol``
        columns, in column order."""
        per = -(-ncol // self.mesh.size)
        return [(d, s, min(per, ncol - s))
                for d, s in zip(self.mesh.devices, range(0, ncol, per))] if ncol else []


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
    """Axis 0 = columns over the mesh's devices."""
    if gpt_axis is not None:
        raise NotImplementedError(f"column_sharding(gpt_axis={gpt_axis}): {_GPT_SPLIT}")
    return ColumnSharding(mesh, ndim)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_columns(tree, mesh: Mesh, gpt_minor: bool = False):
    """Put every column-leading array of ``tree`` (dicts, lists and tuples
    are walked) on the mesh: each leaf becomes a tuple of its shares, one
    tensor per device in column order (``torch.cat`` joins them again);
    0-d leaves become one copy per device."""
    if gpt_minor:
        raise NotImplementedError(f"shard_columns(gpt_minor=True): {_GPT_SPLIT}")

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if x.ndim == 0:
            return tuple(x.to(d) for d in mesh.devices)
        return tuple(x[s:s + n].to(d) for d, s, n in column_sharding(mesh, x.ndim).split(x.shape[0]))

    return put(tree)


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
