"""Vertical affine recurrences (port of rte_rrtmgp_nn_tpu/ops/scan.py).

The RTE transports are per-column recurrences over layers (reference
mo_rte_solver_kernels.F90 lw_transport_noscat_dn/up, adding). The
``sequential`` mode is a Python loop over layers with (ncol, ngpt)
elements; the ``parallel`` mode composes the layers' affine maps in
log2(nlay) levels (``associative_scan``), about twice the arithmetic in
far fewer, larger steps.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def associative_scan(combine: Callable, elems: Sequence[torch.Tensor], axis: int = 0,
                     reverse: bool = False) -> tuple:
    """Inclusive scan of the tensors ``elems`` along ``axis`` under the
    associative ``combine(a, b) -> c`` (tuples of tensors; a precedes b).
    The even/odd recursion of jax.lax.associative_scan, so the products
    are grouped as there: pairs are combined, the half-length sequence is
    scanned, and the even positions are filled in from it. With
    ``reverse`` the scan runs from the end (suffix combinations; combine's
    first argument is then the accumulated suffix)."""
    elems = [e.movedim(axis, 0) for e in elems]
    if reverse:
        elems = [e.flip(0) for e in elems]

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        reduced = combine([x[0:n - 1:2] for x in xs], [x[1::2] for x in xs])
        odd = scan(list(reduced))
        if n % 2 == 0:
            even = combine([o[:-1] for o in odd], [x[2::2] for x in xs])
        else:
            even = combine(odd, [x[2::2] for x in xs])
        out = []
        for x, ev, od in zip(xs, even, odd):
            full = x.new_empty(x.shape)
            full[0] = x[0]
            full[2::2] = ev
            full[1::2] = od
            out.append(full)
        return out

    out = scan(elems)
    if reverse:
        out = [o.flip(0) for o in out]
    return tuple(o.movedim(0, axis) for o in out)


def _affine_compose(a, b):
    """The affine map b after a: x -> tb * (ta * x + sa) + sb."""
    ta, sa = a
    tb, sb = b
    return ta * tb, tb * sa + sb


def affine_scan(trans: torch.Tensor, source: torch.Tensor, r0: torch.Tensor,
                axis: int = 1, mode: str = "sequential") -> torch.Tensor:
    """Solve r[k+1] = trans[k] * r[k] + source[k] along ``axis``; r0 has
    the shape of trans without ``axis``. Returns r with nlay+1 entries
    along ``axis`` (r[0] = r0)."""
    t, s = trans.movedim(axis, 0), source.movedim(axis, 0)
    if mode == "sequential":
        out = [r0]
        for k in range(t.shape[0]):
            out.append(t[k] * out[-1] + s[k])
        return torch.stack(out, dim=axis)
    if mode == "parallel":
        pt, ps = associative_scan(_affine_compose, (t, s), axis=0)
        return torch.cat([r0[None], pt * r0[None] + ps], dim=0).movedim(0, axis)
    raise ValueError(f"unknown scan mode {mode!r}")


def affine_scan_reverse(trans: torch.Tensor, source: torch.Tensor, r_last: torch.Tensor,
                        axis: int = 1, mode: str = "sequential") -> torch.Tensor:
    """Solve r[k] = trans[k] * r[k+1] + source[k] (the upward sweep).
    Returns r with nlay+1 entries along ``axis`` (r[nlay] = r_last)."""
    if mode == "sequential":
        t, s = trans.movedim(axis, 0), source.movedim(axis, 0)
        out = [r_last]
        for k in range(t.shape[0] - 1, -1, -1):
            out.append(t[k] * out[-1] + s[k])
        return torch.stack(out[::-1], dim=axis)
    return affine_scan(trans.flip(axis), source.flip(axis), r_last, axis=axis,
                       mode=mode).flip(axis)
