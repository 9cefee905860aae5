"""Per-device column programs and distributed metric reductions over a
device mesh.

Port of rte_rrtmgp_nn_tpu/parallel/shard_ops.py. There, ``shard_map``
bodies run on each device of a mesh and psum/pmin/pmax trees reduce their
results. Here the mesh is parallel/sharding's ``Mesh``, a list of devices
that share the columns: each device runs the body on its share, and what
JAX reduces with a psum is a float32 partial sum per device, brought to the
mesh's first device and added there (min and max likewise). Two uses, as in
the JAX package:

  - column-local solves: ``columnwise_shard_map`` runs a column-batched
    function on each device's share only, so nothing in it crosses devices;
  - distributed flux statistics: the reference's host-side accuracy
    summaries (rrtmgp_rfmip_lw.F90 mean-flux prints, the eval driver's 8
    metrics) as partial sums per device, never gathering the flux fields.

On a process-group mesh (parallel/distributed) each rank holds its own
block of columns (or sites), reduces it to the same float32 partial sums,
and ``all_reduce`` over the ranks of its 'col' axis combines them: every
rank gets the result.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..constants import constants
from .sharding import Mesh, column_sharding

# Experiment pairs for the RFMIP forcing metrics (0-based indices into the
# experiment axis; reference rrtmgp_lw_eval_nn_rfmip.F90:452-577 uses
# 1-based iref/iexp (1,2), (4,1), (4,2), (1,11), (1,10)).
RF_PAIRS_TOA = ((0, 1), (3, 0))
RF_PAIRS_SFC = ((3, 1), (0, 10), (0, 9))


def _shares(mesh: Mesh, x, axis: int = 0) -> list[torch.Tensor]:
    """``x`` split along ``axis`` over the mesh's devices in order (the
    shares parallel/sharding's column split gives), each on its device; a
    list or tuple is taken as the shares already placed."""
    if isinstance(x, (list, tuple)):
        return list(x)
    x = torch.as_tensor(x)
    return [x.narrow(axis, s, n).to(d)
            for d, s, n in column_sharding(mesh, x.ndim).split(x.shape[axis])]


def _join(outs: Sequence, device: torch.device):
    """The per-device results of a column program joined in column order on
    ``device``: tensors concatenated along axis 0; tuples, lists and dicts
    walked."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _join([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([o[i] for o in outs], device) for i in range(len(first)))
    return torch.cat([o.to(device) for o in outs], dim=0)


def columnwise_shard_map(mesh: Mesh, fn: Callable, n_array_args: int) -> Callable:
    """Wrap a column-batched function so each device runs it on its own
    column share only (nothing in ``fn`` crosses devices).

    fn: a function of ``n_array_args`` column-leading tensors returning a
    tensor or a tuple, list or dict of column-leading tensors. All other
    state (models, tables, spectral metadata) must already be in ``fn`` and
    on the device of the share it is called with. The wrapped function
    takes the whole arrays (or their shares, as lists) and returns the
    results joined in column order on the mesh's first device."""

    def run(*args):
        if len(args) != n_array_args:
            raise TypeError(f"columnwise_shard_map: {len(args)} arrays, expected {n_array_args}")
        shares = [_shares(mesh, a) for a in args]
        outs = [fn(*parts) for parts in zip(*shares)]
        return _join(outs, mesh.devices[0])

    return run


def _psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The per-device partial results added on ``device`` (psum)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` combined over the ranks of this rank's 'col' axis (in place)."""
    dist.all_reduce(t, op=op, group=mesh.ranks.col_group)
    return t


def _extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """max or min of ``x``; -inf / +inf for a rank with no columns."""
    if x.numel() == 0:
        return torch.tensor(-float("inf") if largest else float("inf"), dtype=x.dtype,
                            device=x.device)
    return x.max() if largest else x.min()


def flux_stats(mesh: Mesh, flux):
    """Global (mean, min, max) of a column-sharded flux array without
    gathering it: each device reduces its share (float32 sum, size, min,
    max) and the partial results meet on the mesh's first device. Returns
    0-d tensors there. On a process-group mesh ``flux`` is this rank's
    block of columns and every rank gets the global values.

    The equivalent of the reference's host-side summary statistics (e.g.
    the mean-flux prints, rrtmgp_rfmip_lw.F90:479-487) at pod scale."""
    if mesh.ranks is not None:
        x = torch.as_tensor(flux)
        sc = _all_reduce(torch.stack([torch.sum(x, dtype=torch.float32),
                                      torch.tensor(float(x.numel()), device=x.device)]), mesh)
        lo = _all_reduce(_extreme(x, False), mesh, dist.ReduceOp.MIN)
        hi = _all_reduce(_extreme(x, True), mesh, dist.ReduceOp.MAX)
        return sc[0] / sc[1], lo, hi
    home = mesh.devices[0]
    shares = _shares(mesh, flux)
    total = _psum([torch.sum(x, dtype=torch.float32) for x in shares], home)
    count = _psum([torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
                   for x in shares], home)
    lo = torch.stack([x.min().to(home) for x in shares]).min()
    hi = torch.stack([x.max().to(home) for x in shares]).max()
    return total / count, lo, hi


def _hr_kday(up, dn, plev):
    net = dn - up
    dnet = net[..., 1:] - net[..., :-1]
    dp = plev[..., 1:] - plev[..., :-1]
    return constants.grav / constants.cp_dry * dnet / dp * 86400.0


def _metric_partials(flux_up, flux_dn, ref_up, ref_dn, plev, top_at_1: bool):
    """Float32 partial sums of one site block (nexp, nsites_local, nlev):
    (sums, per_exp, counts). ``sums``: the weighted heating-rate MAE over
    all experiments and over experiment 0, and the TOA upwelling bias;
    ``per_exp`` (2, nexp): per experiment the summed TOA upwelling bias and
    surface downwelling bias against the reference. What the JAX core
    psums, one block's share."""
    f32 = torch.float32
    toa = 0 if top_at_1 else -1
    sfc = -1 if top_at_1 else 0
    hr = _hr_kday(flux_up, flux_dn, plev)
    hr_ref = _hr_kday(ref_up, ref_dn, plev)
    dp = torch.abs(plev[..., 1:] - plev[..., :-1])
    w = dp / torch.sum(dp, dim=-1, keepdim=True)
    wmae = torch.sum(w * torch.abs(hr - hr_ref), dim=-1)  # (nexp, nsites)
    d_toa = flux_up[..., toa] - ref_up[..., toa]
    d_sfc = flux_dn[..., sfc] - ref_dn[..., sfc]
    s = lambda x: torch.sum(x, dtype=f32)
    sums = torch.stack([s(wmae), s(wmae[0]), s(d_toa)])
    per_exp = torch.stack([torch.sum(d, dim=1, dtype=f32) for d in (d_toa, d_sfc)])
    nexp, nsites = flux_up.shape[:2]
    counts = torch.tensor([nexp * nsites, nsites, nexp * nsites], dtype=f32,
                          device=flux_up.device)
    return sums, per_exp, counts


def _metrics_from_partials(sums, per_exp, counts) -> torch.Tensor:
    """The 8 metrics from the (mesh-wide) partial sums. A forcing bias is
    the JAX core's ``ref - cand``, a difference of differences of global
    means, taken here as the difference of the two experiments' mean
    biases, which is the same sum regrouped: float32 means of fluxes near
    250 W/m2 keep about 1e-5 W/m2, and their differences lose it to
    cancellation (measured 3e-5 W/m2 against float64), while the biases are
    small numbers whose means keep it."""
    nexp = per_exp.shape[1]
    bias_toa, bias_sfc = per_exp / counts[1]
    zero = torch.zeros((), dtype=torch.float32, device=sums.device)

    def rf_toa(iref, iexp):
        # ref - cand = -(R_e - R_r) + (U_e - U_r)
        return zero if max(iref, iexp) >= nexp else bias_toa[iexp] - bias_toa[iref]

    def rf_sfc(iref, iexp):
        # ref - cand = (RD_r - RD_e) - (D_r - D_e)
        return zero if max(iref, iexp) >= nexp else bias_sfc[iexp] - bias_sfc[iref]

    m = sums / counts
    return torch.stack([
        m[0], m[1], m[2],
        rf_toa(*RF_PAIRS_TOA[0]), rf_toa(*RF_PAIRS_TOA[1]),
        rf_sfc(*RF_PAIRS_SFC[0]), rf_sfc(*RF_PAIRS_SFC[1]), rf_sfc(*RF_PAIRS_SFC[2]),
    ])


def rfmip_eval_metrics_core(flux_up, flux_dn, ref_up, ref_dn, plev, top_at_1: bool = True):
    """The reference eval driver's 8 scalar error metrics as one device-side
    reduction: the single numerics source of the single-device eval loop
    (training/eval_loop.eval_metrics) and the mesh path
    (rfmip_eval_metrics_sharded below), which adds the same partial sums
    over devices.

    Arrays are (nexp, nsites, nlev), experiment-major, so that splitting the
    SITES axis keeps every forcing pair on each device. Metrics (reference
    rrtmgp_lw_eval_nn_rfmip.F90:452-577): pressure-weighted heating-rate
    MAE (all experiments / present-day), TOA upwelling bias, two TOA
    forcing biases, three surface forcing biases. Pairs missing from a
    smaller experiment axis give 0. Means are float32 sums over float32
    counts, as in the JAX core; the forcing biases are regrouped
    (_metrics_from_partials), so they are the JAX core's to its float32
    rounding. Returns an (8,) float32 tensor."""
    sums, per_exp, counts = _metric_partials(flux_up, flux_dn, ref_up, ref_dn, plev, top_at_1)
    return _metrics_from_partials(sums, per_exp, counts)


def rfmip_eval_metrics_sharded(mesh: Mesh, flux_up, flux_dn, ref_up, ref_dn, plev,
                               top_at_1: bool = True) -> torch.Tensor:
    """The 8 metrics with the SITES axis of the (nexp, nsites, nlev) arrays
    split over the mesh: every device reduces its site block to the core's
    partial sums, which are added on the mesh's first device and combined
    there. Numerically rfmip_eval_metrics_core's result (the same partial
    sums, added per device first). Arrays may be given whole or as lists
    of their site shares, one per device. On a process-group mesh they are
    this rank's site block, and ``all_reduce`` adds the partial sums."""
    if mesh.ranks is not None:
        sums, per_exp, counts = _metric_partials(flux_up, flux_dn, ref_up, ref_dn, plev,
                                                 top_at_1)
        ns, ne = sums.numel(), per_exp.numel()
        flat = _all_reduce(torch.cat([sums, per_exp.flatten(), counts]), mesh)
        return _metrics_from_partials(flat[:ns], flat[ns:ns + ne].view(per_exp.shape),
                                      flat[ns + ne:])
    home = mesh.devices[0]
    shares = [_shares(mesh, a, axis=1) for a in (flux_up, flux_dn, ref_up, ref_dn, plev)]
    parts = [_metric_partials(*block, top_at_1) for block in zip(*shares)]
    sums, per_exp, counts = (_psum([p[k] for p in parts], home) for k in range(3))
    return _metrics_from_partials(sums, per_exp, counts)


def weighted_error_stats(mesh: Mesh, flux, ref):
    """Distributed (MAE, RMSE, max-abs-err) between a computed and a
    reference flux field, both column-sharded: float32 partial sums of
    |d| and d*d and the local max |d| per device, met on the mesh's first
    device. The distributed form of the eval-loop accuracy metrics
    (training/eval_loop.METRIC_NAMES). On a process-group mesh ``flux`` and
    ``ref`` are this rank's blocks and every rank gets the global values."""
    if mesh.ranks is not None:
        d = (torch.as_tensor(flux) - torch.as_tensor(ref)).to(torch.float32)
        n, sae, sse = _all_reduce(torch.stack([torch.tensor(float(d.numel()), device=d.device),
                                               torch.sum(torch.abs(d)), torch.sum(d * d)]), mesh)
        mx = _all_reduce(_extreme(torch.abs(d), True), mesh, dist.ReduceOp.MAX)
        return sae / n, torch.sqrt(sse / n), mx
    home = mesh.devices[0]
    ds = [(x - r).to(torch.float32) for x, r in zip(_shares(mesh, flux), _shares(mesh, ref))]
    n, sae, sse = _psum([torch.stack([torch.tensor(float(d.numel()), device=d.device),
                                      torch.sum(torch.abs(d)), torch.sum(d * d)]) for d in ds],
                        home)
    mx = torch.stack([torch.max(torch.abs(d)).to(home) for d in ds]).max()
    return sae / n, torch.sqrt(sse / n), mx
