"""What each rank runs in the port's multi-process tests (spawned by
parallel.distributed.launch, or set up and stepped by
parallel.distributed.RankGroup, on two gloo ranks, on the CPU or sharing
the card). No JAX here: the test processes hold the JAX references, the ranks
only the port."""
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def mesh_and_stats(x, y, fields, top_at_1):
    """The process-group mesh and the all_reduce statistics on this rank's
    blocks of the whole arrays ``x``, ``y`` (columns) and ``fields``
    (nexp, nsites, nlev: sites)."""
    from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pd
    from rte_rrtmgp_nn_tpu_torch.parallel import shard_ops as pso
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding, make_mesh, shard_columns

    mesh = pd.global_mesh()
    ((_, s, n),) = column_sharding(mesh, 2).split(x.shape[0])
    xl, yl = torch.as_tensor(x[s:s + n]), torch.as_tensor(y[s:s + n])
    stats = [float(v) for v in pso.flux_stats(mesh, xl)]
    errs = [float(v) for v in pso.weighted_error_stats(mesh, yl, xl)]
    nsites = fields[0].shape[1]
    ((_, s2, n2),) = column_sharding(mesh, 2).split(nsites)
    local = [torch.as_tensor(f[:, s2:s2 + n2]) for f in fields]
    metrics = pso.rfmip_eval_metrics_sharded(mesh, *local, top_at_1=top_at_1).numpy()
    gpt_mesh = make_mesh(n_col=1, n_gpt=2)
    tau = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    blocks = shard_columns({"tau": tau, "s": np.float32(2.0)}, gpt_mesh, gpt_minor=True)
    try:
        make_mesh(n_col=3)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"rank": dist.get_rank(), "mesh": mesh.shape, "slice": pd.local_column_slice(11),
            "split": (s, n), "stats": stats, "errs": errs, "metrics": metrics,
            "tau_block": blocks["tau"].numpy(), "s": float(blocks["s"]), "refused": refused,
            "gpt_shape": gpt_mesh.shape}


def gpt_split_solve(tau, lay, lev, emis, sfc):
    """The broadband no-scattering LW solve on this rank's g-points of a
    1 x 2 ('col', 'gpt') mesh, summed over 'gpt' by all_reduce (the port of
    the JAX package's g-point-sharded test)."""
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_solver_noscat
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import make_mesh, shard_columns

    mesh = make_mesh(n_col=1, n_gpt=2)
    a = shard_columns(tuple(map(np.asarray, (tau, lay, lev, emis, sfc))), mesh, gpt_minor=True)
    sol = lw_solver_noscat(*a, broadband=True)
    up, dn = sol.flux_up.contiguous(), sol.flux_dn.contiguous()
    dist.all_reduce(up, group=mesh.ranks.gpt_group)
    dist.all_reduce(dn, group=mesh.ranks.gpt_group)
    return up.numpy(), dn.numpy()


def sharded_cores(arrays, lw_path, sw_path):
    """The sharded fused LW and SW cores on this rank's block of the
    RFMIP-like ``arrays`` (its share under ``column_sharding``): the
    block's fluxes and the gathered whole, both cores, and on the card the
    K1 and K2 launches of the four calls."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, sw_spectral_g112)
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.parallel.distributed import global_mesh
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    mesh = global_mesh()
    dev = mesh.devices[0]
    data = rfmip_data_from_arrays(arrays)
    ((_, c0, nc),) = column_sharding(mesh, 2).split(data.ncol)
    block = data.block(c0, nc)
    lw = load_model_netcdf(lw_path, device=dev)
    sw = load_model_netcdf(sw_path, device=dev)
    spec, sspec = lw_spectral_g128(), sw_spectral_g112()
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32, device=dev)
    lw_fn = rfmip.lw_mega_core_sharded(mesh, [lw], table, spec, data.top_at_1)
    sw_fn = rfmip.sw_mega_core_sharded(mesh, [sw, sw], sspec, solar, data.top_at_1)
    li, si = rfmip.lw_canonical_inputs(block, spec, dev), rfmip.sw_canonical_inputs(block, dev)
    calls = {}
    k1.LAUNCHES = k2.LAUNCHES = 0
    with torch.no_grad():
        for name, fn, args in (("lw", lw_fn, li), ("sw", sw_fn, si)):
            calls[name] = [t.cpu().numpy() for t in fn(*args)]
            calls[name + "_all"] = [t.cpu().numpy() for t in fn(*args, gather=True)]
    return {"rank": dist.get_rank(), "device": str(dev), **calls, "k1": k1.LAUNCHES,
            "k2": k2.LAUNCHES}


# A RankGroup's ranks (parallel.distributed.RankGroup): make(rank, device)
# once a rank, then fn(state, *args) a step.
MADE = []


def counting_make(rank, device):
    """Counts the set-ups of this process."""
    MADE.append(rank)
    return {"rank": rank, "steps": 0, "pid": os.getpid()}


def counting_step(state, what="count"):
    """[rank, set-ups of this process, steps of this state, pid, intra-op
    threads, then the allowed cores, -1 beyond them]; ``what``: "raise" or
    "stall" make rank 1 raise or stall."""
    if state["rank"] == 1 and what == "raise":
        raise RuntimeError("a fault planted in rank 1")
    if state["rank"] == 1 and what == "stall":
        time.sleep(600)
    state["steps"] += 1
    cores = sorted(os.sched_getaffinity(0))
    out = np.full(5 + os.cpu_count(), -1.0, np.float32)
    out[:5] = (state["rank"], len(MADE), state["steps"], state["pid"], torch.get_num_threads())
    out[5:5 + len(cores)] = cores
    return out


def failing_make(rank, device):
    if rank == 1:
        raise RuntimeError("a set-up fault planted in rank 1")
    return counting_make(rank, device)


def binding():
    """This rank's intra-op threads and allowed cores."""
    return torch.get_num_threads(), sorted(os.sched_getaffinity(0))


def gcm_make(rank, device, cloud_files, ncol, nlay):
    """A GCM rank's set-up: the 64-wide LW net and the SW demo net, the
    lookup-table cloud optics of ``cloud_files`` (lw, sw), and ``ncol``
    columns of its own (seed: the rank)."""
    from rte_rrtmgp_nn_tpu_torch import testing as T
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked
    from rte_rrtmgp_nn_tpu_torch.drivers.gcm import synthesize_gcm_columns
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    data = rfmip_data_from_arrays(T.synthesize_rfmip(24, nlay, seed=rank))
    return {"host": synthesize_gcm_columns(data, ncol, seed=rank),
            "lw": load_model_netcdf(T.artifact_path(T.LW_NET_64), device=device),
            "sw": load_model_netcdf(T.artifact_path(
                "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc"), device=device),
            "co": [load_cloud_optics_checked(p, device=device) for p in cloud_files],
            "device": device}


def gcm_step(state, block):
    """The rank's all-sky sweep in blocks of ``block``: its (ncol, 3)
    diagnostics."""
    from rte_rrtmgp_nn_tpu_torch.drivers.gcm import gcm_sweep_allsky

    with torch.no_grad():
        r = gcm_sweep_allsky(state["host"], [state["lw"]], [state["sw"], state["sw"]],
                             *state["co"], block_size=block, precision="f32",
                             device=state["device"])
    return r["diagnostics"]
