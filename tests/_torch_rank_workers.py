"""What each rank runs in the port's multi-process tests (spawned by
parallel.distributed.launch on two gloo ranks, on the CPU or sharing the
card). No JAX here: the test processes hold the JAX references, the ranks
only the port."""
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
