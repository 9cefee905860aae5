"""Multi-process dry run of the PyTorch port on a ('col', 'gpt') mesh of ranks.

The counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` on
``torch.distributed``, in three stages on a synthetic RFMIP-like block
(``testing.synthesize_rfmip``) and the in-repo g-128 LW demo net:

  1. a full training step (training/train.py, Adam, MSE) with the batch
     split over all ranks; the gradients are averaged by ``all_reduce``,
     and the loss is finite and the same on every rank;
  2. the staged LW forward split over 'col' x 'gpt': each rank takes its
     columns and computes its g-points only (the last layer's output
     columns of its g-points, tau and Planck fraction), then its Planck
     sources and the transport (on CUDA K3, then K7) over those g-points;
     the broadband flux is an ``all_reduce(SUM)`` over the 'gpt' group;
  3. the fused LW core split over 'col' (``lw_mega_core_sharded``, K1 on
     CUDA), held against stage 2's broadband within LW_ATOL.

Run it on N ranks that it spawns itself, or under torchrun:

    python scripts/torch_dryrun_multichip.py --nproc 2 --device cpu   # gloo
    python scripts/torch_dryrun_multichip.py --nproc 2                # the card(s)
    torchrun --nproc_per_node 4 scripts/torch_dryrun_multichip.py

CUDA ranks use NCCL with one rank per card and gloo when ranks share a card
(``parallel.distributed.initialize`` decides).
The mesh has n_gpt = 2 for an even number of ranks, else 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
import torch.distributed as dist

from rte_rrtmgp_nn_tpu_torch.parallel import distributed

HERE = os.path.dirname(os.path.abspath(__file__))
LW_MODEL = os.path.join(HERE, "..", "artifacts",
                        "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
LW_ATOL = 2e-3  # W/m2, the JAX package's bound of the fused core against the staged one


def gpt_block_model(model, start: int, stop: int):
    """The "lw_both" net restricted to g-points [start, stop): the last
    layer's output columns of those g-points' tau and Planck fraction (an
    output-feature split of the last matrix product)."""
    from rte_rrtmgp_nn_tpu_torch.models.network import NNModel

    ngpt = model.weights[-1].shape[1] // 2
    idx = torch.cat([torch.arange(start, stop), torch.arange(ngpt + start, ngpt + stop)])
    idx = idx.to(model.weights[-1].device)
    return NNModel(list(model.weights[:-1]) + [model.weights[-1][:, idx]],
                   list(model.biases[:-1]) + [model.biases[-1][idx]], model.activations,
                   model.input_names, model.input_min, model.input_max,
                   model.output_mean[idx], model.output_std[idx])


def mesh_shape(world: int) -> tuple[int, int]:
    n_gpt = 2 if world % 2 == 0 and world > 1 else 1
    return world // n_gpt, n_gpt


def train_stage(mesh, dev) -> dict:
    """Stage 1: one Adam step on the batch split over every rank, the
    gradients averaged by all_reduce. Returns the loss, every rank's loss
    and the updated weights."""
    from rte_rrtmgp_nn_tpu_torch.training.train import (
        create_train_state, init_model, make_train_step)

    world, rank = dist.get_world_size(), dist.get_rank()
    model = init_model([18, 16, 16, 32], torch.Generator().manual_seed(0), device=dev)
    state, _ = create_train_state(model)
    inner = state.optimizer

    class Averaged:
        """The optimizer with the gradients averaged over the ranks first."""

        def zero_grad(self, set_to_none=True):
            inner.zero_grad(set_to_none=set_to_none)

        def step(self):
            for p in model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad)
                    p.grad /= world
            inner.step()

    state.optimizer = Averaged()
    rng = np.random.default_rng(0)
    nbatch = 8 * world
    x = torch.as_tensor(rng.normal(size=(nbatch, 18)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(nbatch, 32)), dtype=torch.float32)
    rows = slice(8 * rank, 8 * (rank + 1))
    state, loss = make_train_step()(state, x[rows].to(dev), y[rows].to(dev))
    dist.all_reduce(loss)
    loss = loss / world
    losses = [torch.zeros_like(loss) for _ in range(world)]
    dist.all_gather(losses, loss)
    return {"loss": float(loss), "losses": [float(v) for v in losses],
            "weights": [w.detach().cpu().numpy() for w in model.weights]}


def forward_stages(mesh, dev, ncol: int, nlay: int) -> dict:
    """Stages 2 and 3 on this rank's columns: the g-point-split staged LW
    broadband (all_reduce over 'gpt') and the fused core split over 'col'."""
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import gas_optics_lw_nn
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
        PlanckTable, lw_spectral_g128, spectral_for)
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalProps1scl
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding
    from rte_rrtmgp_nn_tpu_torch.rte import rte_lw
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, 0))
    model = load_model_netcdf(LW_MODEL, device=dev)
    spec = spectral_for("lw", [model], entry="torch_dryrun_multichip.py",
                        accepts=(lw_spectral_g128,))
    table = PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    ((_, c0, nc),) = column_sharding(mesh, 2).split(ncol)
    g0, ng = column_sharding(mesh, 3, gpt_axis=2).gpt_slice(spec.ngpt)

    # ---- 2. staged forward, columns over 'col', g-points over 'gpt' ----
    sub, sub_spec = gpt_block_model(model, g0, g0 + ng), spec.gpt_subset(g0, g0 + ng)
    block = data.block(c0, nc)
    play, plev, tlay, tlev, tsfc, emis, concs = rfmip.lw_staged_inputs(block, spec, dev)
    with torch.no_grad():
        tau, sources = gas_optics_lw_nn([sub], play, plev, tlay, tsfc, GasConcs(concs), sub_spec,
                                        table, tlev=tlev, top_at_1=data.top_at_1)
        sol = rte_lw(OpticalProps1scl(tau, sub_spec), data.top_at_1, sources, emis,
                     broadband=True)
    up, dn = sol.flux_up.contiguous(), sol.flux_dn.contiguous()
    group = mesh.ranks.gpt_group
    if mesh.ranks.n_gpt > 1:
        dist.all_reduce(up, group=group)
        dist.all_reduce(dn, group=group)

    # ---- 3. the fused core over 'col' ----
    core = rfmip.lw_mega_core_sharded(mesh, [model], table, spec, data.top_at_1)
    with torch.no_grad():
        up_m, dn_m = core(*rfmip.lw_canonical_inputs(block, spec, dev))
    err = max(float((up_m - up).abs().max()), float((dn_m - dn).abs().max()))
    return {"cols": (c0, nc), "gpts": (g0, ng), "up": up.cpu().numpy(), "dn": dn.cpu().numpy(),
            "up_mega": up_m.cpu().numpy(), "dn_mega": dn_m.cpu().numpy(), "mega_err": err}


def rank_main(ncol: int = 0, nlay: int = 60) -> dict:
    """The three stages on this rank of an initialized process group.
    Raises when a stage fails its check."""
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import make_mesh

    world = dist.get_world_size()
    n_col, n_gpt = mesh_shape(world)
    mesh = make_mesh(n_col=n_col, n_gpt=n_gpt)
    dev = mesh.devices[0]
    out = {"rank": dist.get_rank(), "mesh": mesh.shape, "device": str(dev)}
    t0 = time.perf_counter()
    out.update(train_stage(mesh, dev))
    if not (np.isfinite(out["loss"]) and len(set(out["losses"])) == 1):
        raise RuntimeError(f"stage 1: the loss is not finite or differs by rank: {out['losses']}")
    t1 = time.perf_counter()
    out.update(forward_stages(mesh, dev, ncol or 4 * n_col, nlay))
    out["stage_s"] = (t1 - t0, time.perf_counter() - t1)
    if not (np.isfinite(out["dn"]).all() and out["mega_err"] <= LW_ATOL):
        raise RuntimeError(f"stage 3: the fused core is {out['mega_err']:.3e} W/m2 from the "
                           f"g-point-split staged forward (bound {LW_ATOL})")
    return out


def report(results) -> str:
    r0 = results[0]
    mean_dn = np.mean(np.concatenate([r["dn"] for r in results if r["gpts"][0] == 0]))
    mean_m = np.mean(np.concatenate([r["dn_mega"] for r in results if r["gpts"][0] == 0]))
    return (f"dryrun_multichip OK: mesh {r0['mesh']} on {r0['device']}, train loss "
            f"{r0['loss']:.4f}, mean flux_dn {mean_dn:.3f}, mega-sharded flux_dn {mean_m:.3f}, "
            f"max |mega - staged| {max(r['mega_err'] for r in results):.3e} W/m2")


def run(nproc: int, device=None, ncol: int = 0, nlay: int = 60) -> list:
    """Spawn ``nproc`` ranks (on the cards unless ``device`` is "cpu") and
    run the three stages; the ranks' results in rank order."""
    return distributed.launch(rank_main, nproc, ncol, nlay, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2, help="ranks to spawn (not under torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ncol", type=int, default=0, help="columns (default 4 x the 'col' ranks)")
    ap.add_argument("--nlay", type=int, default=60)
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        distributed.initialize(device=args.device)
        out = rank_main(args.ncol, args.nlay)
        results = [None] * dist.get_world_size()
        dist.all_gather_object(results, out)
        if dist.get_rank() == 0:
            print(report(results))
        dist.destroy_process_group()
        return 0
    print(report(run(args.nproc, args.device, args.ncol, args.nlay)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
