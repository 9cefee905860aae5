"""The reference SW training loop from LUT-generated data, on the PyTorch port.

The counterpart of scripts/train_from_lut_sw.py (the recipe of the shipped
``artifacts/sw-synth56-lut_{absorption,rayleigh}_*.nc`` pairs), with the
same steps and flags:

1. synthesize a SW k-distribution (gasoptics/synthetic.py: 14 bands x 4
   g-points by default, 56 g-points),
2. run the LUT gas optics + the SW two-stream RTE over the RFMIP-style
   problem and write the training file (training/gendata.py), read both
   predictands back through the training loader,
3. train fresh absorption and Rayleigh MLPs jointly (one batch, two losses,
   an Adam with cosine decay each) with the reference predictand scalings
   and the hybrid expdiff forcing loss,
4. evaluate each epoch by running the SW radiation of the whole problem
   with the pair against the LUT's own fluxes, day-masked (night columns
   zero on both sides): on CUDA the MLP kernel's SW epilogue (K5), then
   ``rte_sw``; 8 metrics -> radiation score, early stopping,
5. save both best models in the reference netCDF format with the
   score-encoded filename and the metric vector as attributes.

The problem is the RFMIP file given with ``--rfmip``; without one it is a
synthetic RFMIP-like set of 18 experiments x 100 sites x 60 layers
(testing.synthesize_rfmip_experiments), and the script says so.

Run:  python scripts/torch_train_from_lut_sw.py [--epochs N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from rte_rrtmgp_nn_tpu_torch import testing
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip, rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.models.network import save_model_netcdf
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
from rte_rrtmgp_nn_tpu_torch.training.eval_loop import (
    provenance_attrs, train_with_radiation_eval)
from rte_rrtmgp_nn_tpu_torch.training.gendata import generate_sw_training_data
from rte_rrtmgp_nn_tpu_torch.training.train import (
    TrainState, cosine_decay_schedule, init_model, make_train_step, scheduled)


def fresh_pair(ts: R.SWTrainingSet, ngpt: int, hidden: int, lr: float, total_steps: int,
               seed: int, device) -> R.PairState:
    """Fresh absorption and Rayleigh nets (He init from seeds ``seed`` and
    ``seed + 1``), each with its scalings and its own Adam with cosine
    decay."""
    states = []
    for k in range(2):
        m = init_model([ts.xs.shape[-1], hidden, hidden, ngpt],
                       torch.Generator().manual_seed(seed + k),
                       input_names=("tlay", "play") + R.GASES, input_min=ts.xmin,
                       input_max=ts.xmax, output_mean=ts.out_mean[k], output_std=ts.out_std[k],
                       device=device)
        opt = torch.optim.Adam(m.parameters(), lr=lr, eps=1e-8)
        states.append(TrainState(m, opt, scheduler=scheduled(
            opt, cosine_decay_schedule(lr, total_steps, alpha=1e-2))))
    return R.PairState(*states)


def main() -> int:
    ap = argparse.ArgumentParser()
    # defaults = the recipe behind the shipped score-0.063 artifact pair (PARITY.md)
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps-per-epoch", type=int, default=400)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=40)
    ap.add_argument("--ema", type=float, default=0.999,
                    help="Polyak EMA decay for eval/save (e.g. 0.999)")
    ap.add_argument("--gpts-per-band", type=int, default=4)
    ap.add_argument("--nband", type=int, default=14)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rfmip", default=None,
                    help="an RFMIP input file; without one a synthetic 18 x 100 x 60 set")
    ap.add_argument("--workdir", default=None,
                    help="where gendata files land (default: a tempdir)")
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "artifacts"))
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out_dir, exist_ok=True)
    workdir = args.workdir or tempfile.mkdtemp(prefix="lut_train_sw_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. synthetic SW k-distribution + 2. gendata over the problem ----
    kdist_path = os.path.join(workdir, "kdist_sw_synth.nc")
    generate_kdist_nc(kdist_path, kind="sw", gpts_per_band=args.gpts_per_band,
                      nband=args.nband)
    kd = load_kdist(kdist_path, R.GASES, device=dev)
    ngpt = kd.ngpt
    if args.rfmip:
        data = read_rfmip(args.rfmip)
        print(f"problem: {args.rfmip}")
    else:
        data = rfmip_data_from_arrays(testing.synthesize_rfmip_experiments(
            18, 100, 60, args.seed))
        print("problem: SYNTHETIC RFMIP-like set (testing.synthesize_rfmip_experiments, "
              f"seed {args.seed}), not the RFMIP file: 18 experiments x 100 sites x 60 layers")
    ncol, nlay = np.shape(data.play)
    nexp, nsites = data.nexp, data.nsites
    train_nc = os.path.join(workdir, "sw_train_data.nc")
    print(f"gendata: SW LUT sweep over {ncol} cols x {nlay} layers (ngpt={ngpt}) on {dev} "
          f"-> {train_nc}", flush=True)
    t0 = time.perf_counter()
    gen = generate_sw_training_data(train_nc, kd, data, gas_order=R.GASES)
    print(f"gendata: {time.perf_counter() - t0:.2f} s")
    ref_up = gen["rsu"].reshape(ncol, nlay + 1)
    ref_dn = gen["rsd"].reshape(ncol, nlay + 1)

    # -- 3. the scalings, both nets, their steps --------------------------
    ts = R.sw_training_set(train_nc)
    total_steps = args.epochs * args.steps_per_epoch
    state = fresh_pair(ts, ngpt, args.hidden, args.lr, total_steps, args.seed, dev)
    pair_idx = R.pair_index(args.batch_pairs, dev)
    train_step = R.pair_train_step(make_train_step(alpha=args.alpha),
                                   make_train_step(alpha=args.alpha), pair_idx)
    xs = torch.as_tensor(ts.xs, dtype=torch.float32, device=dev)
    ya = torch.as_tensor(ts.ys_abs, dtype=torch.float32, device=dev)
    yr = torch.as_tensor(ts.ys_ray, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(args.seed)

    def data_iter():
        idx = torch.as_tensor(R.sample_pair_rows(rng, nexp, nsites, nlay, args.batch_pairs),
                              device=dev)
        return xs[idx], (ya[idx], yr[idx])

    # -- 4. day-masked radiation-in-the-loop eval vs the LUT fluxes ------
    ev = R.SWFluxEval(kd, data, ts, ref_up, ref_dn, dev)
    result = train_with_radiation_eval(
        state, train_step, data_iter, ev.metrics, R.REF_SCORES,
        n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=None, ema_decay=args.ema)
    print(f"best radiation score {result.best_score:.3f} at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs LUT: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")

    # -- 5. both models, score-encoded names + the metric vector ---------
    hr_rel = m[0] / max(abs(R.REF_SCORES[0]), 1e-12)
    frc_rel = max(abs(v) / max(abs(r), 1e-12) for v, r in zip(m[3:], R.REF_SCORES[3:]))
    attrs = provenance_attrs(result, R.REF_SCORES)
    for tag, mdl in zip(("absorption", "rayleigh"), result.best_model):
        path = os.path.join(args.out_dir, f"sw-synth{ngpt}-lut_{tag}_{args.hidden}_{args.hidden}"
                            f"_HR_{hr_rel:.2e}_FRC_{frc_rel:.2e}.nc")
        save_model_netcdf(path, mdl, attrs=attrs)
        print(f"saved {tag} model to {path}")
    return 0 if result.best_score < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
