"""The reference training loop from LUT-generated data, on the PyTorch port.

The counterpart of scripts/train_from_lut.py (the recipe of the shipped
``artifacts/lw-synth64-lut_both_128_128_*.nc``), with the same steps and
flags:

1. synthesize a LW k-distribution (gasoptics/synthetic.py: 16 bands x 4
   g-points by default),
2. run the LUT gas optics + RTE over the RFMIP-style problem and write the
   training file (training/gendata.py), read it back with the training
   loader,
3. train a fresh "lw_both" MLP (tau || planck_fraction) with the reference
   predictand scalings, Adam with cosine decay and the hybrid expdiff
   forcing loss,
4. evaluate each epoch by running the radiation of the whole problem
   against the LUT fluxes (8 reference metrics -> radiation score, early
   stopping; on CUDA the MLP kernel K3 and the transport kernel K7),
5. save the best model in the reference netCDF format with the
   score-encoded filename (ml_train.py:493-517).

The problem is the RFMIP file given with ``--rfmip``; without one it is a
synthetic RFMIP-like set of 18 experiments x 100 sites x 60 layers
(testing.synthesize_rfmip_experiments), and the script says so.

Run:  python scripts/torch_train_from_lut.py [--epochs N] [--device cuda|cpu]
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
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
from rte_rrtmgp_nn_tpu_torch.training.eval_loop import train_with_radiation_eval
from rte_rrtmgp_nn_tpu_torch.training.gendata import generate_lw_training_data
from rte_rrtmgp_nn_tpu_torch.training.train import (
    TrainState, cosine_decay_schedule, init_model, make_train_step, scheduled)


def main() -> int:
    ap = argparse.ArgumentParser()
    # defaults = the recipe of the shipped score-0.314 artifact (PARITY.md)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps-per-epoch", type=int, default=800)
    ap.add_argument("--alpha", type=float, default=0.85)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=40)
    ap.add_argument("--ema", type=float, default=0.999,
                    help="Polyak EMA decay for eval/save (e.g. 0.999)")
    ap.add_argument("--gpts-per-band", type=int, default=4)
    ap.add_argument("--nband", type=int, default=16)
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
    workdir = args.workdir or tempfile.mkdtemp(prefix="lut_train_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. synthetic k-distribution + 2. gendata over the RFMIP ensemble --
    kdist_path = os.path.join(workdir, "kdist_lw_synth.nc")
    generate_kdist_nc(kdist_path, kind="lw", gpts_per_band=args.gpts_per_band,
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

    train_nc = os.path.join(workdir, "lw_train_data.nc")
    print(f"gendata: LUT sweep over {ncol} cols x {nlay} layers (ngpt={ngpt}) on {dev} "
          f"-> {train_nc}", flush=True)
    t0 = time.perf_counter()
    gen = generate_lw_training_data(train_nc, kd, data, gas_order=R.GASES)
    print(f"gendata: {time.perf_counter() - t0:.2f} s")
    ref_up = gen["rsu"].reshape(ncol, nlay + 1)
    ref_dn = gen["rsd"].reshape(ncol, nlay + 1)

    # -- 3. reference predictand scalings, read back through the loader ---
    ts = R.lw_training_set(train_nc, ngpt)
    nfeat = ts.xs.shape[-1]
    model = init_model(
        [nfeat, args.hidden, args.hidden, 2 * ngpt], torch.Generator().manual_seed(args.seed),
        input_names=("tlay", "play") + R.GASES, input_min=ts.xmin, input_max=ts.xmax,
        output_mean=ts.out_mean, output_std=ts.out_std, device=dev)
    total_steps = args.epochs * args.steps_per_epoch
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    state = TrainState(model, optimizer, scheduler=scheduled(
        optimizer, cosine_decay_schedule(args.lr, total_steps, alpha=1e-2)))
    step_inner = make_train_step(alpha=args.alpha)
    pair_idx = R.pair_index(args.batch_pairs, dev)
    xs = torch.as_tensor(ts.xs, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(ts.ys, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(args.seed)

    def data_iter():
        idx = torch.as_tensor(R.sample_pair_rows(rng, nexp, nsites, nlay, args.batch_pairs),
                              device=dev)
        return xs[idx], ys[idx]

    def train_step(st, x, y):
        return step_inner(st, x, y, pair_idx)

    # -- 4. radiation-in-the-loop eval vs the LUT's own fluxes ----------
    ev = R.LWFluxEval(kd, data, ts, ref_up, ref_dn, dev)
    save_tmpl = os.path.join(args.out_dir, f"lw-synth{ngpt}-lut_both_{args.hidden}_{args.hidden}"
                             + "_HR_{hr}_FRC_{frc}.nc")
    result = train_with_radiation_eval(
        state, train_step, data_iter, ev.metrics, R.REF_SCORES,
        n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=save_tmpl, ema_decay=args.ema)
    print(f"best radiation score {result.best_score:.3f} at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs LUT: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")
    return 0 if result.best_score < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
