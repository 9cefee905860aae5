"""The distillation recipe shared by scripts/torch_train_demo.py (LW) and
scripts/torch_train_demo_sw.py (SW), and the tests and the smoke run that
drive them.

The JAX package keeps these steps inline in scripts/train_demo.py and
scripts/train_demo_sw.py (the reference ML pipeline, SURVEY.md section
3.4): a student net learns a teacher's raw outputs on the atmospheres of
an RFMIP problem with the hybrid expdiff loss over paired experiments,
Adam with cosine decay, and radiation-in-the-loop early stopping scored
against the teacher's own fluxes. The flags, the batch draws
(``np.random.default_rng(0)``), the schedule and the printed lines are
those scripts'.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..drivers.rfmip_io import RFMIPData
from ..gas_concs import GasConcs
from ..gasoptics.nn_gas_optics import compute_nn_inputs, get_col_dry
from ..models.network import NNModel, load_model_netcdf
from ..utils import cli
from . import lut_recipe as R
from .eval_loop import EarlyStopResult, eval_metrics, train_with_radiation_eval
from .train import TrainState, cosine_decay_schedule, init_model, make_train_step, scheduled

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "artifacts")


def add_arguments(ap: argparse.ArgumentParser, hidden: int) -> None:
    """The JAX demos' flags and defaults (``--hidden`` its script's), and
    ``--device``."""
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--hidden", type=int, default=hidden)
    ap.add_argument("--steps-per-epoch", type=int, default=400)
    ap.add_argument("--alpha", type=float, default=0.6,
                    help="hybrid-loss weight on the paired-experiment "
                         "expdiff term (0 = pure MSE)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch-pairs", type=int, default=1024)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--init-from", default=None, metavar="MODEL_NC",
                    help="warm-start from a previously saved artifact "
                         "(hidden sizes must match)")
    ap.add_argument("--out-dir", default=os.path.normpath(ARTIFACTS))
    cli.add_device_argument(ap)


def teacher_targets(teacher: NNModel, play, plev, tlay, gases: GasConcs):
    """(x, y, col_dry): the teacher's scaled NN inputs (ncol, nlay, n_in),
    its raw outputs there (ncol, nlay, n_out; plain matrix products, as the
    JAX scripts compute them outside any kernel), and the dry-air column
    (ncol, nlay)."""
    ncol, nlay = play.shape
    x = compute_nn_inputs(play, tlay, gases, teacher)
    with torch.no_grad():
        y = teacher.apply_raw(x)
    return x, y, get_col_dry(gases.get_vmr("h2o", ncol, nlay), plev)


def student(teacher: NNModel, hidden: int, init_from, device) -> NNModel:
    """The net to train: loaded from ``init_from`` (a saved net, made
    trainable), or a fresh ``[n_in, hidden, hidden, n_out]`` net of the
    teacher's widths at both ends, He init from seed 0, with the teacher's
    input names and scalings."""
    if init_from:
        model = load_model_netcdf(init_from, device=device)
        for p in model.parameters():
            p.requires_grad_(True)
        return model
    host = lambda t: None if t is None else t.cpu()
    return init_model(
        [teacher.n_inputs, hidden, hidden, teacher.n_outputs], torch.Generator().manual_seed(0),
        input_names=teacher.input_names, input_min=host(teacher.input_min),
        input_max=host(teacher.input_max), output_mean=host(teacher.output_mean),
        output_std=host(teacher.output_std), device=device)


def train(model: NNModel, x, y, data: RFMIPData, flux_of, ref, args,
          save_tmpl: str) -> EarlyStopResult:
    """Train ``model`` on the rows of (x, y) and return the loop's result:
    Adam at ``args.lr`` with cosine decay to 1e-2 of it over every step,
    the hybrid loss (``args.alpha``) over batches of ``args.batch_pairs``
    experiment pairs drawn as the JAX demos draw them, and after each epoch
    the 8 metrics of ``flux_of(model)`` -> (flux_up, flux_dn) against
    ``ref`` = (up, dn), normalized by R.REF_SCORES. The best net is saved
    under ``save_tmpl``; the two closing lines are the JAX scripts'."""
    dev = x.device
    nlay = x.shape[1]
    xs, ys = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
    total_steps = args.epochs * args.steps_per_epoch
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    state = TrainState(model, optimizer, scheduler=scheduled(
        optimizer, cosine_decay_schedule(args.lr, total_steps, alpha=1e-2)))
    step_inner = make_train_step(alpha=args.alpha)
    pair_idx = R.pair_index(args.batch_pairs, dev)
    rng = np.random.default_rng(0)

    def data_iter():
        idx = torch.as_tensor(R.sample_pair_rows(rng, data.nexp, data.nsites, nlay,
                                                 args.batch_pairs, eval_pair_p=None), device=dev)
        return xs[idx], ys[idx]

    def eval_fn(m):
        up, dn = flux_of(m)
        return eval_metrics(up, dn, ref[0], ref[1], data.plev, data.nexp, top_at_1=data.top_at_1)

    result = train_with_radiation_eval(
        state, lambda st, xb, yb: step_inner(st, xb, yb, pair_idx), data_iter, eval_fn,
        R.REF_SCORES, n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        patience=args.patience, save_path=save_tmpl)
    print(f"best radiation score {result.best_score:.3f} at epoch {result.best_epoch}")
    m = result.history[result.best_epoch]["metrics"]
    print(f"vs teacher: HR MAE {m[0]:.4f} K/d, TOA bias {m[2]:.4f} W/m2")
    return result
