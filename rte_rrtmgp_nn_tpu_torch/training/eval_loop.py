"""Radiation-in-the-loop evaluation and early stopping.

Port of rte_rrtmgp_nn_tpu/training/eval_loop.py. Reference parity: the
eval drivers ``rrtmgp_lw_eval_nn_rfmip.F90`` (8 scalar error metrics vs
reference fluxes: pressure-weighted heating-rate MAE all-experiments and
present-day, TOA upwelling bias, and five radiative-forcing biases between
experiment pairs; :452-603) and the Keras callback ``RunRadiationScheme``
(ml_trainfuncs_keras.py:85-213: run the scheme each epoch, normalize
metrics by the reference scheme's own scores, early-stop on the RMS
"radiation score" with best-weights restore).

The eval is an in-process call of the candidate model (on CUDA, the MLP
kernel and the transport kernel), run under ``torch.no_grad()``: no kernel
has a backward and the eval needs no gradient. The 8 reductions run on the
device through ``parallel.shard_ops.rfmip_eval_metrics_core``, the core the
mesh path (``rfmip_eval_metrics_sharded``) adds over devices.

A torch model changes in place, where the JAX package's models are
immutable values: the best model and the EMA model are therefore copies of
their own (``snapshot``), taken at their epoch, never the live module.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.network import NNModel, save_model_netcdf
from ..parallel.shard_ops import rfmip_eval_metrics_core

METRIC_NAMES = (
    "MAE HR (all)",
    "MAE HR (PD)",
    "Bias TOA upwelling",
    "Bias RF-TOA (PI->PD)",
    "Bias RF-TOA (PD->future)",
    "Bias RF-SFC (PI->future)",
    "Bias RF-SFC N2O (PI->PD)",
    "Bias RF-SFC CH4 (PI->PD)",
)


def eval_metrics(flux_up, flux_dn, ref_up, ref_dn, plev, nexp: int,
                 top_at_1: bool = True) -> np.ndarray:
    """The 8 scalar error metrics of the reference eval driver
    (rrtmgp_lw_eval_nn_rfmip.F90:452-577), evaluated by the shared
    device-side core (parallel.shard_ops.rfmip_eval_metrics_core) in
    float32, on the device of ``flux_up`` when it is a tensor (numpy
    arrays are brought there), else on the CPU.

    Arrays are (ncol = nexp*nsites, nlev); plev (ncol, nlev). Returns a
    float64 numpy vector (one wait for the device)."""
    dev = flux_up.device if torch.is_tensor(flux_up) else torch.device("cpu")
    nsites = flux_up.shape[0] // nexp

    def rs(a):
        a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float32))
        return a.to(dev, torch.float32).reshape(nexp, nsites, -1)

    m = rfmip_eval_metrics_core(rs(flux_up), rs(flux_dn), rs(ref_up), rs(ref_dn), rs(plev),
                                top_at_1=top_at_1)
    return m.cpu().numpy().astype(np.float64)


def radiation_score(metrics: np.ndarray, ref_scores: np.ndarray) -> float:
    """RMS of metrics normalized by the reference scheme's own error levels
    (reference RunRadiationScheme: score = rms(metric_i / refscore_i))."""
    r = metrics / np.where(np.abs(ref_scores) > 0, np.abs(ref_scores), 1.0)
    return float(np.sqrt(np.mean(r * r)))


def provenance_attrs(result: "EarlyStopResult", ref_scores: np.ndarray) -> dict:
    """Global netCDF attributes recording the full radiation-eval outcome
    (metric vector + normalizers + score) so the artifact is
    self-describing: the score-encoded filename alone does not give the
    metrics back."""
    m = np.asarray(result.history[result.best_epoch]["metrics"], np.float64)
    return {
        "radiation_score": float(result.best_score),
        "radiation_metrics": m,
        "radiation_metric_names": "; ".join(METRIC_NAMES),
        "radiation_ref_scores": np.asarray(ref_scores, np.float64),
        "best_epoch": np.int32(result.best_epoch),
    }


def snapshot(model: NNModel) -> NNModel:
    """A copy of ``model`` with tensors of its own that no gradient
    reaches: what the model is now, whatever happens to it later."""
    with torch.no_grad():
        copied = copy.deepcopy(model)
    for p in copied.parameters():
        p.requires_grad_(False)
    return copied


@dataclasses.dataclass
class EarlyStopResult:
    best_model: NNModel
    best_score: float
    best_epoch: int
    history: list


def train_with_radiation_eval(
    state,
    train_step: Callable,
    data_iter: Callable,
    eval_fn: Callable[[NNModel], np.ndarray],
    ref_scores: np.ndarray,
    n_epochs: int = 100,
    steps_per_epoch: int = 100,
    patience: int = 70,
    save_path: Optional[str] = None,
    verbose: bool = True,
    ema_decay: Optional[float] = None,
) -> EarlyStopResult:
    """The training loop with per-epoch radiation evaluation.

    eval_fn(model) -> 8 metrics (an in-process radiation evaluation, called
    under torch.no_grad()); early stop on the radiation score with
    best-weights restore (ml_trainfuncs_keras.py:126-209). If
    ``save_path``, the best model is written as a reference-format netCDF
    with the score in the filename (ml_train.py:493-517 naming convention).

    ema_decay: if set (e.g. 0.999), evaluate/save a Polyak exponential
    moving average of the weights instead of the raw iterate -- the
    per-epoch radiation score is noisy near convergence (stochastic
    expdiff pairs) and the averaged weights sit at the basin floor. The
    average is a copy of the model updated after each step
    (``torch._foreach_lerp_``: ema + (1 - decay) * (model - ema)).
    """
    best = EarlyStopResult(snapshot(state.model), np.inf, -1, [])
    bad_epochs = 0
    ema = snapshot(state.model) if ema_decay else None
    ema_params = list(ema.parameters()) if ema_decay else None
    for epoch in range(n_epochs):
        loss = None
        for _ in range(steps_per_epoch):
            x, y = data_iter()
            state, loss = train_step(state, x, y)
            if ema_decay:
                with torch.no_grad():
                    torch._foreach_lerp_(ema_params, list(state.model.parameters()),
                                         1.0 - ema_decay)
        eval_model = ema if ema_decay else state.model
        with torch.no_grad():
            metrics = np.asarray(eval_fn(eval_model), np.float64)
        score = radiation_score(metrics, ref_scores)
        best.history.append({"epoch": epoch, "loss": float(loss), "score": score,
                             "metrics": metrics.tolist()})
        if verbose:
            print(f"epoch {epoch}: loss {float(loss):.5f} radiation_score {score:.4f}")
        if score < best.best_score:
            best = dataclasses.replace(
                best, best_model=snapshot(eval_model), best_score=score, best_epoch=epoch)
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                break
    if save_path is not None:
        if best.best_epoch < 0:
            # zero epochs, or every score was NaN (diverged training):
            # best_model is still the UNTRAINED init and history[-1] would
            # stamp it with the wrong epoch's metrics -- refuse to save
            raise RuntimeError(
                "no epoch produced a finite radiation score; refusing to "
                "save the untrained initial model")
        hr_rel = best.history[best.best_epoch]["metrics"][0] / max(abs(ref_scores[0]), 1e-12)
        frc_rel = max(
            abs(m) / max(abs(r), 1e-12)
            for m, r in zip(best.history[best.best_epoch]["metrics"][3:], ref_scores[3:])
        )
        path = save_path.format(hr=f"{hr_rel:.2e}", frc=f"{frc_rel:.2e}")
        save_model_netcdf(path, best.best_model, attrs=provenance_attrs(best, ref_scores))
        if verbose:
            print(f"saved best model (epoch {best.best_epoch}) to {path}")
    return best
