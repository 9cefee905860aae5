"""NN gas-optics emulator training on torch autograd.

Port of rte_rrtmgp_nn_tpu/training/train.py. Reference parity:
``examples/rrtmgp-nn-training/ml_train.py`` -- predictands lw_absorption /
lw_planck_frac / lw_both / sw_absorption / sw_rayleigh (:188-195); output
scaling tau -> cross-section (/col_dry) -> y**(1/8) -> per-g-point mean,
global std (:40-47, 361-367); MLP with Adam lr 1e-3 batch 2048 (:259-262);
optional hybrid loss ``alpha*expdiff + (1-alpha)*MSE`` on paired
experiments for forcing accuracy (ml_trainfuncs_keras.py:47-67); the
radiation-in-the-loop evaluation is training/eval_loop.py.

The step differentiates ``NNModel.apply_raw`` (plain matrix products, on
any device) and updates the model's parameters in place. The kernels are
not in the step: none has a backward, and a CUDA kernel call with a weight
that requires grad is refused in words (config.grad_refusal), so the
radiation eval runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..models.network import NNModel


def init_model(
    dims: list[int],
    generator: torch.Generator,
    hidden_activation: str = "softsign",
    input_names: tuple = (),
    input_min=None,
    input_max=None,
    output_mean=None,
    output_std=None,
    dtype=torch.float32,
    *,
    device,
) -> NNModel:
    """He-style init of an MLP (normal weights of std sqrt(2 / fan-in), zero
    biases) in the NNModel container, the equivalent of
    ml_trainfuncs_keras.create_model_mlp. The weights and biases require
    grad; the scaling coefficients are buffers. The draws come from
    ``generator`` on the CPU, one layer after another, and are then moved
    to ``device``, which has no default (as ``load_model_netcdf``'s)."""
    weights, biases = [], []
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((n_in, n_out), generator=generator, dtype=dtype)
        weights.append((w * math.sqrt(2.0 / n_in)).to(device))
        biases.append(torch.zeros((n_out,), dtype=dtype, device=device))
    t = lambda a, fill: (torch.full((dims[0],), fill, dtype=dtype, device=device) if a is None
                         else torch.as_tensor(np.asarray(a), dtype=dtype, device=device))
    opt = lambda a: None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype,
                                                           device=device)
    model = NNModel(
        weights, biases,
        activations=tuple([hidden_activation] * (len(dims) - 2) + ["linear"]),
        input_names=tuple(input_names) or tuple(f"x{i}" for i in range(dims[0])),
        input_min=t(input_min, 0.0), input_max=t(input_max, 1.0),
        output_mean=opt(output_mean), output_std=opt(output_std))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


# -- output scalings (reference ml_load_save_preproc.py:283-541) -------------

def scale_outputs_tau(tau: torch.Tensor, col_dry: torch.Tensor) -> torch.Tensor:
    """tau -> y = (tau/col_dry)**(1/8): the model's raw-output target before
    standardization."""
    sigma = tau / col_dry[..., None]
    return sigma ** 0.125


def standardize_coeffs(y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-g-point mean, global std (ml_train.py:361-367). The std is
    numpy's population std (ddof 0), not torch.std's default (ddof 1)."""
    y = np.asarray(y)
    ymean = y.reshape(-1, y.shape[-1]).mean(axis=0)
    ystd = np.full(y.shape[-1], y.reshape(-1, y.shape[-1]).std())
    return ymean, ystd


def scale_outputs_pfrac(pfrac: torch.Tensor) -> torch.Tensor:
    """pfrac -> sqrt(pfrac) (trained with the square root; inference squares)."""
    return torch.sqrt(pfrac)


# -- losses ------------------------------------------------------------------

def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def expdiff_loss(pred: torch.Tensor, target: torch.Tensor, pair_idx: torch.Tensor) -> torch.Tensor:
    """Difference-between-paired-experiments loss component
    (ml_trainfuncs_keras.py expdiff, :47-67): penalizes errors in the
    *difference* of predictions between paired samples (e.g. present vs
    future scenarios), which controls forcing accuracy.

    pair_idx: (npairs, 2) indices into the batch."""
    dp = pred[pair_idx[:, 0]] - pred[pair_idx[:, 1]]
    dt = target[pair_idx[:, 0]] - target[pair_idx[:, 1]]
    return torch.mean((dp - dt) ** 2)


def hybrid_loss(pred, target, pair_idx, alpha: float = 0.5):
    """alpha*expdiff + (1-alpha)*MSE (hybrid_loss_wrapper)."""
    return alpha * expdiff_loss(pred, target, pair_idx) + (1.0 - alpha) * mse_loss(pred, target)


# -- learning-rate schedule --------------------------------------------------

def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: the rate at step ``count`` (0-based,
    the count of updates already made) is init_value * ((1 - alpha) *
    (0.5 * (1 + cos(pi * min(count, T) / T)))**exponent + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def scheduled(optimizer: torch.optim.Optimizer,
              schedule: Callable[[int], float]) -> torch.optim.lr_scheduler.LambdaLR:
    """A LambdaLR that gives ``optimizer`` the rate ``schedule(count)`` for
    its update number ``count`` (0-based), when stepped once after each
    optimizer step, as make_train_step does. optax reads the count before
    it increments it, so the first update takes schedule(0); LambdaLR sets
    schedule(0) at construction and schedule(k) at its k-th step(). The
    optimizer's rate must be schedule(0)'s init_value: LambdaLR scales it."""
    base = optimizer.param_groups[0]["lr"]
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: schedule(count) / base)


# -- train step --------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (bound to the model's parameters), the
    optional learning-rate scheduler stepped after each update, and the
    count of steps taken. A step changes all of them in place."""

    model: NNModel
    optimizer: torch.optim.Optimizer
    step: int = 0
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None


def make_train_step(alpha: float = 0.0):
    """Build a train step ``(state, x, y, pair_idx=None) -> (state, loss)``:
    the loss of ``state.model.apply_raw(x)`` against y (MSE, or with alpha >
    0 and pair indices the hybrid loss), its gradient by autograd, one
    optimizer update and one scheduler step. The state is updated in place
    and returned; ``loss`` is a 0-d tensor detached from the graph (reading
    it waits for the device)."""

    def train_step(state: TrainState, x, y, pair_idx=None):
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            pred = state.model.apply_raw(x)
            if pair_idx is not None and alpha > 0:
                loss = hybrid_loss(pred, y, pair_idx, alpha)
            else:
                loss = mse_loss(pred, y)
            loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return train_step


class Cocob(torch.optim.Optimizer):
    """COCOB-Backprop (Orabona & Tommasi 2017): the parameter-free
    coin-betting optimizer the reference offers as an alternative to Adam
    (ml_trainfuncs_keras.py COCOB class, :216+), update for update the JAX
    package's ``cocob(alpha)`` on the parameters given. Per parameter it keeps the initial value, the
    largest |gradient| seen (from 1e-8), the sum of |gradients|, the reward
    and the sum of -gradients; a parameter with no gradient is left as is."""

    def __init__(self, params, alpha: float = 100.0):
        super().__init__(params, {"alpha": alpha})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha = group["alpha"]
            for w in group["params"]:
                if w.grad is None:
                    continue
                g = w.grad
                st = self.state[w]
                if not st:
                    st["init_params"] = w.detach().clone()
                    st["L"] = torch.full_like(w, 1e-8)
                    st["grad_sum"] = torch.zeros_like(w)
                    st["reward"] = torch.zeros_like(w)
                    st["theta"] = torch.zeros_like(w)
                w1, L = st["init_params"], torch.maximum(st["L"], g.abs())
                gsum = st["grad_sum"] + g.abs()
                r = torch.clamp_min(st["reward"] - g * (w - w1), 0.0)
                th = st["theta"] - g
                w_new = w1 + th / (L * torch.maximum(gsum + L, alpha * L)) * (L + r)
                st.update(L=L, grad_sum=gsum, reward=r, theta=th)
                w.add_(w_new - w)  # optax.apply_updates: w + (w_new - w)
        return loss


def create_train_state(model: NNModel, learning_rate: float = 1e-3) -> tuple[TrainState,
                                                                            torch.optim.Optimizer]:
    """Adam lr 1e-3 as in the reference (ml_train.py:259-262), optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8), on the model's weights and biases
    (the scaling coefficients are buffers and do not train). Returns
    (state, optimizer)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    return TrainState(model, optimizer), optimizer
