"""Neural-network gas-optics models: the reference-compatible model format
and batched inference.

Port of rte_rrtmgp_nn_tpu/models/network.py. The netCDF format is the
reference's (``nn_dimsize``, ``nn_weights_i``, ``nn_bias_i``,
``nn_activation_char``, ``nn_inputs_char``, ``nn_input_coeffs_min/max``,
``nn_output_coeffs_mean/std``; mod_network_rrtmgp.F90:58-122), and the
seven activations are those of neural/mod_activation.F90.

Weight convention: (n_in, n_out) as read from the file; inference is
``y = x @ W + b`` with x (nbatch, n_in). The fused kernels read these
tensors directly.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..utils import ncio

ACTIVATIONS: dict[str, Callable] = {
    "linear": lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "softsign": lambda x: x / (torch.abs(x) + 1.0),
    "tanh": torch.tanh,
    "gaussian": lambda x: torch.exp(-(x * x)),
}


class NNModel(nn.Module):
    """An MLP with input min-max scaling coefficients and optional output
    standardization coefficients (reference rrtmgp_network_type)."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 activations: Sequence[str], input_names: Sequence[str],
                 input_min: torch.Tensor, input_max: torch.Tensor,
                 output_mean: torch.Tensor | None = None,
                 output_std: torch.Tensor | None = None):
        super().__init__()
        if not (len(weights) == len(biases) == len(activations)):
            raise ValueError("weights, biases and activations differ in length")
        for a in activations:
            if a.lower() not in ACTIVATIONS:
                raise ValueError(f"unknown activation {a!r}")
        self.weights = nn.ParameterList(
            nn.Parameter(w, requires_grad=False) for w in weights)
        self.biases = nn.ParameterList(
            nn.Parameter(b, requires_grad=False) for b in biases)
        self.activations = tuple(a.lower() for a in activations)
        self.input_names = tuple(input_names)
        self.register_buffer("input_min", input_min)
        self.register_buffer("input_max", input_max)
        self.register_buffer("output_mean", output_mean)
        self.register_buffer("output_std", output_std)

    @property
    def n_inputs(self) -> int:
        return self.weights[0].shape[0]

    @property
    def n_outputs(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def n_layers(self) -> int:
        return len(self.weights)

    @property
    def dims(self) -> list[int]:
        return [self.n_inputs] + [w.shape[1] for w in self.weights]

    def apply_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Raw network output: final linear layer + bias, NO output
        activation (the tau/pfrac postprocessing replaces it). x: (...,
        n_inputs), already scaled."""
        h = x
        for w, b, act in zip(self.weights[:-1], self.biases[:-1], self.activations[:-1]):
            h = ACTIVATIONS[act](h @ w + b)
        return h @ self.weights[-1] + self.biases[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Network output including the configured final activation."""
        return ACTIVATIONS[self.activations[-1]](self.apply_raw(x))


def nn_model_from_arrays(weights, biases, activations, input_names, input_min,
                         input_max, output_mean=None, output_std=None, *,
                         device, dtype=torch.float32) -> NNModel:
    """Build an NNModel from numpy arrays: weights (n_in, n_out) per layer,
    biases (n_out,), activation names, input names, input min/max and the
    optional output mean/std."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return NNModel(
        weights=[t(w) for w in weights],
        biases=[t(b) for b in biases],
        activations=tuple(activations),
        input_names=tuple(input_names),
        input_min=t(input_min),
        input_max=t(input_max),
        output_mean=None if output_mean is None else t(output_mean),
        output_std=None if output_std is None else t(output_std),
    )


def load_model_netcdf(path: str, device, dtype=torch.float32) -> NNModel:
    """Load a model in the reference netCDF format onto ``device``."""
    with ncio.NCFile(path) as f:
        num_layers = f.dim_size("nn_layers")
        nx = f.dim_size("nn_dim_input")
        dimsize = f.read("nn_dimsize").astype(int)
        weights, biases = [], []
        d_in = nx
        for n in range(1, num_layers + 1):
            w = f.read(f"nn_weights_{n}", dtype=np.float32)
            b = f.read(f"nn_bias_{n}", dtype=np.float32)
            # stored C-order shape (n_in, n_out)
            if w.shape != (d_in, int(dimsize[n - 1])):
                w = w.reshape(d_in, int(dimsize[n - 1]))
            weights.append(w)
            biases.append(b)
            d_in = int(dimsize[n - 1])
        try:
            acts = f.read_strings("nn_activation_char")
        except KeyError:
            acts = f.read_strings("nn_activation")
        names = tuple(s.lower() for s in f.read_strings("nn_inputs_char"))
        in_min = f.read("nn_input_coeffs_min", np.float32)
        in_max = f.read("nn_input_coeffs_max", np.float32)
        out_mean = out_std = None
        if f.has_var("nn_output_coeffs_mean"):
            out_mean = f.read("nn_output_coeffs_mean", np.float32)
        if f.has_var("nn_output_coeffs_std"):
            out_std = f.read("nn_output_coeffs_std", np.float32)
    return nn_model_from_arrays(weights, biases, acts, names, in_min, in_max,
                                out_mean, out_std, device=device, dtype=dtype)
