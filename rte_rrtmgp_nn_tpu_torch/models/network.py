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
        # {(perm, n2d): (w1a, w1c)}: the first layer's rows as the fused
        # kernels take them (gasoptics.nn_gas_optics.split_first_layer), cut
        # from the weight that first_layer_source names: (an alias of it,
        # its version counter then)
        self.first_layer_splits: dict = {}
        self.first_layer_source = None
        # the net as the generic MLP kernel reads it (ops/cuda/mlp.kernel_net)
        self.kernel_net = None

    def _apply(self, fn, *args, **kwargs):
        # to(), float(), double(), cuda(): the kept splits and the kernel's
        # view are of the old tensors
        self.first_layer_splits.clear()
        self.first_layer_source = None
        self.kernel_net = None
        return super()._apply(fn, *args, **kwargs)

    def __getstate__(self):
        # a copy (deepcopy, pickle) has tensors of its own: the kernel's view
        # and the splits are of this model's
        return {**super().__getstate__(), "kernel_net": None, "first_layer_splits": {},
                "first_layer_source": None}

    def tensor_key(self) -> tuple:
        """(data pointer, dtype, shape) of each weight, bias, output mean and
        std (None where absent): what a view of the model's tensors by
        address must still match (ops/cuda/mlp.kernel_net). Read from the
        module's dicts, as it is taken at every kernel call."""
        ts = (*self.weights._parameters.values(), *self.biases._parameters.values(),
              self._buffers["output_mean"], self._buffers["output_std"])
        return tuple(None if t is None else (t.data_ptr(), t.dtype, t.shape) for t in ts)

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

    def apply_with_final_activation(self, x: torch.Tensor) -> torch.Tensor:
        """Network output including the configured final activation
        (output_sgemm_flat; the Planck-fraction kernel's final
        bias_and_activation)."""
        return ACTIVATIONS[self.activations[-1]](self.apply_raw(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Network output including the configured final activation."""
        return self.apply_with_final_activation(x)


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


def save_model_netcdf(path: str, model: NNModel, string_len: int = 32,
                      attrs=None) -> None:
    """Write the reference model format (ml_load_save_preproc.py:21-171) as
    netCDF-3 classic, which any netCDF reader opens, the reference's
    Fortran loader included. ``attrs``: optional global attributes (every
    loader ignores them), e.g. the metrics a training run scored."""
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)
    dims: dict[str, int] = {
        "nn_layers": model.n_layers,
        "nn_dim_input": model.n_inputs,
        "string_len": string_len,
    }
    variables: dict[str, tuple[Sequence[str], np.ndarray]] = {
        "nn_dimsize": (("nn_layers",), np.asarray(model.dims[1:], np.int32)),
        "nn_activation_char": (("nn_layers", "string_len"),
                               ncio.strings_to_chararray(list(model.activations), string_len)),
        "nn_inputs_char": (("nn_dim_input", "string_len"),
                           ncio.strings_to_chararray(list(model.input_names), string_len)),
        "nn_input_coeffs_min": (("nn_dim_input",), f32(model.input_min)),
        "nn_input_coeffs_max": (("nn_dim_input",), f32(model.input_max)),
    }
    dim_names = ["nn_dim_input"]
    for i, size in enumerate(model.dims[1:-1], start=1):
        dims[f"nn_dim_hidden{i}"] = size
        dim_names.append(f"nn_dim_hidden{i}")
    dims["nn_dim_outp"] = model.n_outputs
    dim_names.append("nn_dim_outp")
    for n in range(1, model.n_layers + 1):
        variables[f"nn_weights_{n}"] = ((dim_names[n - 1], dim_names[n]), f32(model.weights[n - 1]))
        variables[f"nn_bias_{n}"] = ((dim_names[n],), f32(model.biases[n - 1]))
    for name, t in (("nn_output_coeffs_mean", model.output_mean),
                    ("nn_output_coeffs_std", model.output_std)):
        if t is not None:
            variables[name] = (("nn_dim_outp",), f32(t))
    ncio.write_nc(path, dims, variables, attrs=attrs)
