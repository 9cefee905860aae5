"""Runtime configuration (port of rte_rrtmgp_nn_tpu/config.py).

Extent and value checking, the missing-gas scenario index for the NN input
packing, the working precision, the numerics choices the reference exposes
as preprocessor macros (``FAST_EXPONENTIAL``, ``use_Pade_source``,
``compute_Jac``), and the switch for the fused clear-sky kernels; plus the one
dispatch rule the drivers follow (``resolve_use_megakernel``, and
``driver_route``, which raises its refusals in the driver's name).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import NamedTuple

import torch


def tau_thresh_for(dtype: torch.dtype) -> float:
    """Series-expansion threshold of the linear-in-tau LW source: sqrt(eps)
    of ``dtype``, rounded in ``dtype``."""
    return float(torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype)))


@dataclasses.dataclass
class RTEConfig:
    # Validate array extents in rte_lw / rte_sw.
    check_extents: bool = False
    # Validate array values in rte_lw / rte_sw (host-side: reads the values).
    check_values: bool = False
    # Missing-gas handling for NN inputs: 0 = zero concentration,
    # 1 = present-day, 2 = pre-industrial, 3 = future reference VMR.
    nn_scenario_index: int = 0
    # Working precision of the staged (plain) path.
    dtype: torch.dtype = torch.float32
    # Pade-approximant exponential in every solver exponential (reference
    # -DFAST_EXPONENTIAL). Honored by the staged path only.
    fast_exponential: bool = False
    # Pade linear-in-tau LW source form (reference use_Pade_source).
    # Honored by the staged path only.
    use_pade_source: bool = False
    # Surface-temperature Jacobian of the upward LW flux (reference
    # compute_Jac).
    compute_jac: bool = False
    # Fused clear-sky kernels (ops/cuda). None = on when the driver's
    # device is CUDA.
    use_megakernel: bool | None = None

    @property
    def eps(self) -> float:
        return float(torch.finfo(self.dtype).eps)

    @property
    def tau_thresh(self) -> float:
        return tau_thresh_for(self.dtype)

    @property
    def k_min(self) -> float:
        # Floor on the two-stream eigenvalue k.
        return 1.0e-12 if self.dtype == torch.float64 else 1.0e-4


config = RTEConfig()

# Widest hidden layer and deepest net the generic MLP kernel takes
# (csrc/mlp.cu kMaxWidth, kMaxLayers).
MLP_KERNEL_MAX_WIDTH = 512
MLP_KERNEL_MAX_LAYERS = 8


def megakernel_model_ok(models) -> bool:
    """The fused kernels hard-code the shipped NN architecture: three dense
    layers, softsign hidden activations, linear output."""
    return all(
        len(m.weights) == 3 and len(m.biases) == 3
        and tuple(a.lower() for a in m.activations)
        == ("softsign", "softsign", "linear")
        for m in models
    )


def mlp_kernel_refusal(models) -> str:
    """Why the generic MLP kernel (K3/K4/K5) cannot take ``models``, or ""
    if it can: at most MLP_KERNEL_MAX_LAYERS layers and no input or hidden
    layer wider than MLP_KERNEL_MAX_WIDTH (the output layer may be wider)."""
    for m in models:
        if m.n_layers > MLP_KERNEL_MAX_LAYERS:
            return (f"a {m.n_layers}-layer net is deeper than the MLP kernel's "
                    f"{MLP_KERNEL_MAX_LAYERS} layers")
        widest = max(m.dims[:-1])
        if widest > MLP_KERNEL_MAX_WIDTH:
            return (f"a layer {widest} wide is wider than the MLP kernel's "
                    f"{MLP_KERNEL_MAX_WIDTH}")
    return ""


def cuda_dtype_refusal(device, dtype: torch.dtype) -> str:
    """Why a ``dtype`` computation cannot run on ``device``, or "": on CUDA
    the kernels are float32, and their plain twins never run in their
    place. The CPU runs any dtype (float64 is the arbiter)."""
    if device is not None and torch.device(device).type == "cuda" and dtype != torch.float32:
        return f"{dtype} runs only on the CPU; the kernels are float32"
    return ""


def grad_refusal(name: str, *values) -> str:
    """Why a call of the CUDA kernel ``name`` cannot serve autograd, or "":
    no kernel has a backward (the JAX package has no backward kernel either),
    so with grad enabled an input or weight that requires grad would get
    outputs that no gradient reaches. ``values``: tensors, modules (their
    parameters), lists or tuples of these; anything else is ignored. Run
    the call under ``torch.no_grad()``, or on the CPU, whose plain twins
    differentiate."""
    if not torch.is_grad_enabled():
        return ""

    def wants(v) -> bool:
        if torch.is_tensor(v):
            return v.requires_grad
        if isinstance(v, torch.nn.Module):
            return any(p.requires_grad for p in v.parameters())
        if isinstance(v, (list, tuple)):
            return any(wants(u) for u in v)
        return False

    if any(wants(v) for v in values):
        return (f"{name}: an input or weight requires grad and grad is enabled, but the "
                "kernel has no backward; call it under torch.no_grad(), or on the CPU, "
                "whose plain twin differentiates")
    return ""


def refuse_grad(name: str, *values) -> None:
    """ValueError with grad_refusal's words, if it has any."""
    why = grad_refusal(name, *values)
    if why:
        raise ValueError(why)


class Route(NamedTuple):
    """How a driver serves a request: ``kind`` is "megakernel" (the fused
    clear-sky kernels), "staged" (NN gas optics then the RTE solvers; on
    CUDA through the MLP kernel and the LW transport kernel) or "refuse";
    ``reason`` says why the megakernel was not taken, or why the request
    is refused."""

    kind: str
    reason: str = ""


def resolve_use_megakernel(lw: bool = False, models=None, device=None,
                           dtype: torch.dtype = torch.float32,
                           n_gauss_angles: int = 1,
                           scan_mode: str = "sequential") -> Route:
    """The drivers' dispatch, taken once per call before any tensor
    reaches the card.

    The megakernel route needs ``config.use_megakernel`` (None = on when
    ``device`` is CUDA), float32, one Gauss angle, no numerics flag the
    kernels bake (``fast_exponential`` for both, ``use_pade_source`` for
    LW), sequential scans, models they hard-code, one LW net or an SW pair.
    Everything else is staged; on CUDA the staged path runs the MLP kernel,
    so it is refused for models that kernel does not take, and for float64
    (the kernels are float32)."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if models is not None and not lw and len(models) != 2:
        return Route("refuse", "SW needs an absorption and a Rayleigh model")
    refusal = cuda_dtype_refusal(device, dtype)
    if refusal:
        return Route("refuse", refusal)
    use = config.use_megakernel
    if use is None:
        use = on_cuda
    if not use:
        why = "config.use_megakernel is off"
    elif dtype != torch.float32:
        why = f"{dtype}: the fused kernels are float32"
    elif lw and n_gauss_angles != 1:
        why = "the fused LW kernel takes one angle"
    elif scan_mode != "sequential":
        why = "the fused kernels sweep sequentially; parallel scans take the general cores"
    elif config.fast_exponential or (lw and config.use_pade_source):
        why = "fast_exponential / use_pade_source are honored only by the staged path"
    elif models is not None and not megakernel_model_ok(models):
        why = "the fused kernels hard-code 3-layer softsign nets"
    elif models is not None and lw and len(models) != 1:
        why = "two-model LW takes the staged path"
    else:
        return Route("megakernel")
    if on_cuda and models is not None:
        refusal = mlp_kernel_refusal(models)
        if refusal:
            return Route("refuse", f"{why}, and {refusal}")
    return Route("staged", why)


def driver_route(entry: str, **kw) -> str:
    """The kind of ``resolve_use_megakernel(**kw)``'s route for the driver
    ``entry``: "megakernel" or "staged". A refusal raises
    NotImplementedError with its reason after the entry's name."""
    route = resolve_use_megakernel(**kw)
    if route.kind == "refuse":
        raise NotImplementedError(f"{entry}: {route.reason}")
    return route.kind


def set_checks(check_extents: bool | None = None, check_values: bool | None = None):
    """Turn the extent and value checks on or off (reference
    rte_rrtmgp_config_checks, mo_rte_rrtmgp_config.F90:43-61)."""
    if check_extents is not None:
        config.check_extents = check_extents
    if check_values is not None:
        config.check_values = check_values


@contextmanager
def config_override(**kwargs):
    old = {k: getattr(config, k) for k in kwargs}
    try:
        for k, v in kwargs.items():
            setattr(config, k, v)
        yield config
    finally:
        for k, v in old.items():
            setattr(config, k, v)
