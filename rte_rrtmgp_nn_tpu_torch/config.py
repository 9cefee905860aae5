"""Runtime configuration (port of rte_rrtmgp_nn_tpu/config.py).

The missing-gas scenario index for the NN input packing, the working
precision, the two numerics flags the reference exposes as preprocessor
macros (``FAST_EXPONENTIAL``, ``use_Pade_source``), and the switch for the
fused clear-sky kernels.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


def tau_thresh_for(dtype: torch.dtype) -> float:
    """Series-expansion threshold of the linear-in-tau LW source: sqrt(eps)
    of ``dtype``, rounded in ``dtype``."""
    return float(torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype)))


@dataclasses.dataclass
class RTEConfig:
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


def megakernel_model_ok(models) -> bool:
    """The fused kernels hard-code the shipped NN architecture: three dense
    layers, softsign hidden activations, linear output."""
    return all(
        len(m.weights) == 3 and len(m.biases) == 3
        and tuple(a.lower() for a in m.activations)
        == ("softsign", "softsign", "linear")
        for m in models
    )


def resolve_use_megakernel(lw: bool = False, models=None, device=None,
                           dtype: torch.dtype = torch.float32) -> tuple[bool, str]:
    """(use, reason): whether the drivers take the fused kernels, and if
    not, why, naming the kernel still to be ported that would take the
    request. ``config.use_megakernel`` (None = on when ``device`` is CUDA),
    forced off by a precision other than float32, by a numerics flag the
    kernels bake (``fast_exponential`` for both, ``use_pade_source`` for LW),
    or by models the kernels do not hard-code. The drivers raise with the
    reason on CUDA, where no plain path runs."""
    use = config.use_megakernel
    if use is None:
        use = device is not None and torch.device(device).type == "cuda"
    if not use:
        return False, ("config.use_megakernel is off: the staged path has no "
                       "GPU kernels yet (K3-K7, ROADMAP Queue 2)")
    if dtype != torch.float32:
        return False, f"{dtype} runs only on the CPU; the kernels are float32"
    if config.fast_exponential or (lw and config.use_pade_source):
        return False, ("fast_exponential / use_pade_source are honored only by "
                       "the staged path, whose GPU kernels K3 "
                       "(fused_predict_lw_both) and K7 (lw_noscat_broadband_pallas) "
                       "are still to be ported (ROADMAP Queue 2)")
    if models is not None:
        if not megakernel_model_ok(models):
            return False, ("models other than 3-layer softsign nets need kernel "
                           + ("K3 (fused_predict_lw_both)" if lw else "K5 (fused_predict_sw)")
                           + ", still to be ported (ROADMAP Queue 2)")
        if lw and len(models) != 1:
            return False, ("two-model LW needs kernel K4 (fused_predict_tau), "
                           "still to be ported (ROADMAP Queue 2)")
        if not lw and len(models) != 2:
            return False, "SW needs an absorption and a Rayleigh model"
    return True, ""


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
