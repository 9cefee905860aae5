"""Fast exponential for nonpositive arguments (FAST_EXPONENTIAL parity).

Port of rte_rrtmgp_nn_tpu/ops/expfast.py (reference ``exp_fast``,
rte/kernels/mo_rte_solver_kernels.F90:90-106): a Pade approximant applied
to ``x/8`` and squared three times.
"""
from __future__ import annotations

import torch

from ..config import config


def exp_fast(x: torch.Tensor) -> torch.Tensor:
    """The Pade form itself, unconditionally."""
    ex = 1.0 / (1.0 + x * (-0.125 + x * (0.0078125 - 0.000325520833333333 * x)))
    ex = ex * ex
    ex = ex * ex
    return ex * ex


def exp_maybe_fast(x: torch.Tensor) -> torch.Tensor:
    """exp(x), or ``exp_fast`` under ``config.fast_exponential``."""
    if config.fast_exponential:
        return exp_fast(x)
    return torch.exp(x)
