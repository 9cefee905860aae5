"""Host-side array checks for ``config.check_values``.

Port of rte_rrtmgp_nn_tpu/utils/validation.py (reference
rte/mo_rte_util_array.F90:21-39: ``any_vals_less_than``,
``any_vals_outside``, ``extents_are``, ``zero_array``). The checks read the values, so on
a CUDA tensor each one synchronizes with the card.
"""
from __future__ import annotations

import torch


def _masked(array: torch.Tensor, mask, fill: float) -> torch.Tensor:
    a = torch.as_tensor(array)
    if mask is None:
        return a
    return torch.where(torch.as_tensor(mask, dtype=torch.bool, device=a.device), a, fill)


def _nanmin(a: torch.Tensor) -> float:
    a = a[~torch.isnan(a)]
    return float(a.min()) if a.numel() else float("nan")


def _nanmax(a: torch.Tensor) -> float:
    a = a[~torch.isnan(a)]
    return float(a.max()) if a.numel() else float("nan")


def any_vals_less_than(array, check_value, mask=None) -> bool:
    """Whether any (unmasked, non-NaN) value is below ``check_value``."""
    if mask is not None and not bool(torch.as_tensor(mask).any()):
        return False
    return _nanmin(_masked(array, mask, float("inf"))) < check_value


def any_vals_outside(array, check_min, check_max, mask=None) -> bool:
    """Whether any (unmasked, non-NaN) value lies outside
    [check_min, check_max]."""
    if mask is not None and not bool(torch.as_tensor(mask).any()):
        return False
    lo = _nanmin(_masked(array, mask, float("inf")))
    hi = _nanmax(_masked(array, mask, float("-inf")))
    return lo < check_min or hi > check_max


def extents_are(array, *extents: int) -> bool:
    return tuple(array.shape) == tuple(extents)


def zero_array(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
