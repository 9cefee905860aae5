"""Fast exponential for nonpositive arguments (FAST_EXPONENTIAL parity).

Port of rte_rrtmgp_nn_tpu/ops/expfast.py (reference ``exp_fast``,
rte/kernels/mo_rte_solver_kernels.F90:90-106): a Pade approximant applied
to ``x/8`` and squared three times. Also ``exp_rational_f64``, the
float64 exponential in the rational form that the JAX package's float64
chain gets from XLA on the CPU.
"""
from __future__ import annotations

import struct

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


def _f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# XLA's float64 exp on the CPU (jax 0.9): clamp, n = floor(x log2(e) + 1/2),
# g = x - n ln2 in two parts, exp(g) = 1 + 2 P(g) / (Q(g) - P(g)) (Cephes'
# rational form), then 2^n as 2^b 2^b 2^b 2^(n - 3b), b = n >> 2; its
# multiply-adds are fused (one rounding each).
_EXP_LO, _EXP_HI = _f64(0xC086232BDD7ABCD2), _f64(0x40862E42FEFA39EF)
_LOG2E = _f64(0x3FF71547652B82FE)
_LN2_HI, _LN2_LO = _f64(0x3FE62E4000000000), _f64(0x3EB7F7D1CF79ABCA)
_P = (_f64(0x3F2089CDD5E44BE8), _f64(0x3F9F06D10CCA2C7E))
_Q = (_f64(0x3EC92EB6BC365FA0), _f64(0x3F64AE39B508B6C0), _f64(0x3FCD17099887E074))
_SPLIT = 134217729.0  # 2^27 + 1, Dekker's splitter for float64


def _two_sum(a, b):
    """(s, e): s = a + b rounded, e its exact error (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """(hi, lo), a = hi + lo exactly, each of at most 26 significant bits
    (Dekker); a tensor or a Python float."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c of float64 values with one rounding, from unfused IEEE
    operations: Dekker's exact product, Knuth's exact sum, the low parts
    added in round-to-odd and the result rounded once (Boldo and Melquiond,
    IEEE Trans. Computers 57, 2008). Exact while nothing over- or
    underflows; ``b`` and ``c`` may be Python floats (split on the host)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    uh = a * b
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(uh, c)
    v, err = _two_sum(tl, ul)
    inexact_even = (err != 0) & ((v.view(torch.int64) & 1) == 0)
    odd = torch.nextafter(v, torch.copysign(torch.full_like(v, float("inf")), err))
    return th + torch.where(inexact_even, odd, v)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    return ((k + 1023) << 52).view(torch.float64)


def exp_rational_f64(x: torch.Tensor) -> torch.Tensor:
    """exp(x) of a float64 tensor, rounded as the JAX package's float64
    chain rounds it on the CPU: XLA's rational form, step for step, its
    fused multiply-adds as ``fma_f64``. torch.exp differs from it by one
    ulp in about a tenth of the arguments, and the linear-in-tau LW source
    ((1 - T)/tau - T for sqrt(eps) < tau < ~1e-4) turns one ulp of T into
    ~1e-8 of the down flux near the top of the atmosphere."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma_f64(xc, _LOG2E, 0.5))
    g = fma_f64(-n, _LN2_LO, fma_f64(-n, _LN2_HI, xc))
    g2 = g * g
    p = fma_f64(fma_f64(g2, _P[0], _P[1]), g2, 1.0) * g
    q = fma_f64(fma_f64(fma_f64(g2, _Q[0], _Q[1]), g2, _Q[2]), g2, 2.0)
    e = (p / (q - p)) * 2.0 + 1.0
    k = n.to(torch.int64).clamp(-2099, 2099)
    b = k >> 2
    s = _pow2(b)
    out = ((e * s) * s) * s * _pow2(k - 3 * b)
    out = torch.where(x < _EXP_LO, torch.zeros_like(out), out)
    return torch.where(x > _EXP_HI, torch.full_like(out, float("inf")), out)
