"""PyTorch port against the JAX package: the layer-major broadband LW
no-scattering and SW two-stream solvers on seeded optical inputs, with the
numerics flags the staged path honors. Fluxes: LW atol 2e-3, SW atol 2e-2
W/m2 (the JAX package's own kernel-vs-staged bounds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
from rte_rrtmgp_nn_tpu.ops import sw_solver as jsw
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.ops import sw_solver as psw

NLAY, NCOL, NGPT = 10, 7, 16
LW_ATOL, SW_ATOL = 2e-3, 2e-2


def _f32(*arrs):
    return [np.asarray(a, np.float32) for a in arrs]


@pytest.mark.parametrize("flags", [{}, {"use_pade_source": True}, {"fast_exponential": True}])
def test_lw_solver_noscat_lay_major(rng, flags):
    # optical depths across the series-expansion threshold and beyond 1
    tau = np.exp(rng.uniform(np.log(1e-6), np.log(20.0), (NLAY, NCOL, NGPT)))
    # per-g-point Planck radiances of a 16-point spectrum (fluxes ~100 W/m2)
    lay = rng.uniform(0.5, 4.0, (NLAY, NCOL, NGPT))
    lev = rng.uniform(0.5, 4.0, (NLAY + 1, NCOL, NGPT))
    emis = rng.uniform(0.9, 1.0, (NCOL, NGPT))
    sfc = rng.uniform(2.0, 5.0, (NCOL, NGPT))
    tau, lay, lev, emis, sfc = _f32(tau, lay, lev, emis, sfc)
    with jco(**flags):
        ref = jlw.lw_solver_noscat_lay_major(*map(jnp.asarray, (tau, lay, lev, emis, sfc)))
    with pco(**flags):
        got = plw.lw_solver_noscat_lay_major(*map(torch.from_numpy, (tau, lay, lev, emis, sfc)))
    assert tuple(got.flux_up.shape) == (NCOL, NLAY + 1)
    np.testing.assert_allclose(got.flux_up.numpy(), np.asarray(ref.flux_up), atol=LW_ATOL)
    np.testing.assert_allclose(got.flux_dn.numpy(), np.asarray(ref.flux_dn), atol=LW_ATOL)


@pytest.mark.parametrize("flags", [{}, {"fast_exponential": True}])
def test_sw_solver_2stream_lay_major(rng, flags):
    tau = np.exp(rng.uniform(np.log(1e-6), np.log(5.0), (NLAY, NCOL, NGPT)))
    tau[0, 0, 0] = 0.0  # a transparent layer
    ssa = rng.uniform(0.0, 1.0, (NLAY, NCOL, NGPT))
    g = np.zeros_like(tau)
    mu0 = rng.uniform(0.05, 1.0, NCOL)
    inc = rng.uniform(0, 30, (NCOL, NGPT))
    alb_dir = rng.uniform(0.05, 0.5, (NCOL, NGPT))
    alb_dif = rng.uniform(0.05, 0.5, (NCOL, NGPT))
    args = _f32(tau, ssa, g, mu0, inc, alb_dir, alb_dif)
    with jco(**flags):
        ref = jsw.sw_solver_2stream_lay_major(*map(jnp.asarray, args))
    with pco(**flags):
        got = psw.sw_solver_2stream_lay_major(*map(torch.from_numpy, args))
    for name in ("flux_up", "flux_dn", "flux_dn_dir"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=SW_ATOL, err_msg=name)
    np.testing.assert_allclose(got.flux_dn_dir[:, 0].numpy(), (inc * mu0[:, None]).sum(-1),
                               rtol=1e-6)


def test_two_stream_coefficients(rng):
    """The PIFM coefficients themselves, elementwise: rtol 1e-5 with an
    absolute floor of 1e-5, since rdir and tdir are 0/0 forms near
    k*mu0 = 1 and lose digits there in float32."""
    tau = np.exp(rng.uniform(np.log(1e-5), np.log(10.0), (4, 6, 8))).astype(np.float32)
    ssa = rng.uniform(0, 1, tau.shape).astype(np.float32)
    g = rng.uniform(0, 0.8, tau.shape).astype(np.float32)
    mu0 = rng.uniform(0.05, 1, (6, 1)).astype(np.float32)
    ref = jsw._sw_two_stream_coeffs(*map(jnp.asarray, (tau, ssa, g, mu0)))
    got = psw.sw_two_stream_coeffs(*map(torch.from_numpy, (tau, ssa, g, mu0)), fast_exp=False)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
