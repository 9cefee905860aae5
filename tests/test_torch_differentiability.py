"""End-to-end differentiability of the port on the CPU: gradients flow
through the NN gas optics, the Planck sources and the LW solver (the plain
twins of K3 and K7, which differentiate; the CUDA kernels have no backward
and refuse, tests/test_torch_f8.py), the counterparts of
tests/test_differentiability.py on the repository's g-128 LW demo net:

  - gradients reach every weight and bias, and equal the JAX package's
    gradients of the same loss in float64 (rtol 1e-6: float64 roundings
    through (...)**8 and the solver's exponentials);
  - a directional derivative agrees with central finite differences
    (within 5%, as in the JAX test);
  - a few Adam steps on the flux loss lower it by 10x.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu import gas_concs as jgc
from rte_rrtmgp_nn_tpu.gasoptics import nn_gas_optics as jgo
from rte_rrtmgp_nn_tpu.gasoptics import planck as jpl
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl as JOP
from rte_rrtmgp_nn_tpu.rte import rte_lw as jrte_lw
from rte_rrtmgp_nn_tpu.sources import SourceFuncLW as JSrc
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
    PlanckTable, compute_planck_source_nn, lw_spectral_g128)
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalProps1scl
from rte_rrtmgp_nn_tpu_torch.rte import rte_lw
from rte_rrtmgp_nn_tpu_torch.sources import SourceFuncLW
from test_torch_core import CPU, LW_MODEL

NCOL, NLAY = 4, 12


def _atmos():
    plev = np.exp(np.linspace(np.log(100.0), np.log(101325.0), NLAY + 1))
    plev = np.broadcast_to(plev, (NCOL, NLAY + 1)).astype(np.float64)
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = 230 + 60 * (play / play.max()) ** 0.3
    tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]), tlay[:, -1:]], 1)
    gases = {"h2o": 3e-3 * (play / play.max()) ** 1.5 + 1e-6, "co2": 4e-4, "o3": 5e-7,
             "n2o": 3.2e-7, "ch4": 1.8e-6}
    return play, plev, tlay, tlev, tlev[:, -1] + 2, gases


def _model(dtype=torch.float64):
    m = load_model_netcdf(LW_MODEL, device=CPU, dtype=dtype)
    for p in m.parameters():
        p.requires_grad_(True)
    return m


def _flux_up(model, gases, table, spec, dtype=torch.float64):
    play, plev, tlay, tlev, tsfc, _ = (torch.as_tensor(a, dtype=dtype) if isinstance(a, np.ndarray)
                                       else a for a in _atmos())
    gc = GasConcs.create({k: np.asarray(v, np.float64) for k, v in gases.items()})
    col_dry = go.get_col_dry(gc.get_vmr("h2o", NCOL, NLAY).to(dtype), plev)
    x = go.compute_nn_inputs(play, tlay, gc, model)
    tau, pfrac = go.predict_nn_lw([model], x, col_dry)
    lay, lev, sfc, jac = compute_planck_source_nn(pfrac, tlay, tlev, tsfc, spec, table)
    emis = torch.full((NCOL, spec.nband), 0.98, dtype=dtype)
    return rte_lw(OpticalProps1scl(tau, spec), True, SourceFuncLW(lay, lev, sfc, jac, spec),
                  emis, broadband=True).flux_up


@pytest.fixture(scope="module")
def setup():
    spec = lw_spectral_g128()
    return spec, PlanckTable.compute(spec.band_lims_wvn_array, device=CPU, dtype=torch.float64)


def _loss(model, target, setup, gases=None):
    spec, table = setup
    up = _flux_up(model, gases or _atmos()[5], table, spec)
    return torch.mean((up - target) ** 2)


def _jax_grads(target):
    """The JAX package's gradient of the same loss in float64."""
    play, plev, tlay, tlev, tsfc, gases = (jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                           for a in _atmos())
    jm = jnet.load_model_netcdf(LW_MODEL)
    jm = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jm)
    gc = jgc.GasConcs.create({k: np.asarray(v, np.float64) for k, v in gases.items()})
    spec = jpl.lw_spectral_g128()
    table = jpl.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float64)

    def loss(m):
        col_dry = jgo.get_col_dry(gc.get_vmr("h2o", NCOL, NLAY), plev)
        x = jgo.compute_nn_inputs(play, tlay, gc, m)
        tau, pfrac = jgo.predict_nn_lw([m], x, col_dry, use_pallas=False)
        lay, lev, sfc, jacs = jpl.compute_planck_source_nn(pfrac, tlay, tlev, tsfc, spec, table)
        emis = jnp.full((NCOL, spec.nband), 0.98)
        sol = jrte_lw(JOP(tau, spec), True, JSrc(lay, lev, sfc, jacs, spec), emis, broadband=True)
        return jnp.mean((sol.flux_up - jnp.asarray(target)) ** 2)

    return jax.grad(loss)(jm)


def test_gradients_reach_every_weight_and_match_jax(setup):
    m = _model()
    target = torch.zeros((NCOL, NLAY + 1), dtype=torch.float64)
    _loss(m, target, setup).backward()
    for name, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.norm()) > 0, name
    g = _jax_grads(np.zeros((NCOL, NLAY + 1)))
    for i in range(3):
        np.testing.assert_allclose(m.weights[i].grad.numpy(), np.asarray(g.weights[i]),
                                   rtol=1e-6, atol=1e-9 * float(m.weights[i].grad.abs().max()))
        np.testing.assert_allclose(m.biases[i].grad.numpy(), np.asarray(g.biases[i]),
                                   rtol=1e-6, atol=1e-9 * float(m.biases[i].grad.abs().max()))


def test_finite_difference_agreement(setup):
    """The directional derivative along a random direction of the weights
    and biases, against central differences through the whole pipeline."""
    m = _model()
    target = torch.full((NCOL, NLAY + 1), 100.0, dtype=torch.float64)
    _loss(m, target, setup).backward()
    gen = torch.Generator().manual_seed(1)
    dirs = [torch.randn(p.shape, generator=gen, dtype=p.dtype) for p in m.parameters()]
    dot = sum(float((p.grad * d).sum()) for p, d in zip(m.parameters(), dirs))
    eps = 1e-3
    losses = []
    with torch.no_grad():
        for sign in (1.0, -1.0):
            for p, d in zip(m.parameters(), dirs):
                p.add_(sign * eps * d)
            losses.append(float(_loss(m, target, setup)))
            for p, d in zip(m.parameters(), dirs):
                p.sub_(sign * eps * d)
    fd = (losses[0] - losses[1]) / (2 * eps)
    assert abs(fd - dot) / (abs(dot) + 1e-8) < 0.05, (fd, dot)


def test_flux_finetuning_reduces_loss(setup):
    """A re-tuning task: the target is the net's own upward flux with CO2
    doubled; 40 Adam steps at 3e-6 (the **8 postprocessing amplifies the
    gradients) on the flux loss through the solver lower it 10x."""
    m = _model()
    gases = dict(_atmos()[5], co2=8e-4)
    with torch.no_grad():
        target = _flux_up(m, gases, setup[1], setup[0])
    opt = torch.optim.Adam(m.parameters(), lr=3e-6)
    l0 = None
    for _ in range(40):
        opt.zero_grad()
        loss = _loss(m, target, setup)
        l0 = float(loss.detach()) if l0 is None else l0
        loss.backward()
        opt.step()
    with torch.no_grad():
        assert float(_loss(m, target, setup)) < 0.1 * l0
