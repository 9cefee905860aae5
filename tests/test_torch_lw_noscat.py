"""PyTorch port against the JAX package: the plain twin of the LW
no-scattering broadband transport kernel (K7, lw_noscat_broadband) against
the JAX Pallas kernel lw_noscat_broadband_pallas in interpret mode, with
column and layer counts that are not multiples of its tile and chunk,
per-(column, g-point) secants, an incident radiance, and both orientations
through lw_solver_noscat's dispatch. Bound: rtol 2e-6, atol 1e-5 W/m2
(tests/test_pallas_lw_solver.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
from rte_rrtmgp_nn_tpu.ops.pallas.lw_solver import lw_noscat_broadband_pallas
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

RTOL, ATOL = 2e-6, 1e-5
NGPT = 32


def _problem(rng, ncol, nlay, ngpt=NGPT):
    f = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    return (f(1e-4, 3.0, ncol, nlay, ngpt), f(0.1, 1.0, ncol, nlay, ngpt),
            f(0.1, 1.0, ncol, nlay + 1, ngpt), f(0.8, 1.0, ncol, ngpt), f(0.1, 1.0, ncol, ngpt))


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


# ncol 13 and 21 are not multiples of the Pallas tile (8), nlay 12 and 23
# not of its chunk (5)
@pytest.mark.parametrize("ncol,nlay", [(13, 12), (21, 23)])
def test_twin_matches_pallas(rng, ncol, nlay):
    arrs = _problem(rng, ncol, nlay)
    ref = lw_noscat_broadband_pallas(*map(jnp.asarray, arrs), tile_c=8, chunk=5, interpret=True)
    got = k7.lw_noscat_broadband_plain(*map(torch.from_numpy, arrs))
    assert tuple(got[0].shape) == (ncol, nlay + 1)
    _close(got, ref)


def test_twin_with_secants_and_incident_radiance(rng):
    ncol, nlay = 11, 9
    arrs = _problem(rng, ncol, nlay)
    ds = rng.uniform(1.2, 2.8, (ncol, NGPT)).astype(np.float32)
    inc = rng.uniform(0.0, 1.0, (ncol, NGPT)).astype(np.float32)
    ref = lw_noscat_broadband_pallas(*map(jnp.asarray, arrs), d_secant=jnp.asarray(ds),
                                     weight=0.3, inc_rad=jnp.asarray(inc), tile_c=8, chunk=3,
                                     interpret=True)
    got = k7.lw_noscat_broadband_plain(*map(torch.from_numpy, arrs), torch.from_numpy(ds), 0.3,
                                       torch.from_numpy(inc))
    _close(got, ref)
    # the wrapper on CPU tensors is the twin and launches nothing
    n = k7.LAUNCHES
    for a, b in zip(k7.lw_noscat_broadband(*map(torch.from_numpy, arrs), torch.from_numpy(ds),
                                           0.3, torch.from_numpy(inc)), got):
        assert torch.equal(a, b)
    assert k7.LAUNCHES == n


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_dispatch_through_lw_solver_noscat(rng, monkeypatch, top_at_1, n_angles):
    """The broadband solve goes through the transport kernel's angles
    entry (its twin on the CPU) in one call carrying every angle's weight,
    with an incident flux and flipped orientation, and agrees with the JAX
    solver; under fast_exponential (which the kernel does not take, as in
    the JAX package) the entry is not called."""
    ncol, nlay = 9, 10
    arrs = _problem(rng, ncol, nlay)
    inc = rng.uniform(0.0, 5.0, (ncol, NGPT)).astype(np.float32)
    calls = []
    wrapper = k7.lw_noscat_broadband_angles
    monkeypatch.setattr(k7, "lw_noscat_broadband_angles",
                        lambda *a, **k: calls.append(list(a[6])) or wrapper(*a, **k))
    t = [torch.from_numpy(a) for a in arrs]
    for fast in (False, True):
        with jco(fast_exponential=fast):
            ref = jlw.lw_solver_noscat(*map(jnp.asarray, arrs), inc_flux=jnp.asarray(inc),
                                       top_at_1=top_at_1, n_gauss_angles=n_angles,
                                       broadband=True)
        with pco(fast_exponential=fast):
            got = plw.lw_solver_noscat(*t, inc_flux=torch.from_numpy(inc), top_at_1=top_at_1,
                                       n_gauss_angles=n_angles, broadband=True)
        _close((got.flux_up, got.flux_dn), (ref.flux_up, ref.flux_dn))
        assert calls == ([] if fast else [list(plw.GAUSS_WTS[n_angles - 1, :n_angles])])
        calls.clear()


def test_wrapper_refuses_other_devices():
    arrs = [torch.zeros(s).to("meta") for s in ((2, 3, 4), (2, 3, 4), (2, 4, 4), (2, 4), (2, 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        k7.lw_noscat_broadband(*arrs)
