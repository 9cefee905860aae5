"""The LW radiation eval of the training loop in float64: the port's
training/lut_recipe.LWFluxEval against the JAX chain that
scripts/train_from_lut.py evaluates (predict_nn_lw -> compute_planck_source_nn
-> rte_lw(broadband=True)), with the same weights, on test_training's mini
RFMIP problem (3 experiments x 8 sites x 16 layers, 64 g-points).

The finding this states: both chains are float64 throughout, but the
linear-in-tau LW source ((1 - T)/tau - T, for sqrt(eps) < tau < ~1e-4)
cancels, so one ulp of the transmittance T moves the down flux near the
top of the atmosphere by ~1e-8 relative. torch's float64 exp and XLA's
differ by one ulp in about a tenth of the arguments; the port takes the
float64 transmittance in XLA's rational form (ops/expfast.exp_rational_f64),
and the two chains agree in flux_dn to 1e-12 relative (4e-8 with torch's
exp, which the test shows too)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.training import gendata as jgen
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload_kdist
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.ops.expfast import exp_rational_f64, fma_f64
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
from test_lut_gas_optics import GASES
from test_torch_core import CPU
from test_torch_gendata import port_data
from test_torch_train_loop import _init_arrays, _jax_flux_fn, kd_path  # noqa: F401
from test_training import mini_rfmip  # noqa: F401  (fixture)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_weights_through_both_eval_paths(kd_path, mini_rfmip, tmp_path, monkeypatch,
                                              seed):
    d = mini_rfmip
    ncol, nlay = d.play.shape
    jkd = jload_kdist(kd_path, GASES)
    train_nc = str(tmp_path / "train.nc")
    gen = jgen.generate_lw_training_data(train_nc, jkd, d, gas_order=GASES)
    ts = R.lw_training_set(train_nc, jkd.ngpt)
    arrays = _init_arrays(ts, ts.xs.shape[-1], jkd.ngpt, seed=seed)
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))
    ws, bs, acts, names, mn, mx, om, os_ = arrays
    jm = jnet.NNModel(tuple(map(f64, ws)), tuple(map(f64, bs)), acts, names, f64(mn), f64(mx),
                      f64(om), f64(os_))
    ju, jd = (np.asarray(a) for a in _jax_flux_fn(jkd, d, ts)(jm))
    ev = R.LWFluxEval(pload_kdist(kd_path, GASES, device=CPU), port_data(d), ts,
                      gen["rsu"].reshape(ncol, -1), gen["rsd"].reshape(ncol, -1), CPU,
                      dtype=torch.float64)
    with torch.no_grad():
        pu, pdn = ev.fluxes(nn_model_from_arrays(*arrays, device=CPU, dtype=torch.float64))
    assert pdn.dtype == torch.float64 and pdn.shape == (ncol, nlay + 1)
    assert float(pdn[:, 1:11].min()) < 0.05  # the thin top layers hold little flux
    # atol 1e-14 W/m2: under float64's resolution of the column's largest
    # fluxes (~300 W/m2 x 1.1e-16); the two float64 matrix products sum in
    # other orders, and a Planck fraction y**2 with y near 0 keeps that
    np.testing.assert_allclose(pdn.numpy(), jd, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pu.numpy(), ju, rtol=1e-12, atol=1e-14)
    # the finding: with torch's exp the thin top layers are ~1e-8 apart
    with monkeypatch.context() as m:
        m.setattr(plw, "exp_rational_f64", torch.exp)
        with torch.no_grad():
            _, dn_torch_exp = ev.fluxes(nn_model_from_arrays(*arrays, device=CPU,
                                                             dtype=torch.float64))
    rel = np.abs(dn_torch_exp.numpy() - jd) / np.maximum(np.abs(jd), 1e-300)
    assert rel[:, 1:].max() > 1e-9


def test_exp_rational_f64_is_xlas_exp():
    """Bit for bit XLA's float64 exp over the transmittance's range and
    beyond, and the edges; torch's exp is one ulp off in a tenth."""
    rng = np.random.default_rng(0)
    x = -np.exp(rng.uniform(np.log(1e-12), np.log(700.0), 400_000))
    x = np.concatenate([x, -x[:1000]])
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(exp_rational_f64(torch.as_tensor(x)).numpy(), ref)
    assert np.mean(torch.exp(torch.as_tensor(x)).numpy() != ref) > 0.01
    edges = torch.tensor([0.0, -800.0, 800.0, -708.0, 1.0], dtype=torch.float64)
    out = exp_rational_f64(edges)
    assert out[0] == 1.0 and out[1] == 0.0 and out[2] == float("inf")
    np.testing.assert_allclose(out[3:].numpy(), np.exp(edges[3:].numpy()), rtol=1e-15)


def test_fma_f64_rounds_once():
    """fma_f64 against the exact a * b + c rounded once (fractions)."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    a = rng.normal(size=3000) * np.exp(rng.uniform(-30, 30, 3000))
    b = rng.normal(size=3000)
    c = rng.normal(size=3000) * np.exp(rng.uniform(-30, 30, 3000))
    exact = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    got = fma_f64(*map(torch.as_tensor, (a, b, c))).numpy()
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(fma_f64(torch.as_tensor(a), 1.7, 0.5).numpy(),
                                  [float(Fraction(x) * Fraction(1.7) + Fraction(0.5)) for x in a])
