"""The SW training recipe (scripts/torch_train_from_lut_sw.py on
training/lut_recipe: sw_training_set, PairState, pair_train_step,
SWFluxEval) against scripts/train_from_lut_sw.py's steps in the JAX
package, on test_training's mini RFMIP problem (3 experiments x 8 sites x
16 layers, two sites of each experiment at night) with the synthetic
56-g-point SW k-distribution, at a small width.

Parity, in float64 on both sides: both loops train the absorption and
Rayleigh nets jointly on the same gendata file (the JAX package's, read by
each package's loader) from the same numpy init on the same numpy batch
rows, each net with its own Adam and cosine decay. Losses agree to rtol
1e-9, each epoch's day-masked eval fluxes to rtol 1e-9 (float64
roundings), the metrics as test_torch_train_loop holds them (float32
reductions on both sides), and each epoch's radiation score to rtol 1e-6
of the float64 score of the JAX loop's fluxes: the JAX metric core's
float32 forcing biases leave its own score ~2e-6 off float64 on these SW
fluxes (held within 1e-5), the port's regrouped ones ~1e-7.
The scalings of the gendata file agree to 1e-12. Night columns come out
exactly zero.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import predict_nn_sw as jpredict_sw
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps2str as JOP2
from rte_rrtmgp_nn_tpu.rte import rte_sw as jrte_sw
from rte_rrtmgp_nn_tpu.training import eval_loop as jev
from rte_rrtmgp_nn_tpu.training import gendata as jgen
from rte_rrtmgp_nn_tpu.training import train as jtrain
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload_kdist
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.training import eval_loop as pev
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
from rte_rrtmgp_nn_tpu_torch.training import train as ptrain
from test_lut_gas_optics import GASES
from test_torch_core import CPU
from test_torch_gendata import port_data
from test_torch_shard_ops import _metrics64
from test_training import mini_rfmip  # noqa: F401  (fixture)

F64 = torch.float64
HIDDEN, NPAIRS, EPOCHS, STEPS, LR, ALPHA, EMA = 16, 32, 2, 5, 3e-3, 0.6, 0.8


class JPairState(NamedTuple):
    """scripts/train_from_lut_sw.py's PairState."""

    abs_state: jtrain.TrainState
    ray_state: jtrain.TrainState

    @property
    def model(self):
        return (self.abs_state.model, self.ray_state.model)


@pytest.fixture(scope="module")
def problem(tmp_path_factory, mini_rfmip):
    d = mini_rfmip
    sza = np.array(d.sza, np.float32)
    sza[np.arange(d.ncol) % d.nsites < 2] = 100.0  # two night sites per experiment
    d = dataclasses.replace(d, sza=sza)
    tmp = tmp_path_factory.mktemp("sw")
    kd_path = str(tmp / "sw.nc")
    generate_kdist_nc(kd_path, kind="sw", gpts_per_band=4, nband=14)
    jkd = jload_kdist(kd_path, GASES)
    train_nc = str(tmp / "train.nc")
    gen = jgen.generate_sw_training_data(train_nc, jkd, d, gas_order=GASES)
    return d, kd_path, jkd, train_nc, gen


def _init_arrays(ts, k, ngpt, seed):
    rng = np.random.default_rng(seed)
    dims = [ts.xs.shape[-1], HIDDEN, HIDDEN, ngpt]
    ws = [rng.normal(0, np.sqrt(2.0 / a), (a, b)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [np.zeros(b) for b in dims[1:]]
    return (ws, bs, ("softsign", "softsign", "linear"), ("tlay", "play") + tuple(GASES),
            ts.xmin, ts.xmax, ts.out_mean[k], ts.out_std[k])


def _jax_scalings(train_nc):
    """scripts/train_from_lut_sw.py's step 3, in the JAX package."""
    x_un, y_abs, cd = jgen.load_training_data(train_nc, "sw_absorption")
    _, y_ray, _ = jgen.load_training_data(train_nc, "sw_rayleigh")

    def scaled(y):
        ysig = np.asarray(jtrain.scale_outputs_tau(jnp.asarray(y), jnp.asarray(cd)))
        ymean, ystd = jtrain.standardize_coeffs(ysig)
        return (ysig - ymean) / ystd, ymean, ystd

    return scaled(y_abs), scaled(y_ray), x_un


def test_sw_training_set_matches_the_jax_scalings(problem):
    _, _, _, train_nc, _ = problem
    ts = R.sw_training_set(train_nc)
    (ya, ma, sa), (yr, mr, sr), x_un = _jax_scalings(train_nc)
    np.testing.assert_allclose(ts.ys_abs, ya, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ts.ys_ray, yr, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ts.out_mean[0], ma.astype(np.float32))
    np.testing.assert_array_equal(ts.out_std[1], sr.astype(np.float32))
    xmin, xmax = x_un.min(0), x_un.max(0)
    np.testing.assert_array_equal(ts.xs, (x_un - xmin) / np.where(xmax > xmin, xmax - xmin, 1.0))


def test_sw_loop_matches_jax_in_float64(problem, tmp_path):
    d, kd_path, jkd, train_nc, gen = problem
    ncol, nlay = d.play.shape
    ref_up, ref_dn = gen["rsu"].reshape(ncol, nlay + 1), gen["rsd"].reshape(ncol, nlay + 1)
    ts = R.sw_training_set(train_nc)
    arrays = [_init_arrays(ts, k, jkd.ngpt, k) for k in range(2)]
    rng = np.random.default_rng(5)
    rows = [R.sample_pair_rows(rng, d.nexp, d.nsites, nlay, NPAIRS) for _ in range(EPOCHS * STEPS)]
    T = EPOCHS * STEPS
    usecol = np.asarray(d.sza < 90.0)[:, None]
    assert 0 < usecol.sum() < ncol

    # -- the JAX loop (scripts/train_from_lut_sw.py's steps, float64) -----
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))

    def jmodel(a):
        ws, bs, acts, names, mn, mx, om, os_ = a
        return jnet.NNModel(tuple(map(f64, ws)), tuple(map(f64, bs)), acts, names, f64(mn),
                            f64(mx), f64(om), f64(os_))

    opts = [optax.adam(optax.cosine_decay_schedule(LR, T, alpha=1e-2)) for _ in range(2)]
    jm = [jmodel(a) for a in arrays]
    jstate = JPairState(*(jtrain.TrainState(m, o.init(m), jnp.zeros((), jnp.int32))
                          for m, o in zip(jm, opts)))
    jsteps = [jax.jit(jtrain.make_train_step(o, alpha=ALPHA)) for o in opts]
    jpairs = jnp.stack([jnp.arange(NPAIRS), jnp.arange(NPAIRS) + NPAIRS], axis=1)
    jxs, jya, jyr = f64(ts.xs), f64(ts.ys_abs), f64(ts.ys_ray)
    col_dry, x_full = f64(ts.col_dry.reshape(ncol, nlay)), f64(ts.xs.reshape(ncol, nlay, -1))
    mu0 = f64(np.clip(np.cos(np.deg2rad(d.sza)), 0.01, 1.0))
    toa = jnp.broadcast_to(f64(jkd.solar_source())[None, :], (ncol, jkd.ngpt))
    alb = f64(d.sfc_alb)[:, None] * jnp.ones((1, jkd.ngpt))

    @jax.jit
    def flux_of(models):
        tau, ssa = jpredict_sw(list(models), x_full, col_dry, use_pallas=False)
        sol = jrte_sw(JOP2(tau, ssa, jnp.zeros_like(tau), jkd.spectral), d.top_at_1, mu0, toa,
                      alb, alb, broadband=True)
        return sol.flux_up, sol.flux_dn

    jlosses, jfluxes, jit_rows = [], [], iter(rows)

    def jstep(st, x, y):
        sa, la = jsteps[0](st.abs_state, x, y[0], jpairs)
        sr, lr = jsteps[1](st.ray_state, x, y[1], jpairs)
        jlosses.append(float(la + lr))
        return JPairState(sa, sr), la + lr

    def jeval(models):
        up, dn = flux_of(models)
        up, dn = np.asarray(up) * usecol, np.asarray(dn) * usecol
        jfluxes.append((up, dn))
        return jev.eval_metrics(up, dn, ref_up * usecol, ref_dn * usecol,
                                np.asarray(d.plev, np.float64), d.nexp, top_at_1=d.top_at_1)

    def jbatch():
        i = next(jit_rows)
        return jxs[i], (jya[i], jyr[i])

    jres = jev.train_with_radiation_eval(jstate, jstep, jbatch, jeval, R.REF_SCORES,
                                         n_epochs=EPOCHS, steps_per_epoch=STEPS, verbose=False,
                                         ema_decay=EMA)

    # -- the port's loop ---------------------------------------------------
    pkd = pload_kdist(kd_path, GASES, device=CPU)
    states = []
    for a in arrays:
        m = nn_model_from_arrays(*a, device=CPU, dtype=F64)
        for p in m.parameters():
            p.requires_grad_(True)
        opt = torch.optim.Adam(m.parameters(), lr=LR, eps=1e-8)
        states.append(ptrain.TrainState(m, opt, scheduler=ptrain.scheduled(
            opt, ptrain.cosine_decay_schedule(LR, T, alpha=1e-2))))
    state = R.PairState(*states)
    step = R.pair_train_step(ptrain.make_train_step(alpha=ALPHA),
                             ptrain.make_train_step(alpha=ALPHA), R.pair_index(NPAIRS, CPU))
    pxs, pya, pyr = (torch.as_tensor(a, dtype=F64) for a in (ts.xs, ts.ys_abs, ts.ys_ray))
    ev = R.SWFluxEval(pkd, port_data(d), ts, ref_up, ref_dn, CPU, dtype=F64)
    plosses, pfluxes, pit_rows = [], [], iter(rows)

    def pstep(st, x, y):
        st, loss = step(st, x, y)
        plosses.append(float(loss))
        return st, loss

    def peval(models):
        up, dn = ev.fluxes(models)
        pfluxes.append((up.numpy(), dn.numpy()))
        return ev.metrics(models)

    def pbatch():
        i = torch.as_tensor(next(pit_rows))
        return pxs[i], (pya[i], pyr[i])

    pres = pev.train_with_radiation_eval(state, pstep, pbatch, peval, R.REF_SCORES,
                                         n_epochs=EPOCHS, steps_per_epoch=STEPS, verbose=False,
                                         ema_decay=EMA)

    np.testing.assert_allclose(plosses, jlosses, rtol=1e-9)
    assert len(pfluxes) == len(jfluxes) == EPOCHS and state.step == T
    for (pu, pdn), (ju, jdn) in zip(pfluxes, jfluxes):
        np.testing.assert_allclose(pu, ju, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(pdn, jdn, rtol=1e-9, atol=1e-12)
        assert not pu[~usecol[:, 0]].any() and not pdn[~usecol[:, 0]].any()
    # the scores: the JAX core's float32 forcing biases are ~2e-6 of the
    # score off float64 on these SW fluxes (the port's regrouped ones ~1e-7),
    # so float64 of the JAX loop's fluxes decides at 1e-6
    rs = lambda a: np.asarray(a, np.float64).reshape(d.nexp, d.nsites, -1)
    plev = np.broadcast_to(np.asarray(d.plev, np.float64), (ncol, nlay + 1))
    for ph, jh, (ju, jdn) in zip(pres.history, jres.history, jfluxes):
        score64 = jev.radiation_score(
            _metrics64(rs(ju), rs(jdn), rs(ref_up * usecol), rs(ref_dn * usecol), rs(plev),
                       top_at_1=d.top_at_1), R.REF_SCORES)
        np.testing.assert_allclose(ph["metrics"], jh["metrics"], rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(ph["score"], score64, rtol=1e-6)
        np.testing.assert_allclose(jh["score"], score64, rtol=1e-5)
        np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-9)
    assert pres.best_epoch == jres.best_epoch
    for pm, jm_ in zip(pres.best_model, jres.best_model):
        for a, b in zip(pm.weights, jm_.weights):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-15)
    assert not any(p.requires_grad for p in pres.best_model.parameters())
