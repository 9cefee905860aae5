"""The slice as a whole: gendata -> train -> radiation-in-the-loop eval ->
save -> reload, the port against the JAX package's loop, on test_training's
mini RFMIP problem (3 experiments x 8 sites x 16 layers) with the
synthetic 64-g-point LW k-distribution and the recipe of
scripts/train_from_lut.py ("lw_both" net, Adam with cosine decay, hybrid
loss alpha 0.85, EMA) at a small width.

Parity, in float64 on both sides: both loops train on the same gendata file
(the JAX package's, read by each package's loader) from the same numpy init
on the same numpy batch rows. Losses agree to rtol 1e-9 and each epoch's
eval fluxes to rtol 1e-9 (float64 roundings); the metrics to 1e-4 W/m2,
K/day (the JAX core's float32 cancellation in its forcing biases, see
test_torch_shard_ops), the radiation scores to rtol 1e-6 (1.1e-7 measured
on the CPU). The k-distribution's tables are float32 on both sides (the
JAX loader's dtype; float64 tables move the fluxes by 5e-6 W/m2). The port
alone, float32, on its own gendata file: a short run whose best score beats
epoch 0, as test_training asserts of the JAX loop, and the save -> reload
probe (bit-identical fluxes).
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import predict_nn_lw as jpredict
from rte_rrtmgp_nn_tpu.gasoptics.planck import compute_planck_source_nn as jplanck
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl as JOP
from rte_rrtmgp_nn_tpu.rte import rte_lw as jrte_lw
from rte_rrtmgp_nn_tpu.sources import SourceFuncLW as JSrc
from rte_rrtmgp_nn_tpu.training import eval_loop as jev
from rte_rrtmgp_nn_tpu.training import gendata as jgen
from rte_rrtmgp_nn_tpu.training import train as jtrain
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload_kdist
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.training import eval_loop as pev
from rte_rrtmgp_nn_tpu_torch.training import gendata as pgen
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R
from rte_rrtmgp_nn_tpu_torch.training import train as ptrain
from test_lut_gas_optics import GASES
from test_torch_core import CPU
from test_torch_gendata import port_data
from test_training import mini_rfmip  # noqa: F401  (fixture)

F64 = torch.float64
HIDDEN, NPAIRS, EPOCHS, STEPS, LR, ALPHA, EMA = 16, 32, 2, 5, 3e-3, 0.85, 0.8


@pytest.fixture(scope="module")
def kd_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("kd") / "lw.nc")
    generate_kdist_nc(p, kind="lw", gpts_per_band=4, nband=16)
    return p


def _init_arrays(ts, nfeat, ngpt, seed=0):
    """He-init arrays of a 'lw_both' net with the set's scalings (numpy)."""
    rng = np.random.default_rng(seed)
    dims = [nfeat, HIDDEN, HIDDEN, 2 * ngpt]
    ws = [rng.normal(0, np.sqrt(2.0 / a), (a, b)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [np.zeros(b) for b in dims[1:]]
    return (ws, bs, ("softsign", "softsign", "linear"), ("tlay", "play") + tuple(GASES), ts.xmin,
            ts.xmax, ts.out_mean, ts.out_std)


def _jax_flux_fn(jkd, d, ts):
    """scripts/train_from_lut.py's flux_of, in float64."""
    ncol, nlay = d.play.shape
    f = lambda a: jnp.asarray(np.asarray(a, np.float64))
    x, cd = f(ts.xs.reshape(ncol, nlay, -1)), f(ts.col_dry.reshape(ncol, nlay))
    tlay, tlev, tsfc = f(d.tlay), f(d.tlev), f(d.tsfc)
    emis = jnp.broadcast_to(f(d.sfc_emis)[:, None], (ncol, jkd.nband))
    spec = jkd.spectral

    @jax.jit
    def flux_of(model):
        tau, pfrac = jpredict([model], x, cd, use_pallas=False)
        lay, lev, sfc, jacs = jplanck(pfrac, tlay, tlev, tsfc, spec, jkd.planck, top_at_1=True)
        sol = jrte_lw(JOP(tau, spec), True, JSrc(lay, lev, sfc, jacs, spec), emis,
                      broadband=True)
        return sol.flux_up, sol.flux_dn

    return flux_of


def test_loop_matches_jax_in_float64(kd_path, mini_rfmip, tmp_path):
    d = mini_rfmip
    ncol, nlay = d.play.shape
    jkd = jload_kdist(kd_path, GASES)
    train_nc = str(tmp_path / "train.nc")
    gen = jgen.generate_lw_training_data(train_nc, jkd, d, gas_order=GASES)
    ref_up, ref_dn = gen["rsu"].reshape(ncol, nlay + 1), gen["rsd"].reshape(ncol, nlay + 1)
    ts = R.lw_training_set(train_nc, jkd.ngpt)
    arrays = _init_arrays(ts, ts.xs.shape[-1], jkd.ngpt)
    rng = np.random.default_rng(5)
    rows = [R.sample_pair_rows(rng, d.nexp, d.nsites, nlay, NPAIRS)
            for _ in range(EPOCHS * STEPS)]
    ref_scores = R.REF_SCORES
    T = EPOCHS * STEPS

    # -- the JAX loop (scripts/train_from_lut.py's steps, float64) ---------
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))
    ws, bs, acts, names, mn, mx, om, os_ = arrays
    jm = jnet.NNModel(tuple(map(f64, ws)), tuple(map(f64, bs)), acts, names, f64(mn), f64(mx),
                      f64(om), f64(os_))
    opt = optax.adam(optax.cosine_decay_schedule(LR, T, alpha=1e-2))
    jstate = jtrain.TrainState(jm, opt.init(jm), jnp.zeros((), jnp.int32))
    jstep_inner = jax.jit(jtrain.make_train_step(opt, alpha=ALPHA))
    jpairs = jnp.stack([jnp.arange(NPAIRS), jnp.arange(NPAIRS) + NPAIRS], axis=1)
    jxs, jys = f64(ts.xs), f64(ts.ys)
    jit = iter(rows)
    jflux = _jax_flux_fn(jkd, d, ts)
    jfluxes, jlosses = [], []

    def jstep(st, x, y):
        st, loss = jstep_inner(st, x, y, jpairs)
        jlosses.append(float(loss))
        return st, loss

    def jeval(model):
        up, dn = jflux(model)
        jfluxes.append((np.asarray(up), np.asarray(dn)))
        return jev.eval_metrics(np.asarray(up), np.asarray(dn), ref_up, ref_dn,
                                np.asarray(d.plev, np.float64), d.nexp)

    jres = jev.train_with_radiation_eval(
        jstate, jstep, lambda: (lambda i: (jxs[i], jys[i]))(next(jit)), jeval, ref_scores,
        n_epochs=EPOCHS, steps_per_epoch=STEPS, verbose=False, ema_decay=EMA)

    # -- the port's loop ---------------------------------------------------
    # the k-distribution's tables in float32, as the JAX loader keeps them
    pkd = pload_kdist(kd_path, GASES, device=CPU)
    pm = nn_model_from_arrays(*arrays, device=CPU, dtype=F64)
    for p in pm.parameters():
        p.requires_grad_(True)
    popt = torch.optim.Adam(pm.parameters(), lr=LR, eps=1e-8)
    state = ptrain.TrainState(pm, popt, scheduler=ptrain.scheduled(
        popt, ptrain.cosine_decay_schedule(LR, T, alpha=1e-2)))
    inner = ptrain.make_train_step(alpha=ALPHA)
    ppairs = R.pair_index(NPAIRS, CPU)
    pxs, pys = torch.as_tensor(ts.xs, dtype=F64), torch.as_tensor(ts.ys, dtype=F64)
    pit = iter(rows)
    ev = R.LWFluxEval(pkd, port_data(d), ts, ref_up, ref_dn, CPU, dtype=F64)
    pfluxes, plosses = [], []

    def pstep(st, x, y):
        st, loss = inner(st, x, y, ppairs)
        plosses.append(float(loss))
        return st, loss

    def peval(model):
        assert not torch.is_grad_enabled()
        up, dn = ev.fluxes(model)
        pfluxes.append((up.numpy(), dn.numpy()))
        return pev.eval_metrics(up, dn, ref_up, ref_dn, d.plev, d.nexp)

    save = str(tmp_path / "p_HR_{hr}_FRC_{frc}.nc")
    pres = pev.train_with_radiation_eval(
        state, pstep, lambda: (lambda i: (pxs[i], pys[i]))(next(pit)), peval, ref_scores,
        n_epochs=EPOCHS, steps_per_epoch=STEPS, verbose=False, ema_decay=EMA, save_path=save)

    np.testing.assert_allclose(plosses, jlosses, rtol=1e-9)
    assert len(pfluxes) == len(jfluxes) == EPOCHS
    for (pu, pdn), (ju, jdn) in zip(pfluxes, jfluxes):
        np.testing.assert_allclose(pu, ju, rtol=1e-9)
        np.testing.assert_allclose(pdn, jdn, rtol=1e-9)
    for ph, jh in zip(pres.history, jres.history):
        np.testing.assert_allclose(ph["metrics"], jh["metrics"], rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(ph["score"], jh["score"], rtol=1e-6)
        np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-9)
    assert pres.best_epoch == jres.best_epoch
    for a, b in zip(pres.best_model.weights, jres.best_model.weights):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-15)
    # the best (EMA) model is a snapshot of its epoch that no gradient reaches
    assert not any(p.requires_grad for p in pres.best_model.parameters())
    assert not torch.equal(pres.best_model.weights[0], state.model.weights[0])
    # saved with the score in the name, in float32; both packages load it
    (path,) = glob.glob(str(tmp_path / "p_HR_*"))
    jl, pl = jnet.load_model_netcdf(path), load_model_netcdf(path, device=CPU)
    for a, b, c in zip(pl.weights, jl.weights, pres.best_model.weights):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.float().numpy())
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        assert f.radiation_score == np.float32(pres.best_score)
        assert int(f.best_epoch) == pres.best_epoch


def test_port_loop_learns_saves_and_reloads_bit_identically(kd_path, mini_rfmip, tmp_path):
    """The port alone, float32, its own gendata: the best radiation score
    beats epoch 0's, the best model saved and loaded again gives the same
    fluxes bit for bit (the save / reload probe)."""
    d = port_data(mini_rfmip)
    ncol, nlay = np.shape(d.play)
    kd = pload_kdist(kd_path, GASES, device=CPU)
    train_nc = str(tmp_path / "train.nc")
    gen = pgen.generate_lw_training_data(train_nc, kd, d, gas_order=GASES)
    ts = R.lw_training_set(train_nc, kd.ngpt)
    model = ptrain.init_model([ts.xs.shape[-1], 24, 24, 2 * kd.ngpt],
                              torch.Generator().manual_seed(0), input_names=("tlay", "play") + tuple(GASES),
                              input_min=ts.xmin, input_max=ts.xmax, output_mean=ts.out_mean,
                              output_std=ts.out_std, device=CPU)
    state, _ = ptrain.create_train_state(model, learning_rate=3e-3)
    step = ptrain.make_train_step(alpha=0.5)
    pairs = R.pair_index(64, CPU)
    xs, ys = torch.as_tensor(ts.xs), torch.as_tensor(ts.ys)
    rng = np.random.default_rng(0)

    def data_iter():
        i = torch.as_tensor(R.sample_pair_rows(rng, d.nexp, d.nsites, nlay, 64))
        return xs[i], ys[i]

    ev = R.LWFluxEval(kd, d, ts, gen["rsu"].reshape(ncol, -1), gen["rsd"].reshape(ncol, -1), CPU)
    ref_scores = np.array([0.5, 0.5, 0.5, 0.05, 0.05, 0.05, 0.02, 0.02])
    save = str(tmp_path / "model_HR_{hr}_FRC_{frc}.nc")
    res = pev.train_with_radiation_eval(
        state, lambda st, x, y: step(st, x, y, pairs), data_iter, ev.metrics, ref_scores,
        n_epochs=6, steps_per_epoch=60, patience=6, save_path=save, verbose=False)
    scores = [h["score"] for h in res.history]
    assert res.best_score < scores[0] and np.isfinite(res.best_score)
    (path,) = glob.glob(str(tmp_path / "model_HR_*"))
    again = load_model_netcdf(path, device=CPU)
    with torch.no_grad():
        for a, b in zip(ev.fluxes(res.best_model), ev.fluxes(again)):
            assert torch.equal(a, b)


def test_loop_refuses_to_save_an_untrained_model_and_snapshots_the_best(tmp_path):
    """Zero epochs (or no finite score) leaves the untrained init as the
    best model: the loop refuses to save it. The best model is a copy taken
    at its epoch: later steps do not reach it."""
    m = ptrain.init_model([3, 4, 2], torch.Generator().manual_seed(1), device=CPU)
    state, _ = ptrain.create_train_state(m, learning_rate=0.1)
    step = ptrain.make_train_step()
    batch = lambda: (torch.rand(8, 3), torch.rand(8, 2))
    with pytest.raises(RuntimeError, match="refusing to save the untrained initial model"):
        pev.train_with_radiation_eval(state, step, batch, lambda mm: np.zeros(8), np.ones(8),
                                      n_epochs=0, save_path=str(tmp_path / "x_{hr}_{frc}.nc"),
                                      verbose=False)
    scores = iter([np.ones(8), 2 * np.ones(8), 3 * np.ones(8)])
    res = pev.train_with_radiation_eval(state, step, batch, lambda mm: next(scores), np.ones(8),
                                        n_epochs=3, steps_per_epoch=2, patience=5, verbose=False)
    assert res.best_epoch == 0 and len(res.history) == 3 and state.step == 6
    assert not torch.equal(res.best_model.weights[0], state.model.weights[0])
    assert pev.METRIC_NAMES == jev.METRIC_NAMES
