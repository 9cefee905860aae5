"""PyTorch port (rte_rrtmgp_nn_tpu_torch) against the JAX package: the
core data model, the Planck table and the NN model format.

Inputs are made with numpy from a seed and handed to both sides. Module
outputs agree to rtol 1e-5 (float32; the two frameworks round log, matmul
and their sums differently). Also holds the helpers the other
test_torch_* files import.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu import gas_concs as jgc
from rte_rrtmgp_nn_tpu.drivers.rfmip_io import RFMIPData as JData
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu_torch import gas_concs as pgc
from rte_rrtmgp_nn_tpu_torch.config import (
    config, config_override, megakernel_model_ok, resolve_use_megakernel)
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models import network as pnet

torch.set_num_threads(2)  # the suite runs several workers on few cores

RTOL = 1e-5
ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
LW_MODEL = os.path.join(ART, "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_MODEL = os.path.join(ART, "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")
CPU = torch.device("cpu")


def rfmip_pair(d):
    """The JAX and the port RFMIPData of one synthesize_rfmip dict."""
    ncol, nlay = d["play"].shape
    jd = JData(play=d["play"], plev=d["plev"], tlay=d["tlay"], tlev=d["tlev"],
               tsfc=d["tsfc"], sfc_emis=d["sfc_emis"], sfc_alb=d["sfc_alb"], sza=d["sza"],
               tsi=d["tsi"], gas_concs=jgc.GasConcs.create(d["gases"]), nexp=1,
               nsites=ncol, nlay=nlay, top_at_1=d["top_at_1"])
    return jd, rfmip_data_from_arrays(d)


def model_pair(path):
    """The JAX and the port model of one netCDF file."""
    return jnet.load_model_netcdf(path), pnet.load_model_netcdf(path, device=CPU)


def random_arrays(dims, acts, seed, names=None):
    """Arrays of a random MLP (weights, biases, activations, input names,
    min, max, output mean, std)."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(0, 0.1, b).astype(np.float32) for b in dims[1:]]
    names = names or tuple(f"x{i}" for i in range(dims[0]))
    mn = rng.uniform(-1, 0, dims[0]).astype(np.float32)
    mx = (mn + rng.uniform(1, 2, dims[0])).astype(np.float32)
    om = rng.normal(0, 0.1, dims[-1]).astype(np.float32)
    os_ = rng.uniform(0.5, 1.5, dims[-1]).astype(np.float32)
    return ws, bs, tuple(acts), tuple(names), mn, mx, om, os_


def jax_model_from_arrays(ws, bs, acts, names, mn, mx, om, os_):
    f = lambda a: jnp.asarray(a, jnp.float32)
    return jnet.NNModel(tuple(map(f, ws)), tuple(map(f, bs)), acts, names, f(mn), f(mx), f(om), f(os_))


def close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


# -- spectral mapping ---------------------------------------------------------

@pytest.mark.parametrize("which", ["lw_spectral_g128", "sw_spectral_g112"])
def test_spectral_mapping_and_expand(which, rng):
    js, ps = getattr(jplanck, which)(), getattr(pplanck, which)()
    assert ps.band_lims_gpt == js.band_lims_gpt and ps.band_lims_wvn == js.band_lims_wvn
    assert (ps.nband, ps.ngpt) == (js.nband, js.ngpt)
    np.testing.assert_array_equal(ps.gpt2band, js.gpt2band)
    np.testing.assert_array_equal(ps.gpt2band_tensor(CPU).numpy(), js.gpt2band)
    band = rng.uniform(0, 1, (3, 5, js.nband)).astype(np.float32)
    np.testing.assert_array_equal(ps.expand(torch.from_numpy(band)).numpy(),
                                  np.asarray(js.expand(jnp.asarray(band))))
    np.testing.assert_allclose(pplanck.gpt_weights_for(ps), jplanck.gpt_weights_for(js))


def test_solar_band_fractions_and_planck_radiance():
    for lims in (pplanck.SW_BAND_LIMS_WVN, pplanck.LW_BAND_LIMS_WVN):
        np.testing.assert_array_equal(pplanck.solar_band_fractions(lims),
                                      jplanck.solar_band_fractions(lims))
    t = np.array([150.0, 200.0, 288.0, 340.0])
    np.testing.assert_array_equal(
        pplanck.planck_band_radiance(t, pplanck.LW_BAND_LIMS_WVN),
        jplanck.planck_band_radiance(t, jplanck.LW_BAND_LIMS_WVN))


# -- gas concentrations ---------------------------------------------------------

def test_gas_concs_storage_forms(rng):
    ncol, nlay = 5, 7
    vmrs = {"Water_Vapor": rng.uniform(1e-6, 1e-2, (ncol, nlay)).astype(np.float32),
            "ozone": rng.uniform(1e-8, 1e-5, nlay).astype(np.float32),
            "co2": np.float32(4e-4)}
    jg, pg = jgc.GasConcs.create(vmrs), pgc.GasConcs.create(vmrs)
    assert pg.gas_names == jg.gas_names == ["h2o", "o3", "co2"]
    for name in ("h2o", "water_vapor", "o3", "co2"):
        assert name in pg
        np.testing.assert_array_equal(pg.get_vmr(name, ncol, nlay).numpy(),
                                      np.asarray(jg.get_vmr(name, ncol, nlay)))
        np.testing.assert_array_equal(pg.get_raw(name).numpy(), np.asarray(jg.get_raw(name)))
    assert "ch4" not in pg
    with pytest.raises(ValueError):
        pgc.GasConcs.create({"h2o": np.array([0.1, 1.5])})
    with pytest.raises(ValueError):
        pgc.GasConcs({"Water_Vapor": torch.zeros(())})


def test_gas_names_and_reference_vmrs():
    for n in ("carbon_dioxide", "METHANE", " ozone ", "cfc11", "nitrogen"):
        assert pgc.normalize_gas_name(n) == jgc.normalize_gas_name(n)
    for gas in list(jgc._REF_VMR) + ["unknown_gas"]:
        for s in (1, 2, 3):
            assert pgc.get_ref_vmr(s, gas) == jgc.get_ref_vmr(s, gas)
    with pytest.raises(ValueError):
        pgc.get_ref_vmr(4, "co2")


# -- config -----------------------------------------------------------------------

def test_config_values_and_megakernel_rules():
    from rte_rrtmgp_nn_tpu.config import config as jconfig

    assert config.eps == jconfig.eps
    assert config.tau_thresh == pytest.approx(jconfig.tau_thresh, rel=1e-7)
    assert config.k_min == jconfig.k_min
    _, lw = model_pair(LW_MODEL)
    relu = pnet.nn_model_from_arrays(*random_arrays((4, 8, 8, 6), ("relu", "relu", "linear"), 0),
                                     device=CPU)
    assert megakernel_model_ok([lw]) and not megakernel_model_ok([relu])
    use = lambda **kw: resolve_use_megakernel(**kw)[0]
    assert resolve_use_megakernel(lw=True, models=[lw], device="cuda") == (True, "")
    assert not use(models=[lw], device="cpu")
    assert not use(models=[relu], device="cuda")
    assert not use(lw=True, models=[lw, lw], device="cuda")
    assert not use(lw=True, models=[lw], device="cuda", dtype=torch.float64)
    with config_override(fast_exponential=True):
        assert not use(device="cuda")
    with config_override(use_pade_source=True):
        assert not use(lw=True, device="cuda")
        assert use(lw=False, device="cuda")
    with config_override(use_megakernel=True):
        assert use(lw=True, models=[lw], device="cpu")
    assert config.use_megakernel is None
    # every refusal says why, naming what is still to be ported
    for kw, why in ((dict(models=[relu]), "K5"), (dict(lw=True, models=[relu]), "K3"),
                    (dict(lw=True, models=[lw, lw]), "K4"), (dict(dtype=torch.float64), "float32")):
        ok, reason = resolve_use_megakernel(device="cuda", **kw)
        assert not ok and why in reason


# -- Planck table -----------------------------------------------------------------

def test_planck_table_interpolate_with_edges(rng):
    spec = jplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    np.testing.assert_array_equal(pt.totplnk.numpy(), np.asarray(jt.totplnk))
    # inside the table, on its nodes, and past both ends (150 K, 400 K):
    # index clamped, fraction not
    t = np.concatenate([rng.uniform(160.0, 355.0, 200), [100.0, 150.0, 159.5, 160.0, 161.0,
                        354.0, 355.0, 355.5, 360.0, 400.0]]).astype(np.float32)
    got = pt.interpolate(torch.from_numpy(t)).numpy()
    ref = np.asarray(jt.interpolate(jnp.asarray(t)))
    close(got, ref)
    assert got.shape == (t.size, spec.nband)
    moved = pt.to(CPU)
    assert moved.temp_ref_min == 160.0 and moved.totplnk_delta == 1.0


# -- NN models ------------------------------------------------------------------

@pytest.mark.parametrize("path", [LW_MODEL, SW_MODEL], ids=["lw", "sw"])
def test_load_model_netcdf(path, rng):
    jm, pm = model_pair(path)
    assert pm.activations == jm.activations and pm.input_names == jm.input_names
    assert pm.dims == jm.dims
    for a, b in zip(pm.weights, jm.weights):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("input_min", "input_max", "output_mean", "output_std"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)))
    x = rng.uniform(0, 1, (32, pm.n_inputs)).astype(np.float32)
    close(pm.apply_raw(torch.from_numpy(x)).numpy(), np.asarray(jm.apply_raw(jnp.asarray(x))),
          atol=1e-6)


@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid", "hard_sigmoid", "softsign",
                                 "tanh", "gaussian"])
def test_nn_model_from_arrays(act, rng):
    arrs = random_arrays((18, 16, 16, 256), (act, act, act), seed=3)
    jm = jax_model_from_arrays(*arrs)
    pm = pnet.nn_model_from_arrays(*arrs, device=CPU)
    assert isinstance(pm, torch.nn.Module) and pm.n_layers == 3 and pm.n_outputs == 256
    x = rng.uniform(0, 1, (40, 18)).astype(np.float32)
    close(pm(torch.from_numpy(x)).numpy(),
          np.asarray(jm.apply_with_final_activation(jnp.asarray(x))), atol=1e-6)
    close(pm.apply_raw(torch.from_numpy(x)).numpy(), np.asarray(jm.apply_raw(jnp.asarray(x))),
          atol=1e-6)


def test_nn_model_rejects_unknown_activation():
    arrs = list(random_arrays((4, 8, 2), ("swish", "linear"), seed=1))
    with pytest.raises(ValueError):
        pnet.nn_model_from_arrays(*arrs, device=CPU)
