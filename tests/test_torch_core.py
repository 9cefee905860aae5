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
    config, config_override, cuda_dtype_refusal, megakernel_model_ok, resolve_use_megakernel)
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models import network as pnet
from rte_rrtmgp_nn_tpu_torch.testing import random_mlp_arrays

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
    return random_mlp_arrays(dims, acts, seed, names)


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
    assert (config.check_extents, config.check_values, config.compute_jac) == (
        jconfig.check_extents, jconfig.check_values, jconfig.compute_jac)
    # on CUDA the kernels are float32; the CPU runs any dtype (the arbiter)
    assert "float32" in cuda_dtype_refusal("cuda", torch.float64)
    assert cuda_dtype_refusal("cpu", torch.float64) == cuda_dtype_refusal("cuda", torch.float32) == ""
    _, lw = model_pair(LW_MODEL)
    relu = pnet.nn_model_from_arrays(*random_arrays((4, 8, 8, 6), ("relu", "relu", "linear"), 0),
                                     device=CPU)
    assert megakernel_model_ok([lw]) and not megakernel_model_ok([relu])
    kind = lambda **kw: resolve_use_megakernel(**kw).kind
    assert resolve_use_megakernel(lw=True, models=[lw], device="cuda") == ("megakernel", "")
    assert kind(lw=True, models=[lw], device="cpu") == "staged"
    assert kind(lw=True, models=[relu], device="cuda") == "staged"
    assert kind(models=[relu], device="cuda") == "refuse"  # SW needs two nets
    assert kind(lw=True, models=[lw, lw], device="cuda") == "staged"
    assert kind(lw=True, models=[lw], device="cuda", n_gauss_angles=2) == "staged"
    assert kind(lw=True, models=[lw], device="cuda", dtype=torch.float64) == "refuse"
    assert kind(lw=True, models=[lw], device="cpu", dtype=torch.float64) == "staged"
    with config_override(fast_exponential=True):
        assert kind(device="cuda") == "staged"
    with config_override(use_pade_source=True):
        assert kind(lw=True, device="cuda") == "staged"
        assert kind(lw=False, device="cuda") == "megakernel"
    with config_override(use_megakernel=True):
        assert kind(lw=True, models=[lw], device="cpu") == "megakernel"
    assert config.use_megakernel is None
    # every staged route and refusal says why
    for kw, why in ((dict(lw=True, models=[relu]), "3-layer softsign"),
                    (dict(lw=True, models=[lw, lw]), "two-model"),
                    (dict(dtype=torch.float64), "float32"),
                    (dict(scan_mode="parallel"), "parallel scans take the general cores")):
        route = resolve_use_megakernel(device="cuda", **kw)
        assert route.kind != "megakernel" and why in route.reason


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


# -- optical properties: delta_scale, increment, subset ------------------------------

def _props_pair(kind, spec_pair, rng, ncol=3, nlay=4, nmom=3):
    """The same random optical properties as a JAX and a port container on
    the g-point grid of ``spec_pair`` = (JAX mapping, port mapping)."""
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop

    js, ps = spec_pair
    shape = (ncol, nlay, js.ngpt)
    f = lambda lo, hi, shp=shape: rng.uniform(lo, hi, shp).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    tau, ssa = f(0.0, 3.0), f(0.0, 1.0)
    if kind == "1scl":
        return jop.OpticalProps1scl(j(tau), js), pop.OpticalProps1scl(t(tau), ps)
    if kind == "2str":
        g = f(-0.5, 0.95)
        return (jop.OpticalProps2str(j(tau), j(ssa), j(g), js),
                pop.OpticalProps2str(t(tau), t(ssa), t(g), ps))
    p = f(-0.5, 0.9, (nmom,) + shape)
    return (jop.OpticalPropsNstr(j(tau), j(ssa), j(p), js),
            pop.OpticalPropsNstr(t(tau), t(ssa), t(p), ps))


def _same_props(port, ref, atol=1e-6):
    """Every field of two containers agrees to rtol 1e-5 (atol for values
    that are differences of near-equal terms)."""
    assert type(port).__name__ == type(ref).__name__
    for name in ("tau", "ssa", "g", "p"):
        if hasattr(ref, name):
            close(getattr(port, name), getattr(ref, name), atol=atol)


def _spec_pairs():
    from rte_rrtmgp_nn_tpu.spectral import SpectralMapping as JS
    from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping as PS

    js, ps = jplanck.sw_spectral_g112(), pplanck.sw_spectral_g112()
    bands = (JS.bands_only(js.band_lims_wvn_array), PS.bands_only(ps.band_lims_wvn_array))
    assert bands[1].band_lims_gpt == bands[0].band_lims_gpt
    return (js, ps), bands


@pytest.mark.parametrize("with_f", [False, True], ids=["g_squared", "forward_frac"])
def test_delta_scale_matches_jax(rng, with_f):
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop

    gpt, _ = _spec_pairs()
    jp, pp = _props_pair("2str", gpt, rng)
    f = rng.uniform(0.0, 0.9, tuple(pp.tau.shape)).astype(np.float32) if with_f else None
    ref = jop.delta_scale(jp, None if f is None else jnp.asarray(f))
    got = pop.delta_scale(pp, None if f is None else torch.from_numpy(f))
    _same_props(got, ref)
    assert got.spectral is pp.spectral


@pytest.mark.parametrize("grid", ["gpoint", "band"])
@pytest.mark.parametrize("kind2", ["1scl", "2str", "nstr"])
@pytest.mark.parametrize("kind1", ["1scl", "2str", "nstr"])
def test_increment_matches_jax(rng, kind1, kind2, grid):
    """increment for every pair of containers the JAX function takes, with
    op2 on op1's g-point grid and on its band grid (the by-band broadcast)."""
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop

    gpt, bands = _spec_pairs()
    j1, p1 = _props_pair(kind1, gpt, rng)
    j2, p2 = _props_pair(kind2, gpt if grid == "gpoint" else bands, rng)
    ref, got = jop.increment(j1, j2), pop.increment(p1, p2)
    _same_props(got, ref)
    assert tuple(got.tau.shape) == tuple(p1.tau.shape)


def test_increment_refuses_mismatched_grids_and_moments(rng):
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop

    gpt, _ = _spec_pairs()
    lw = (jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128())
    _, p1 = _props_pair("1scl", gpt, rng)
    _, p2 = _props_pair("1scl", lw, rng)
    with pytest.raises(ValueError, match="incompatible spectral"):
        pop.increment(p1, p2)
    _, n1 = _props_pair("nstr", gpt, rng, nmom=3)
    _, n2 = _props_pair("nstr", gpt, rng, nmom=2)
    with pytest.raises(ValueError, match="moment counts"):
        pop.increment(n1, n2)


@pytest.mark.parametrize("kind", ["1scl", "2str", "nstr"])
def test_subset_matches_jax(rng, kind):
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop

    gpt, _ = _spec_pairs()
    jp, pp = _props_pair(kind, gpt, rng, ncol=5)
    ref, got = jop.subset(jp, 1, 3), pop.subset(pp, 1, 3)
    _same_props(got, ref, atol=0.0)
    assert got.tau.shape[0] == 3
