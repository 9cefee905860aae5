"""PyTorch port against the JAX package end to end: the RFMIP clear-sky
drivers on the CPU in both vertical orientations (LW atol 2e-3, SW atol
2e-2 W/m2; night columns exactly 0), the RFMIP reader, the import
isolation of the port, and the CUDA paths that must raise instead of
running plain code on the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip
from rte_rrtmgp_nn_tpu.drivers.rfmip_io import read_rfmip as jread
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import read_rfmip as pread
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL, model_pair, random_arrays, rfmip_pair

NCOL, NLAY = 14, 10
LW_ATOL, SW_ATOL = 2e-3, 2e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jl, pl = model_pair(LW_MODEL)
    js, ps = model_pair(SW_MODEL)
    return {"lw": ([jl], [pl]), "sw": ([js, js], [ps, ps])}


@pytest.fixture(scope="module")
def jtable():
    """The JAX driver's default Planck table, computed once for the module."""
    import jax.numpy as jnp

    spec = jplanck.lw_spectral_g128()
    return jplanck.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32)


def _check(port, ref, names, atol):
    for n in names:
        np.testing.assert_allclose(getattr(port, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("mega", [False, True], ids=["staged", "kernel_core"])
@pytest.mark.parametrize("top_at_1", [True, False])
def test_lw_driver_matches_jax(models, jtable, top_at_1, mega):
    """The staged core, and the fused-kernel core (its plain twin on CPU
    tensors), against the JAX driver's staged core."""
    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=21, top_at_1=top_at_1))
    jm, pm = models["lw"]
    ref = jrfmip.rfmip_clear_sky_lw(jd, jm, planck_table=jtable)
    with pco(use_megakernel=mega):
        got = prfmip.rfmip_clear_sky_lw(pd, pm, device="cpu")
    assert tuple(got.flux_up.shape) == (NCOL, NLAY + 1)
    _check(got, ref, ("flux_up", "flux_dn", "flux_net"), LW_ATOL)


@pytest.mark.parametrize("mega", [False, True], ids=["staged", "kernel_core"])
@pytest.mark.parametrize("top_at_1", [True, False])
def test_sw_driver_matches_jax(models, top_at_1, mega):
    d = synthesize_rfmip(NCOL, NLAY, seed=22, top_at_1=top_at_1)
    night = d["sza"] >= 90.0
    assert night.any() and not night.all()
    jd, pd = rfmip_pair(d)
    jm, pm = models["sw"]
    ref = jrfmip.rfmip_clear_sky_sw(jd, jm)
    with pco(use_megakernel=mega):
        got = prfmip.rfmip_clear_sky_sw(pd, pm, device="cpu")
    _check(got, ref, ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"), SW_ATOL)
    for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        assert (getattr(got, n).numpy()[night] == 0.0).all(), n
    toa = 0 if top_at_1 else NLAY
    mu0 = np.cos(np.deg2rad(d["sza"])).astype(np.float64)
    np.testing.assert_allclose(got.flux_dn.numpy()[~night, toa],
                               (d["tsi"] * mu0)[~night], rtol=1e-5)


def test_float64_staged_path(models, jtable):
    """The staged path also runs in float64 on the CPU (the reference that
    decides float32 disagreements); it agrees with the JAX float32 drivers
    to the flux tolerances."""
    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=23))
    f64 = torch.float64
    lw = prfmip.rfmip_clear_sky_lw(pd, [load_model_netcdf(LW_MODEL, device=CPU, dtype=f64)],
                                   device="cpu", dtype=f64)
    sm = load_model_netcdf(SW_MODEL, device=CPU, dtype=f64)
    sw = prfmip.rfmip_clear_sky_sw(pd, [sm, sm], device="cpu", dtype=f64)
    assert lw.flux_up.dtype == f64 and sw.flux_dn.dtype == f64
    _check(lw, jrfmip.rfmip_clear_sky_lw(jd, models["lw"][0], planck_table=jtable),
           ("flux_up", "flux_dn"), LW_ATOL)
    _check(sw, jrfmip.rfmip_clear_sky_sw(jd, models["sw"][0]), ("flux_up", "flux_dn"), SW_ATOL)


def test_solar_source():
    spec = sw_spectral_g112()
    src = prfmip.default_solar_source(spec)
    np.testing.assert_allclose(src, jrfmip.default_solar_source(jplanck.sw_spectral_g112()))
    assert src.sum() == pytest.approx(1360.85)
    np.testing.assert_array_equal(prfmip.resolve_solar_source(spec), src)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        prfmip.resolve_solar_source(spec, kdist=object())


def test_read_rfmip_classic_netcdf(tmp_path):
    """A tiny RFMIP-format file (netCDF-3 classic, written with scipy): both
    readers return the same arrays, gases with their units scale."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(5)
    nexp, nsite, nlay = 2, 3, 4
    p = str(tmp_path / "rfmip_tiny.nc")
    plev = np.sort(rng.uniform(10.0, 1e5, (nsite, nlay + 1)), axis=1)
    with netcdf_file(p, "w") as f:
        for name, size in (("expt", nexp), ("site", nsite), ("layer", nlay), ("level", nlay + 1)):
            f.createDimension(name, size)

        def var(name, dims, data, units=None):
            v = f.createVariable(name, "f4", dims)
            v[...] = data
            if units is not None:
                v.units = units

        var("pres_layer", ("site", "layer"), 0.5 * (plev[:, 1:] + plev[:, :-1]))
        var("pres_level", ("site", "level"), plev)
        var("temp_layer", ("expt", "site", "layer"), rng.uniform(200, 300, (nexp, nsite, nlay)))
        var("temp_level", ("expt", "site", "level"), rng.uniform(200, 300, (nexp, nsite, nlay + 1)))
        var("surface_temperature", ("expt", "site"), rng.uniform(250, 310, (nexp, nsite)))
        var("surface_emissivity", ("site",), rng.uniform(0.9, 1, nsite))
        var("surface_albedo", ("site",), rng.uniform(0.05, 0.3, nsite))
        var("solar_zenith_angle", ("site",), rng.uniform(0, 120, nsite))
        var("total_solar_irradiance", ("site",), np.full(nsite, 1361.0))
        var("water_vapor", ("expt", "site", "layer"), rng.uniform(1, 1e4, (nexp, nsite, nlay)),
            units="1.e-6")
        var("ozone", ("expt", "site", "layer"), rng.uniform(1e-8, 1e-5, (nexp, nsite, nlay)))
        var("carbon_dioxide_GM", ("expt",), np.array([284.0, 397.0]), units="1.e-6")
    j, q = jread(p), pread(p)
    assert (q.ncol, q.nlay, q.top_at_1) == (j.ncol, j.nlay, j.top_at_1) == (6, 4, True)
    for n in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis", "sfc_alb", "sza", "tsi"):
        np.testing.assert_array_equal(getattr(q, n), getattr(j, n), err_msg=n)
    assert q.gas_concs.gas_names == j.gas_concs.gas_names == ["h2o", "o3", "co2"]
    for g in q.gas_concs.gas_names:
        np.testing.assert_array_equal(q.gas_concs.get_raw(g).numpy(),
                                      np.asarray(j.gas_concs.get_raw(g)), err_msg=g)
    assert float(q.gas_concs.get_raw("co2")[3, 0]) == pytest.approx(397e-6)


def test_port_imports_neither_jax_nor_triton():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax, triton or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rte_rrtmgp_nn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'triton', 'rte_rrtmgp_nn_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_requests_raise_instead_of_plain_fallback(models):
    """On CUDA the drivers run the kernels or raise; the decision is taken
    before any tensor reaches the card, so it is checked here without one."""
    _, pd = rfmip_pair(synthesize_rfmip(4, 5, seed=24))
    relu = nn_model_from_arrays(*random_arrays((18, 8, 8, 256), ("relu", "relu", "linear"), 0),
                                device=CPU)
    with pytest.raises(NotImplementedError, match="K3"):
        prfmip.rfmip_clear_sky_lw(pd, [relu], device="cuda")
    relu_sw = nn_model_from_arrays(*random_arrays((7, 8, 8, 112), ("relu", "relu", "linear"), 0),
                                   device=CPU)
    with pytest.raises(NotImplementedError, match="K5"):
        prfmip.rfmip_clear_sky_sw(pd, [relu_sw, relu_sw], device="cuda")
    lw, sw = models["lw"][1], models["sw"][1]
    with pco(fast_exponential=True), pytest.raises(NotImplementedError, match="K7"):
        prfmip.rfmip_clear_sky_lw(pd, lw, device="cuda")
    with pco(use_pade_source=True), pytest.raises(NotImplementedError, match="K7"):
        prfmip.rfmip_clear_sky_lw(pd, lw, device="cuda")
    with pco(use_megakernel=False), pytest.raises(NotImplementedError, match="use_megakernel"):
        prfmip.rfmip_clear_sky_sw(pd, sw, device="cuda")
    with pytest.raises(NotImplementedError, match="float64"):
        prfmip.rfmip_clear_sky_lw(pd, lw, device="cuda", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="K4"):
        prfmip.rfmip_clear_sky_lw(pd, lw * 2, device="cuda")
    # not ported yet on any device
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        prfmip.rfmip_clear_sky_lw(pd, lw, n_gauss_angles=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        prfmip.rfmip_clear_sky_sw(pd, sw, scan_mode="parallel", device="cpu")


def test_staged_path_honors_numerics_flags(models, jtable):
    """The flags the kernels bake are honored by the staged path on the CPU
    and move the answer like the JAX package's (LW Pade source, SW fast
    exponential)."""
    from rte_rrtmgp_nn_tpu.config import config_override as jco

    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=25))
    with jco(use_pade_source=True), pco(use_pade_source=True):
        ref = jrfmip.rfmip_clear_sky_lw(jd, models["lw"][0], planck_table=jtable)
        got = prfmip.rfmip_clear_sky_lw(pd, models["lw"][1], device="cpu")
    _check(got, ref, ("flux_up", "flux_dn"), LW_ATOL)
    exact = prfmip.rfmip_clear_sky_lw(pd, models["lw"][1], device="cpu")
    assert float((exact.flux_dn - got.flux_dn).abs().max()) > 1e-4
    with jco(fast_exponential=True), pco(fast_exponential=True):
        ref = jrfmip.rfmip_clear_sky_sw(jd, models["sw"][0])
        got = prfmip.rfmip_clear_sky_sw(pd, models["sw"][1], device="cpu")
    _check(got, ref, ("flux_up", "flux_dn", "flux_dn_dir"), SW_ATOL)
