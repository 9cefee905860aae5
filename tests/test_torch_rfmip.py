"""PyTorch port against the JAX package end to end: the RFMIP clear-sky
drivers on the CPU in both vertical orientations (LW atol 2e-3, SW atol
2e-2 W/m2; night columns exactly 0) on the fused, staged and general
paths (multi-angle LW, two-model LW, the general SW core), the RFMIP
reader, the import isolation of the port, and the drivers' dispatch:
which requests take which kernels on CUDA and which still raise."""
import os
import re
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
from rte_rrtmgp_nn_tpu_torch.config import resolve_use_megakernel
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf, nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalProps2str
from rte_rrtmgp_nn_tpu_torch.rte import rte_lw
from rte_rrtmgp_nn_tpu_torch.testing import model_arrays, split_lw_both_arrays, synthesize_rfmip
from test_torch_core import (
    CPU, LW_MODEL, SW_MODEL, jax_model_from_arrays, model_pair, random_arrays, rfmip_pair)

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
    # an object without solar terms (a LW k-distribution) is no solar source
    np.testing.assert_array_equal(prfmip.resolve_solar_source(spec, kdist=object()), src)
    np.testing.assert_allclose(prfmip.resolve_solar_source(spec, tsi=1000.0).sum(), 1000.0)


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
    """Every module of the port, the port's scripts (scripts/torch_*.py),
    bench_torch.py and chip_smoke.py import in a fresh interpreter without
    pulling in jax, optax, triton or the JAX package."""
    code = (
        "import glob, importlib, importlib.util, pkgutil, sys\n"
        "import rte_rrtmgp_nn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for f in sorted(glob.glob('scripts/torch_*.py')) + ['bench_torch.py', 'chip_smoke.py']:\n"
        "    spec = importlib.util.spec_from_file_location('m_' + f.split('/')[-1][:-3], f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    names.append(f)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'triton', 'rte_rrtmgp_nn_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("n_angles", [2, 3, 4])
def test_lw_multi_angle_driver_matches_jax(models, jtable, n_angles, top_at_1):
    """The general path (gas_optics_lw_nn -> rte_lw with n Gauss angles)
    against the JAX driver's general core."""
    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=26, top_at_1=top_at_1))
    jm, pm = models["lw"]
    ref = jrfmip.rfmip_clear_sky_lw(jd, jm, planck_table=jtable, n_gauss_angles=n_angles)
    got = prfmip.rfmip_clear_sky_lw(pd, pm, n_gauss_angles=n_angles, device="cpu")
    assert tuple(got.flux_up.shape) == (NCOL, NLAY + 1)
    _check(got, ref, ("flux_up", "flux_dn", "flux_net"), LW_ATOL)


@pytest.mark.parametrize("core", ["two_model_lw", "general_sw"])
def test_staged_paths_without_megakernel(models, jtable, core):
    """Two-model LW (absorption + Planck-fraction nets, the staged core)
    and the general SW core (gas_optics_sw_nn -> rte_sw) against the JAX
    package's."""
    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=27, top_at_1=False))
    if core == "two_model_lw":
        halves = split_lw_both_arrays(*model_arrays(models["lw"][1][0]))
        jm = [jax_model_from_arrays(*a) for a in halves]
        pm = [nn_model_from_arrays(*a, device=CPU) for a in halves]
        ref = jrfmip.rfmip_clear_sky_lw(jd, jm, planck_table=jtable)
        with pco(use_megakernel=False):
            got = prfmip.rfmip_clear_sky_lw(pd, pm, device="cpu")
        _check(got, ref, ("flux_up", "flux_dn", "flux_net"), LW_ATOL)
        return
    import jax.numpy as jnp

    jm, pm = models["sw"]
    jspec, pspec = jplanck.sw_spectral_g112(), sw_spectral_g112()
    solar = prfmip.default_solar_source(pspec).astype(np.float32)
    mu0 = np.cos(np.deg2rad(jd.sza)).astype(np.float32)
    usecol = jd.sza < 90.0 - 0.5 * np.finfo(np.float32).eps
    j = lambda a: jnp.asarray(a, jnp.float32)
    ref = jrfmip._sw_core(jm, jspec, j(solar), j(jd.play), j(jd.plev), j(jd.tlay), j(jd.sfc_alb),
                          j(mu0), jnp.asarray(usecol), j(jd.tsi),
                          {k: j(v) for k, v in jd.gas_concs.concs.items()},
                          top_at_1=False, scan_mode="sequential")
    got = prfmip._sw_core(pm, pspec, torch.from_numpy(solar), *prfmip.sw_staged_inputs(pd, CPU),
                          top_at_1=False)
    _check(got, ref, ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"), SW_ATOL)
    assert (got.flux_dn.numpy()[~usecol] == 0.0).all()


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("band", ["lw", "lw_3_angles", "sw"])
def test_parallel_scan_drivers_match_jax(models, jtable, band, top_at_1):
    """scan_mode="parallel" through the drivers takes the general cores, as
    in the JAX package, and agrees with it and with the sequential
    request."""
    d = synthesize_rfmip(NCOL, NLAY, seed=29, top_at_1=top_at_1)
    jd, pd = rfmip_pair(d)
    if band == "sw":
        jm, pm = models["sw"]
        ref = jrfmip.rfmip_clear_sky_sw(jd, jm, scan_mode="parallel")
        got = prfmip.rfmip_clear_sky_sw(pd, pm, scan_mode="parallel", device="cpu")
        seq = prfmip.rfmip_clear_sky_sw(pd, pm, device="cpu")
        names, atol = ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"), SW_ATOL
        assert (got.flux_dn.numpy()[d["sza"] >= 90.0] == 0.0).all()
    else:
        kw = dict(n_gauss_angles=3) if band == "lw_3_angles" else {}
        jm, pm = models["lw"]
        ref = jrfmip.rfmip_clear_sky_lw(jd, jm, planck_table=jtable, scan_mode="parallel", **kw)
        got = prfmip.rfmip_clear_sky_lw(pd, pm, scan_mode="parallel", device="cpu", **kw)
        seq = prfmip.rfmip_clear_sky_lw(pd, pm, device="cpu", **kw)
        names, atol = ("flux_up", "flux_dn", "flux_net"), LW_ATOL
    _check(got, ref, names, atol)
    for n in names:
        np.testing.assert_allclose(getattr(got, n).numpy(), getattr(seq, n).numpy(), atol=atol)


# request -> route on CUDA, decided before any tensor reaches the card
_ROUTES = {
    "lw_default": (dict(lw=True), "megakernel"),
    "sw_default": (dict(), "megakernel"),
    "lw_relu_net": (dict(lw=True, models="relu_lw"), "staged"),
    "sw_relu_nets": (dict(models="relu_sw"), "staged"),
    "lw_fast_exp": (dict(lw=True, cfg=dict(fast_exponential=True)), "staged"),
    "sw_fast_exp": (dict(cfg=dict(fast_exponential=True)), "staged"),
    "lw_pade": (dict(lw=True, cfg=dict(use_pade_source=True)), "staged"),
    "sw_pade": (dict(cfg=dict(use_pade_source=True)), "megakernel"),
    "lw_megakernel_off": (dict(lw=True, cfg=dict(use_megakernel=False)), "staged"),
    "sw_megakernel_off": (dict(cfg=dict(use_megakernel=False)), "staged"),
    "lw_two_models": (dict(lw=True, models="lw_pair"), "staged"),
    "lw_gauss_angles": (dict(lw=True, n_gauss_angles=3), "staged"),
    "lw_parallel_scan": (dict(lw=True, scan_mode="parallel"), "staged"),
    "sw_parallel_scan": (dict(scan_mode="parallel"), "staged"),
    "sw_parallel_relu": (dict(scan_mode="parallel", models="relu_sw"), "staged"),
    "lw_parallel_float64": (dict(lw=True, scan_mode="parallel", dtype=torch.float64), "refuse"),
    "sw_parallel_too_deep": (dict(scan_mode="parallel", models="deep_sw"), "refuse"),
    "lw_float64": (dict(lw=True, dtype=torch.float64), "refuse"),
    "sw_float64": (dict(dtype=torch.float64), "refuse"),
    "lw_too_wide": (dict(lw=True, models="wide_lw"), "refuse"),
    "sw_too_deep": (dict(models="deep_sw"), "refuse"),
}


@pytest.mark.parametrize("request_name", list(_ROUTES))
def test_cuda_requests_raise_instead_of_plain_fallback(models, request_name):
    """On CUDA the drivers run kernels or raise; the route is taken by the
    dispatch before any tensor reaches the card, so it is checked here
    without one. Everything the fused kernels do not take (parallel scans
    included) goes the staged path with the MLP and transport kernels; only
    float64 and nets the MLP kernel does not take raise, and the drivers
    raise with the dispatch's reason."""
    net = lambda dims, acts: nn_model_from_arrays(*random_arrays(dims, acts, 0), device=CPU)
    nets = {
        "relu_lw": [net((18, 8, 8, 256), ("relu", "relu", "linear"))],
        "relu_sw": 2 * [net((7, 8, 8, 112), ("relu", "relu", "linear"))],
        "lw_pair": [nn_model_from_arrays(*a, device=CPU)
                    for a in split_lw_both_arrays(*model_arrays(models["lw"][1][0]))],
        "wide_lw": [net((18, 600, 256), ("tanh", "linear"))],  # a 600-wide hidden layer
        "deep_sw": 2 * [net((7,) + (8,) * 9 + (112,), ("relu",) * 9 + ("linear",))],  # 10 layers
    }
    kw, expect = _ROUTES[request_name]
    kw = dict(kw)
    lw = kw.get("lw", False)
    cfg = kw.pop("cfg", {})
    kw["models"] = nets[kw["models"]] if "models" in kw else (
        models["lw"][1] if lw else models["sw"][1])
    with pco(**cfg):
        route = resolve_use_megakernel(device="cuda", **kw)
        assert route.kind == expect, route
        if expect == "refuse":
            _, pd = rfmip_pair(synthesize_rfmip(4, 5, seed=24))
            drv = prfmip.rfmip_clear_sky_lw if lw else prfmip.rfmip_clear_sky_sw
            args = {k: v for k, v in kw.items() if k in ("scan_mode", "dtype", "n_gauss_angles")}
            with pytest.raises(NotImplementedError, match=re.escape(route.reason)):
                drv(pd, kw["models"], device="cuda", **args)
    if request_name == "lw_float64":  # the CPU still runs float64 (the arbiter)
        assert resolve_use_megakernel(lw=True, models=kw["models"], device="cpu",
                                      dtype=torch.float64).kind == "staged"


# staged request -> (driver keywords, config, kernel launches, non-kernel
# broadband LW solves): what each takes when its tensors are not on the CPU
_OFF_CPU = {
    "lw_3_angles": (dict(lw=True, n_gauss_angles=3), {}, {"fused_predict_lw_both": 1, "k7": 1}, 0),
    "lw_megakernel_off": (dict(lw=True), dict(use_megakernel=False),
                          {"fused_predict_lw_both": 1, "k7": 1}, 0),
    "lw_two_models": (dict(lw=True, models="lw_pair"), {}, {"fused_predict_tau": 1, "k7": 1}, 0),
    "lw_relu_net": (dict(lw=True, models="relu_lw", n_gauss_angles=2), {},
                    {"fused_predict_lw_both": 1, "k7": 1}, 0),
    "lw_fast_exp": (dict(lw=True), dict(fast_exponential=True), {"fused_predict_lw_both": 1}, 1),
    "lw_pade": (dict(lw=True, n_gauss_angles=2), dict(use_pade_source=True),
                {"fused_predict_lw_both": 1}, 0),
    "sw_megakernel_off": (dict(), dict(use_megakernel=False), {"fused_predict_sw": 1}, 0),
    "sw_fast_exp": (dict(models="relu_sw"), dict(fast_exponential=True), {"fused_predict_sw": 1}, 0),
    # a parallel-scan LW request solves broadband, which does not read the
    # scan mode: the transport kernel still runs, once per call for every angle
    "lw_parallel": (dict(lw=True, scan_mode="parallel"), {}, {"fused_predict_lw_both": 1, "k7": 1}, 0),
    "lw_parallel_2_angles": (dict(lw=True, scan_mode="parallel", n_gauss_angles=2), {},
                             {"fused_predict_lw_both": 1, "k7": 1}, 0),
    # the general SW core's broadband two-stream solve is K11 off the CPU
    "sw_parallel": (dict(scan_mode="parallel"), {}, {"fused_predict_sw": 1, "k11": 1}, 0),
}


@pytest.mark.parametrize("request_name", list(_OFF_CPU))
def test_staged_drivers_off_the_cpu_launch_kernels_never_twins(models, monkeypatch, request_name):
    """Off the CPU the staged drivers reach the kernels' wrappers, which
    launch, and never a kernel's plain twin. Meta tensors (shape and dtype
    without data) stand in for the card: the wrappers take any tensor not
    on the CPU to the kernel, the launches are recorded instead of run,
    and every twin raises. Only the JAX package's own non-kernel LW solve
    (fast_exponential) runs as plain ops, as it may on the card."""
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_2stream as k11

    meta = torch.device("meta")
    launched, fused = {}, []

    def launch(name, nets, x, col_dry, ngpt, n_out):
        launched[name] = launched.get(name, 0) + 1
        return [torch.empty(tuple(x.shape[:-1]) + (ngpt,), device=x.device)] * n_out

    def k7_launch(tau, *args):
        launched["k7"] = launched.get("k7", 0) + 1
        return [torch.empty((tau.shape[0], tau.shape[1] + 1), device=tau.device)] * 2

    def k11_launch(tau, *args):
        launched["k11"] = launched.get("k11", 0) + 1
        return [torch.empty((tau.shape[0], tau.shape[1] + 1), device=tau.device)] * 3

    def twin(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran off the CPU")

    fused_solve = plw._lw_noscat_broadband_fused
    monkeypatch.setattr(mlp, "_launch", launch)
    monkeypatch.setattr(k7, "_launch", k7_launch)
    monkeypatch.setattr(k11, "_launch", k11_launch)
    monkeypatch.setattr(plw, "_lw_noscat_broadband_fused",
                        lambda *a, **k: fused.append(1) or fused_solve(*a, **k))
    for name in ("fused_predict_lw_both_plain", "fused_predict_tau_plain",
                 "fused_predict_sw_plain"):
        monkeypatch.setattr(mlp, name, twin)
    monkeypatch.setattr(k7, "lw_noscat_broadband_plain", twin)
    net = lambda dims, acts: nn_model_from_arrays(*random_arrays(dims, acts, 0), device=meta)
    lw_net = nn_model_from_arrays(*model_arrays(models["lw"][1][0]), device=meta)
    sw_net = nn_model_from_arrays(*model_arrays(models["sw"][1][0]), device=meta)
    nets = {
        "relu_lw": [net((18, 8, 8, 256), ("relu", "relu", "linear"))],
        "relu_sw": 2 * [net((7, 8, 8, 112), ("relu", "relu", "linear"))],
        "lw_pair": [nn_model_from_arrays(*a, device=meta)
                    for a in split_lw_both_arrays(*model_arrays(models["lw"][1][0]))],
    }
    kw, cfg, expect, n_fused = _OFF_CPU[request_name]
    kw = dict(kw)
    lw = kw.pop("lw", False)
    ms = nets[kw.pop("models")] if "models" in kw else ([lw_net] if lw else [sw_net, sw_net])
    _, pd = rfmip_pair(synthesize_rfmip(6, 5, seed=28))
    with pco(**cfg):
        assert resolve_use_megakernel(lw=lw, models=ms, device="cuda", **kw).kind == "staged"
        drv = prfmip.rfmip_clear_sky_lw if lw else prfmip.rfmip_clear_sky_sw
        got = drv(pd, ms, device=meta, **kw)
    assert got.flux_dn.device == meta and tuple(got.flux_dn.shape) == (6, 6)
    assert launched == expect
    assert len(fused) == n_fused


def test_requests_still_to_be_ported_raise():
    """Nothing the JAX package serves is refused any more: n-stream rte_lw
    raises as the JAX one (and the reference) does, in its words; two-stream
    rte_lw solves; no module of the port names open porting work in an
    error."""
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu import rte as jrte
    from rte_rrtmgp_nn_tpu.spectral import SpectralMapping as JSM
    from rte_rrtmgp_nn_tpu_torch.optical_props import OpticalPropsNstr
    from rte_rrtmgp_nn_tpu_torch.sources import SourceFuncLW

    spec = sw_spectral_g112()
    z = torch.zeros((2, 3, spec.ngpt))
    words = r"rte_lw\(\.\.\.nstr\.\.\.\) not yet implemented"
    with pytest.raises(NotImplementedError, match=words):
        rte_lw(OpticalPropsNstr(z, z, z[None], spec), True, None, torch.zeros((2, spec.nband)))
    import jax.numpy as jnp

    jz = jnp.zeros((2, 3, spec.ngpt))
    jspec = JSM.create(np.asarray(spec.band_lims_gpt), spec.band_lims_wvn_array)
    with pytest.raises(NotImplementedError, match=words):
        jrte.rte_lw(jop.OpticalPropsNstr(jz, jz, jz[None], jspec), True, None,
                    jnp.zeros((2, spec.nband)))
    src = SourceFuncLW(z, torch.zeros((2, 4, spec.ngpt)), z[:, 0], z[:, 0], spec)
    sol = rte_lw(OpticalProps2str(z + 0.1, z, z, spec), True, src, torch.ones((2, spec.nband)))
    assert tuple(sol.flux_up.shape) == (2, 4, spec.ngpt) and not sol.flux_up.any()
    pkg = os.path.join(REPO, "rte_rrtmgp_nn_tpu_torch")
    for root, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "still to be ported" not in text and "ROADMAP Queue 1" not in text, name


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
