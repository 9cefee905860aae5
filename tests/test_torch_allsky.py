"""The port's all-sky path against the JAX package on the same synthetic
files: each of the six all-sky cores against its JAX core in both vertical
orientations with lookup-table and Pade cloud optics; allsky_lw / allsky_sw
of both packages on the same temporary Garand and coefficient files on
every route; rte_lw_allsky / rte_sw_allsky; and the drivers' dispatch off
the CPU (each request reaches the kernels it should, no twin runs). Fluxes
agree to LW 2e-3 and SW 2e-2 W/m2. On the CPU the fused cores run the
kernels' plain twins; the JAX fused cores run their Pallas kernels in
interpret mode."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.drivers import allsky as jallsky
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.config import resolve_use_megakernel
from rte_rrtmgp_nn_tpu_torch.drivers import allsky as pallsky
from rte_rrtmgp_nn_tpu_torch.drivers import fused
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.testing import garand_nc_variables, model_arrays, synthesize_garand
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc
from test_torch_cloud_optics import cloud_optics_pair, write_cloud_file
from test_torch_core import CPU, LW_MODEL, SW_MODEL, model_pair

NCOL, NLAY = 8, 10
LW_ATOL, SW_ATOL = 2e-3, 2e-2
LW_NAMES = ("flux_up", "flux_dn", "flux_net")
SW_NAMES = LW_NAMES + ("flux_dn_dir",)


@pytest.fixture(scope="module")
def models():
    jl, pl = model_pair(LW_MODEL)
    js, ps = model_pair(SW_MODEL)
    return {"lw": ([jl], [pl]), "sw": ([js, js], [ps, ps])}


def _garand(tmp_path, top_at_1, seed=71):
    path = str(tmp_path / f"garand-{int(top_at_1)}.nc")
    write_nc(path, *garand_nc_variables(synthesize_garand(NLAY, seed, top_at_1)))
    return path


def _check(port, ref, names, atol):
    for n in names:
        assert tuple(getattr(port, n).shape) == (NCOL, NLAY + 1)
        np.testing.assert_allclose(getattr(port, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=atol, err_msg=n)


def _core_inputs(tmp_path, which, flavour, top_at_1):
    """One atmosphere and cloud field for both packages: (JAX cloud
    optics, port cloud optics, atmosphere, clouds as numpy)."""
    j, p = cloud_optics_pair(tmp_path, which, 72, flavour)
    atm = pallsky.read_garand(_garand(tmp_path, top_at_1), NCOL)
    assert bool(atm.play[0, 0] < atm.play[0, -1]) == top_at_1
    clouds = pallsky.make_clouds(atm.play, atm.tlay, p)
    assert (clouds[0] > 0).any() and (clouds[1] > 0).any()
    return j, p, atm, clouds


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("flavour", ["lut", "pade"])
@pytest.mark.parametrize("core", ["general", "lay_major", "mega"])
def test_allsky_lw_cores_match_jax(tmp_path, models, core, flavour, top_at_1):
    jc, pc, atm, clouds = _core_inputs(tmp_path, "lw", flavour, top_at_1)
    jm, pm = models["lw"]
    jspec, pspec = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(jspec.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(pspec.band_lims_wvn_array, device=CPU)
    tsfc = atm.tlev[:, -1 if top_at_1 else 0]
    emis = np.full((NCOL, jspec.nband), 0.98, np.float32)
    j, t = (lambda a: jnp.asarray(a, jnp.float32)), (lambda a: torch.as_tensor(np.array(a)))
    if core == "mega":
        fields, concs_t = pallsky.canonicalize_allsky_inputs(
            atm.play, atm.plev, atm.tlay, atm.tlev, *clouds, atm.gas_concs, top_at_1)
        play_t, plev_t, tlay_t, tlev_t, *cld_t = fields
        ref = jallsky._allsky_lw_core_mega(
            jm, jt, jspec, jc, j(play_t), j(plev_t), j(tlay_t), j(tlev_t), j(tsfc), j(emis),
            *map(j, cld_t), {k: j(v) for k, v in concs_t.items()}, top_at_1=top_at_1, tile_c=8)
        got = fused.lw_core(
            pm, pt, pspec, t(play_t), t(plev_t), t(tlay_t), t(tlev_t), t(tsfc), t(emis),
            {k: t(v) for k, v in concs_t.items()}, (pc, tuple(map(t, cld_t))), top_at_1=top_at_1)
    else:
        concs = {k: np.asarray(v) for k, v in atm.gas_concs.concs.items()}
        jargs = (jm, jt, jspec, jc, *map(j, (atm.play, atm.plev, atm.tlay, atm.tlev, tsfc, emis)),
                 *map(j, clouds), {k: j(v) for k, v in concs.items()})
        pargs = (pm, pt, pspec, pc, *map(t, (atm.play, atm.plev, atm.tlay, atm.tlev, tsfc, emis)),
                 *map(t, clouds), {k: t(v) for k, v in concs.items()})
        if core == "general":
            ref = jallsky._allsky_lw_core(*jargs, top_at_1=top_at_1, n_gauss_angles=2,
                                          scan_mode="sequential")
            got = pallsky._allsky_lw_core(*pargs, top_at_1=top_at_1, n_gauss_angles=2)
        else:
            ref = jallsky._allsky_lw_core_lay_major(*jargs, top_at_1=top_at_1)
            got = pallsky._allsky_lw_core_lay_major(*pargs, top_at_1=top_at_1)
    _check(got, ref, LW_NAMES, LW_ATOL)


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("flavour", ["lut", "pade"])
@pytest.mark.parametrize("core", ["general", "lay_major", "mega"])
def test_allsky_sw_cores_match_jax(tmp_path, models, core, flavour, top_at_1):
    jc, pc, atm, clouds = _core_inputs(tmp_path, "sw", flavour, top_at_1)
    jm, pm = models["sw"]
    jspec, pspec = jplanck.sw_spectral_g112(), pplanck.sw_spectral_g112()
    solar = prfmip.default_solar_source(pspec).astype(np.float32)
    mu0 = np.full((NCOL,), 0.86, np.float32)
    alb = np.full((NCOL, jspec.nband), 0.06, np.float32)
    j, t = (lambda a: jnp.asarray(a, jnp.float32)), (lambda a: torch.as_tensor(np.array(a)))
    if core == "mega":
        fields, concs_t = pallsky.canonicalize_allsky_inputs(
            atm.play, atm.plev, atm.tlay, atm.tlev, *clouds, atm.gas_concs, top_at_1)
        play_t, plev_t, tlay_t, _, *cld_t = fields
        ref = jallsky._allsky_sw_core_mega(
            jm, jspec, j(solar), jc, j(play_t), j(plev_t), j(tlay_t), j(mu0), j(alb), j(alb),
            *map(j, cld_t), {k: j(v) for k, v in concs_t.items()}, top_at_1=top_at_1, tile_c=8)
        got = fused.sw_core(
            pm, pspec, t(play_t), t(plev_t), t(tlay_t), t(mu0),
            *fused.sw_boundary(pspec, t(solar), t(alb), t(alb)),
            {k: t(v) for k, v in concs_t.items()}, (pc, tuple(map(t, cld_t))), top_at_1=top_at_1)
    else:
        concs = {k: np.asarray(v) for k, v in atm.gas_concs.concs.items()}
        jargs = (jm, jspec, j(solar), jc, *map(j, (atm.play, atm.plev, atm.tlay, mu0, alb, alb)),
                 *map(j, clouds), {k: j(v) for k, v in concs.items()})
        pargs = (pm, pspec, t(solar), pc, *map(t, (atm.play, atm.plev, atm.tlay, mu0, alb, alb)),
                 *map(t, clouds), {k: t(v) for k, v in concs.items()})
        if core == "general":
            ref = jallsky._allsky_sw_core(*jargs, top_at_1=top_at_1, scan_mode="sequential")
            got = pallsky._allsky_sw_core(*pargs, top_at_1=top_at_1)
        else:
            ref = jallsky._allsky_sw_core_lay_major(*jargs, top_at_1=top_at_1)
            got = pallsky._allsky_sw_core_lay_major(*pargs, top_at_1=top_at_1)
    _check(got, ref, SW_NAMES, SW_ATOL)
    toa = 0 if top_at_1 else NLAY
    np.testing.assert_allclose(got.flux_dn.numpy()[:, toa], 0.86 * solar.sum(), rtol=1e-5)


def test_canonicalize_allsky_inputs_matches_jax(tmp_path):
    from rte_rrtmgp_nn_tpu.drivers.allsky_io import read_garand as jread

    _, pc, atm, clouds = _core_inputs(tmp_path, "lw", "lut", False)
    jatm = jread(_garand(tmp_path, False), NCOL)
    ref_f, ref_c = jallsky.canonicalize_allsky_inputs(
        jatm.play, jatm.plev, jatm.tlay, jatm.tlev, *clouds, jatm.gas_concs, False)
    got_f, got_c = pallsky.canonicalize_allsky_inputs(
        atm.play, atm.plev, atm.tlay, atm.tlev, *clouds, atm.gas_concs, False)
    for r, g in zip(ref_f, got_f):
        assert g.flags.c_contiguous and g.shape[1] == NCOL
        np.testing.assert_array_equal(g, r)
    assert list(got_c) == list(ref_c)
    for k in ref_c:
        np.testing.assert_array_equal(got_c[k], ref_c[k])
    assert got_f[0][0, 0] < got_f[0][-1, 0]  # top first


# flavour and orientation of the files, then the route: the fused cores,
# the staged cores, and what only one band has (3 Gauss angles; a refusal)
@pytest.mark.parametrize("flavour,top_at_1", [("lut", True), ("pade", False)])
@pytest.mark.parametrize("route", ["mega", "staged", "three_angles"])
def test_allsky_lw_entry_point_matches_jax(tmp_path, models, route, flavour, top_at_1):
    garand = _garand(tmp_path, top_at_1)
    coeffs = write_cloud_file(tmp_path / "lw.nc", "lw", 73, flavour)
    jm, pm = models["lw"]
    kw = dict(ncol=NCOL, n_gauss_angles=3 if route == "three_angles" else 1)
    mega = route == "mega"
    with jco(use_megakernel=mega), pco(use_megakernel=mega):
        ref = jallsky.allsky_lw(garand, coeffs, jm, **kw)
        got = pallsky.allsky_lw(garand, coeffs, pm, device="cpu", **kw)
    _check(got, ref, LW_NAMES, LW_ATOL)
    assert float(got.flux_dn.min()) >= 0.0


@pytest.mark.parametrize("flavour,top_at_1", [("lut", True), ("pade", False)])
@pytest.mark.parametrize("route", ["mega", "staged", "parallel_scan"])
def test_allsky_sw_entry_point_matches_jax(tmp_path, models, route, flavour, top_at_1):
    garand = _garand(tmp_path, top_at_1)
    coeffs = write_cloud_file(tmp_path / "sw.nc", "sw", 74, flavour)
    jm, pm = models["sw"]
    kw = dict(ncol=NCOL)
    if route == "parallel_scan":
        # the general cores with log-depth scans, LW as well (spectral there)
        kw["scan_mode"] = "parallel"
        lw_coeffs = write_cloud_file(tmp_path / "lw.nc", "lw", 73, flavour)
        _check(pallsky.allsky_lw(garand, lw_coeffs, models["lw"][1], device="cpu", **kw),
               jallsky.allsky_lw(garand, lw_coeffs, models["lw"][0], **kw), LW_NAMES, LW_ATOL)
    mega = route == "mega"
    with jco(use_megakernel=mega), pco(use_megakernel=mega):
        ref = jallsky.allsky_sw(garand, coeffs, jm, **kw)
        got = pallsky.allsky_sw(garand, coeffs, pm, device="cpu", **kw)
    _check(got, ref, SW_NAMES, SW_ATOL)
    toa = 0 if top_at_1 else NLAY
    solar = prfmip.default_solar_source(pplanck.sw_spectral_g112())
    np.testing.assert_allclose(got.flux_dn.numpy()[:, toa], 0.86 * solar.sum(), rtol=1e-5)
    # every third column is cloud-free: its direct beam at the surface is the largest
    sfc = got.flux_dn_dir.numpy()[:, NLAY - toa]
    assert sfc[2::3].min() > sfc[[0, 1, 3, 4, 6, 7]].max()


def test_allsky_float64_on_the_cpu(tmp_path, models):
    """The staged all-sky path also runs in float64 on the CPU (the arbiter
    of float32 disagreements) and agrees with the float32 JAX drivers."""
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    garand = _garand(tmp_path, True)
    f64 = torch.float64
    lw64 = load_model_netcdf(LW_MODEL, device=CPU, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=CPU, dtype=f64)
    for flavour in ("lut", "pade"):
        cl = write_cloud_file(tmp_path / f"lw-{flavour}.nc", "lw", 75, flavour)
        cs = write_cloud_file(tmp_path / f"sw-{flavour}.nc", "sw", 76, flavour)
        lw = pallsky.allsky_lw(garand, cl, [lw64], ncol=NCOL, device="cpu", dtype=f64)
        sw = pallsky.allsky_sw(garand, cs, [sw64, sw64], ncol=NCOL, device="cpu", dtype=f64)
        assert lw.flux_up.dtype == f64 and sw.flux_dn_dir.dtype == f64
        _check(lw, jallsky.allsky_lw(garand, cl, models["lw"][0], ncol=NCOL), LW_NAMES, LW_ATOL)
        _check(sw, jallsky.allsky_sw(garand, cs, models["sw"][0], ncol=NCOL), SW_NAMES, SW_ATOL)


# -- extensions/clr_all_sky ---------------------------------------------------------------

@pytest.fixture(scope="module")
def kdists(tmp_path_factory):
    """(JAX KDist, port KDist) of one synthetic LW and one SW file."""
    from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload
    from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload
    from test_lut_gas_optics import GASES

    out = {}
    for kind, nband in (("lw", 16), ("sw", 14)):
        p = str(tmp_path_factory.mktemp("kd") / f"{kind}.nc")
        generate_kdist_nc(p, kind=kind, gpts_per_band=4, nband=nband)
        out[kind] = (jload(p, GASES, dtype=jnp.float32), pload(p, GASES, device=CPU))
    return out


def _cloud_props(jspec, pspec, ncol, nlay, two_stream):
    """The same band-grid cloud layer as a JAX and a port container."""
    from rte_rrtmgp_nn_tpu import optical_props as jop
    from rte_rrtmgp_nn_tpu.spectral import SpectralMapping as JS
    from rte_rrtmgp_nn_tpu_torch import optical_props as pop
    from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping as PS

    tau = np.zeros((ncol, nlay, jspec.nband), np.float32)
    tau[:, 6:9, :] = 5.0
    jb, pb = JS.bands_only(jspec.band_lims_wvn_array), PS.bands_only(pspec.band_lims_wvn_array)
    t = torch.from_numpy
    if not two_stream:
        return jop.OpticalProps1scl(jnp.asarray(tau), jb), pop.OpticalProps1scl(t(tau), pb)
    ssa, g = np.full_like(tau, 0.5), np.full_like(tau, 0.85)
    return (jop.OpticalProps2str(jnp.asarray(tau), jnp.asarray(ssa), jnp.asarray(g), jb),
            pop.OpticalProps2str(t(tau), t(ssa), t(g), pb))


def _atmosphere(ncol, nlay):
    """make_atmosphere of the JAX LUT tests in float32, for both packages:
    (JAX arrays + GasConcs, port tensors + GasConcs)."""
    from rte_rrtmgp_nn_tpu.gas_concs import GasConcs as JGC
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs as PGC
    from test_lut_gas_optics import make_atmosphere

    *arrs, gc = make_atmosphere(ncol=ncol, nlay=nlay, dtype=jnp.float32)
    vmrs = {k: np.asarray(v, np.float32) for k, v in gc.concs.items()}
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return ((*arrs, JGC.create({k: jnp.asarray(v) for k, v in vmrs.items()})),
            (*map(t, arrs), PGC.create({k: t(v) for k, v in vmrs.items()})))


@pytest.mark.parametrize("two_stream", [True, False], ids=["2str_clouds", "1scl_clouds"])
def test_rte_lw_allsky_matches_jax(kdists, two_stream):
    """rte_lw_allsky of both packages on a synthetic k-distribution (the
    lookup-table gas optics of each package), with band-grid clouds and
    aerosols, two Gauss angles, and the clear-sky fluxes. Two-stream clouds
    on the absorption-only gas optics add (1 - ssa) * tau, as in the JAX
    package."""
    from rte_rrtmgp_nn_tpu.extensions.clr_all_sky import rte_lw_allsky as jfn
    from rte_rrtmgp_nn_tpu_torch.extensions.clr_all_sky import rte_lw_allsky as pfn

    jkd, pkd = kdists["lw"]
    (jplay, jplev, jtlay, jtlev, jtsfc, jgc), (play, plev, tlay, tlev, tsfc, gc) = _atmosphere(3, 12)
    ncol, nlay = play.shape
    jcld, pcld = _cloud_props(jkd.spectral, pkd.spectral, ncol, nlay, two_stream)
    jaer, paer = _cloud_props(jkd.spectral, pkd.spectral, ncol, nlay, False)
    emis = np.full((ncol, jkd.nband), 0.98, np.float32)
    kw = dict(n_gauss_angles=2, compute_clear=True)
    ref_all, ref_clr = jfn(jkd, jplay, jplev, jtlay, jtsfc, jgc, jnp.asarray(emis), clouds=jcld,
                           aerosols=jaer, tlev=jtlev, **kw)
    got_all, got_clr = pfn(pkd, play, plev, tlay, tsfc, gc, torch.from_numpy(emis), clouds=pcld,
                           aerosols=paer, tlev=tlev, **kw)
    for got, ref in ((got_all, ref_all), (got_clr, ref_clr)):
        for n in LW_NAMES:
            np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                       atol=LW_ATOL, err_msg=n)
    assert float((got_all.flux_dn - got_clr.flux_dn).abs().max()) > 1.0
    # without increments, the level temperatures interpolated, bottom-first input
    flip = lambda a: a.flip(1)
    only = pfn(pkd, flip(play), flip(plev), flip(tlay), tsfc, type(gc)(
        {k: (flip(v) if v.ndim == 2 else v) for k, v in gc.concs.items()}),
        torch.from_numpy(emis), top_at_1=False)
    ref_only = jfn(jkd, jplay, jplev, jtlay, jtsfc, jgc, jnp.asarray(emis))
    np.testing.assert_allclose(only.flux_up.flip(1).numpy(), np.asarray(ref_only.flux_up),
                               atol=LW_ATOL)
    np.testing.assert_allclose(only.flux_dn.flip(1).numpy(), np.asarray(ref_only.flux_dn),
                               atol=LW_ATOL)


@pytest.mark.parametrize("two_stream", [True, False], ids=["2str_clouds", "1scl_clouds"])
def test_rte_sw_allsky_matches_jax(kdists, two_stream):
    """rte_sw_allsky of both packages: two-stream clouds are delta-scaled
    before the increment, absorbing ones are not; ``tsi`` rescales the
    k-distribution's solar source."""
    from rte_rrtmgp_nn_tpu.extensions.clr_all_sky import rte_sw_allsky as jfn
    from rte_rrtmgp_nn_tpu_torch.extensions.clr_all_sky import rte_sw_allsky as pfn

    jkd, pkd = kdists["sw"]
    (jplay, jplev, jtlay, _, _, jgc), (play, plev, tlay, _, _, gc) = _atmosphere(2, 12)
    ncol, nlay = play.shape
    jcld, pcld = _cloud_props(jkd.spectral, pkd.spectral, ncol, nlay, two_stream)
    mu0 = np.full((ncol,), 0.75, np.float32)
    alb = np.full((ncol, jkd.nband), 0.1, np.float32)
    t = torch.from_numpy
    ref_all, ref_clr = jfn(jkd, jplay, jplev, jtlay, jgc, jnp.asarray(mu0), jnp.asarray(alb),
                           jnp.asarray(alb), clouds=jcld, tsi=1361.0, compute_clear=True)
    got_all, got_clr = pfn(pkd, play, plev, tlay, gc, t(mu0), t(alb), t(alb), clouds=pcld,
                           tsi=1361.0, compute_clear=True)
    for got, ref in ((got_all, ref_all), (got_clr, ref_clr)):
        for n in SW_NAMES:
            np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                       atol=SW_ATOL, err_msg=n)
    assert float((got_all.flux_dn_dir - got_clr.flux_dn_dir).abs().max()) > 1.0
    np.testing.assert_allclose(got_clr.flux_dn[:, 0].numpy(), 0.75 * 1361.0, rtol=1e-5)


# -- dispatch off the CPU -----------------------------------------------------------------

# request -> (band, driver keywords, config, coefficient flavour, the fused
# kernel's mode or None, the staged kernels' launches)
_OFF_CPU = {
    "lw_mega_lut": ("lw", {}, dict(use_megakernel=True), "lut", "cld_lut", {}),
    "lw_mega_pade": ("lw", {}, dict(use_megakernel=True), "pade", "cld_bands", {}),
    "sw_mega_lut": ("sw", {}, dict(use_megakernel=True), "lut", "cld_lut", {}),
    "sw_mega_pade": ("sw", {}, dict(use_megakernel=True), "pade", "cld_bands", {}),
    "lw_staged_one_angle": ("lw", {}, dict(use_megakernel=False), "lut", None,
                            {"fused_predict_lw_both": 1, "k7": 1}),
    "lw_three_angles": ("lw", dict(n_gauss_angles=3), dict(use_megakernel=True), "pade", None,
                        {"fused_predict_lw_both": 1, "k7": 1}),
    "sw_staged": ("sw", {}, dict(use_megakernel=False), "lut", None, {"fused_predict_sw": 1}),
    "sw_fast_exp": ("sw", {}, dict(use_megakernel=True, fast_exponential=True), "pade", None,
                    {"fused_predict_sw": 1}),
}


@pytest.mark.parametrize("request_name", list(_OFF_CPU))
def test_allsky_drivers_off_the_cpu_launch_kernels_never_twins(tmp_path, models, monkeypatch,
                                                               request_name):
    """Off the CPU every all-sky request reaches the kernels' launches and
    never a kernel's plain twin. Meta tensors (shape and dtype without
    data) stand in for the card: the wrappers take any tensor not on the
    CPU to the kernel, the launches are recorded instead of run, and every
    twin raises. The fused route launches K1 or K2 once in the cloud mode of
    the coefficient file and nothing else; staged LW launches the MLP kernel
    once and the transport kernel once for all its angles, single-angle included
    (no PyTorch sweeps off the CPU); staged SW launches the MLP kernel."""
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    meta = torch.device("meta")
    launched, fused_modes = {}, []

    def mlp_launch(name, nets, x, col_dry, ngpt, n_out):
        launched[name] = launched.get(name, 0) + 1
        return [torch.empty(tuple(x.shape[:-1]) + (ngpt,), device=x.device)] * n_out

    def k7_launch(tau, *args):
        launched["k7"] = launched.get("k7", 0) + 1
        return [torch.empty((tau.shape[0], tau.shape[1] + 1), device=tau.device)] * 2

    def mega_launch(n_out):
        def launch(mode, *args, **kwargs):
            col_dry = args[5]
            fused_modes.append(mode)
            return [torch.empty((col_dry.shape[1], col_dry.shape[0] + 1),
                                device=col_dry.device)] * n_out
        return launch

    def twin(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran off the CPU")

    monkeypatch.setattr(mlp, "_launch", mlp_launch)
    monkeypatch.setattr(k7, "_launch", k7_launch)
    monkeypatch.setattr(k1, "_launch", mega_launch(2))
    monkeypatch.setattr(k2, "_launch", mega_launch(3))
    for mod, names in ((mlp, ("fused_predict_lw_both_plain", "fused_predict_tau_plain",
                              "fused_predict_sw_plain")),
                       (k7, ("lw_noscat_broadband_plain",)),
                       (k1, ("lw_clearsky_mega4_plain", "lw_clearsky_mega5_plain")),
                       (k2, ("sw_clearsky_megakernel_plain",)),
                       (plw, ("lw_solver_noscat_lay_major", "lw_broadband_sweeps"))):
        for name in names:
            monkeypatch.setattr(mod, name, twin)
    monkeypatch.setattr(pallsky, "lw_solver_noscat_lay_major", twin)

    band, kw, cfg, flavour, mode, expect = _OFF_CPU[request_name]
    garand = _garand(tmp_path, True)
    coeffs = write_cloud_file(tmp_path / "co.nc", band, 77, flavour)
    net = nn_model_from_arrays(*model_arrays(models[band][1][0]), device=meta)
    with pco(**cfg):
        route = resolve_use_megakernel(lw=band == "lw", models=[net] * (1 + (band == "sw")),
                                       device="cuda", **kw)
        assert route.kind == ("megakernel" if mode else "staged")
        if band == "lw":
            got = pallsky.allsky_lw(garand, coeffs, [net], ncol=6, device=meta, **kw)
        else:
            got = pallsky.allsky_sw(garand, coeffs, [net, net], ncol=6, device=meta, **kw)
    assert got.flux_dn.device == meta and tuple(got.flux_dn.shape) == (6, NLAY + 1)
    assert fused_modes == ([mode] if mode else [])
    assert launched == expect


def test_allsky_cuda_requests_are_refused_like_the_clear_sky_ones(tmp_path, models):
    """float64 on CUDA and nets the MLP kernel does not take are refused
    before any file is read, with the dispatch's reason."""
    for fn, ms, kw in ((pallsky.allsky_lw, models["lw"][1], dict(lw=True)),
                       (pallsky.allsky_sw, models["sw"][1], {})):
        reason = resolve_use_megakernel(models=ms, device="cuda", dtype=torch.float64, **kw).reason
        with pytest.raises(NotImplementedError, match=re.escape(reason)):
            fn("no-such-garand.nc", "no-such-coefficients.nc", ms, device="cuda",
               dtype=torch.float64)
