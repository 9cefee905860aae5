"""The public names the port had still to take from modules it had already
ported, and two small modules, against the JAX package on the same numpy
inputs: the unreduced spectral mappings, the model writer (files written by
one package and read by the other hold identical arrays; a save and reload
gives bit-identical fluxes) and the final-activation output, set_checks,
GasConcs.set_vmr / subset, RFMIPData.block, the containers' extents,
zeros_nstr, SourceFuncLW.subset, the netCDF reader's listing functions,
zero_array, the package's exports; McICA cloud sampling on shared numpy
draws; the RFMIP flux writer and the golden-file comparison."""
import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rte_rrtmgp_nn_tpu_torch as ppkg
from rte_rrtmgp_nn_tpu import gas_concs as jgc
from rte_rrtmgp_nn_tpu import optical_props as jop
from rte_rrtmgp_nn_tpu import sources as jsrc
from rte_rrtmgp_nn_tpu.drivers import flux_output as jfo
from rte_rrtmgp_nn_tpu.extensions import cloud_sampling as jcs
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.models import network as jnet
from rte_rrtmgp_nn_tpu.spectral import SpectralMapping as JSM
from rte_rrtmgp_nn_tpu.utils import ncio as jncio
from rte_rrtmgp_nn_tpu.utils import validation as jval
from rte_rrtmgp_nn_tpu_torch import gas_concs as pgc
from rte_rrtmgp_nn_tpu_torch import optical_props as pop
from rte_rrtmgp_nn_tpu_torch import sources as psrc
from rte_rrtmgp_nn_tpu_torch.drivers import flux_output as pfo
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw
from rte_rrtmgp_nn_tpu_torch.extensions import cloud_sampling as pcs
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models import network as pnet
from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping as PSM
from rte_rrtmgp_nn_tpu_torch.testing import ALL_ACTIVATIONS, synthesize_rfmip
from rte_rrtmgp_nn_tpu_torch.utils import ncio as pncio
from rte_rrtmgp_nn_tpu_torch.utils import validation as pval
from test_torch_core import (
    CPU, LW_MODEL, jax_model_from_arrays, random_arrays, rfmip_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules (each package's __init__ exports the object ``config`` under their name)
jconfig = importlib.import_module("rte_rrtmgp_nn_tpu.config")
pconfig = importlib.import_module("rte_rrtmgp_nn_tpu_torch.config")


# -- the unreduced spectral mappings --------------------------------------------

@pytest.mark.parametrize("which", ["lw_spectral_g256", "sw_spectral_g224"])
def test_unreduced_spectral_mappings_match_jax(which):
    js, ps = getattr(jplanck, which)(), getattr(pplanck, which)()
    assert ps.band_lims_gpt == js.band_lims_gpt and ps.band_lims_wvn == js.band_lims_wvn
    assert (ps.nband, ps.ngpt) == (js.nband, js.ngpt) == (ps.nband, 16 * ps.nband)
    np.testing.assert_array_equal(ps.gpt2band, js.gpt2band)
    np.testing.assert_allclose(pplanck.gpt_weights_for(ps), jplanck.gpt_weights_for(js))


# -- the model format -------------------------------------------------------------

def _random_pair(seed):
    arrays = random_arrays((5, 9, 7, 6), ("tanh", "relu", "sigmoid"), seed)
    return arrays, jax_model_from_arrays(*arrays), pnet.nn_model_from_arrays(*arrays, device=CPU)


def _same_model(a, b):
    assert tuple(a.activations) == tuple(b.activations)
    assert tuple(a.input_names) == tuple(b.input_names)
    for x, y in zip([*a.weights, *a.biases, a.input_min, a.input_max, a.output_mean, a.output_std],
                    [*b.weights, *b.biases, b.input_min, b.input_max, b.output_mean, b.output_std]):
        x = x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.detach().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_save_model_netcdf_both_ways(tmp_path):
    """A model the port writes loads in the JAX package with identical
    arrays, and one the JAX package writes loads in the port likewise; the
    two files hold the same variables, dimensions and attributes."""
    _, jm, pm = _random_pair(11)
    p_path, j_path = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    pnet.save_model_netcdf(p_path, pm, attrs={"score": 0.25})
    jnet.save_model_netcdf(j_path, jm, attrs={"score": 0.25})
    _same_model(jnet.load_model_netcdf(p_path), jm)
    _same_model(pnet.load_model_netcdf(j_path, device=CPU), pm)
    with jncio.NCFile(p_path) as a, jncio.NCFile(j_path) as b:
        assert a.variables() == b.variables()
        for v in a.variables():
            assert a.var_dims(v) == b.var_dims(v)
            np.testing.assert_array_equal(a.read(v), b.read(v))
        assert a._nc3.score == b._nc3.score == 0.25


def test_save_reload_gives_bit_identical_fluxes(tmp_path):
    model = pnet.load_model_netcdf(LW_MODEL, device=CPU)
    path = str(tmp_path / "lw.nc")
    pnet.save_model_netcdf(path, model)
    again = pnet.load_model_netcdf(path, device=CPU)
    _, data = rfmip_pair(synthesize_rfmip(6, 8, seed=12))
    a = rfmip_clear_sky_lw(data, [model], device=CPU)
    b = rfmip_clear_sky_lw(data, [again], device=CPU)
    for n in ("flux_up", "flux_dn"):
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@pytest.mark.parametrize("act", ALL_ACTIVATIONS)
def test_apply_with_final_activation_matches_jax(act):
    arrays = random_arrays((5, 8, 6), ("softsign", act), 13)
    jm, pm = jax_model_from_arrays(*arrays), pnet.nn_model_from_arrays(*arrays, device=CPU)
    x = np.random.default_rng(2).uniform(-1, 1, (7, 5)).astype(np.float32)
    got = pm.apply_with_final_activation(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply_with_final_activation(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got, pm(torch.from_numpy(x)))


# -- config, gases, RFMIP blocks ---------------------------------------------------

def test_set_checks_as_jax():
    saved = [(c.check_extents, c.check_values) for c in (pconfig.config, jconfig.config)]
    try:
        for mod in (pconfig, jconfig):
            mod.set_checks(check_extents=True)
            mod.set_checks(check_values=True)
            mod.set_checks(check_extents=False)
        assert ((pconfig.config.check_extents, pconfig.config.check_values)
                == (jconfig.config.check_extents, jconfig.config.check_values) == (False, True))
        assert ppkg.set_checks is pconfig.set_checks
    finally:
        for c, (e, v) in zip((pconfig.config, jconfig.config), saved):
            c.check_extents, c.check_values = e, v


@pytest.mark.parametrize("bad", [1.5, -1e-9, np.array([[0.1, 2.0]])])
def test_set_vmr_checks_its_range_as_jax(bad):
    for mod in (pgc, jgc):
        gc = mod.GasConcs.create({"co2": 4e-4})
        with pytest.raises(ValueError, match=r"set_vmr\(ch4\): values outside \[0,1\]"):
            gc.set_vmr("ch4", bad)


def test_set_vmr_and_subset_match_jax():
    rng = np.random.default_rng(3)
    h2o = rng.uniform(0, 0.02, (5, 4)).astype(np.float32)
    o3 = rng.uniform(0, 1e-5, 4).astype(np.float32)
    jg = jgc.GasConcs.create({"h2o": h2o, "co2": np.float32(4e-4)})
    pg = pgc.GasConcs.create({"h2o": h2o, "co2": np.float32(4e-4)})
    jg2, pg2 = jg.set_vmr("Ozone", o3), pg.set_vmr("Ozone", o3)
    assert pg2.gas_names == jg2.gas_names == ["h2o", "co2", "o3"] and pg.gas_names == ["h2o", "co2"]
    for start, n in ((0, 1), (1, 3), (4, 1)):
        js, ps = jg2.subset(start, n), pg2.subset(start, n)
        for g in js.gas_names:
            np.testing.assert_array_equal(ps.get_raw(g).numpy(), np.asarray(js.get_raw(g)))


@pytest.mark.parametrize("start,n", [(0, 1), (3, 4), (9, 5)])
def test_rfmip_block_matches_jax(start, n):
    jd, pd = rfmip_pair(synthesize_rfmip(10, 6, seed=14))
    jb, pb = jd.block(start, n), pd.block(start, n)
    assert (pb.ncol, pb.nexp, pb.nsites, pb.nlay, pb.top_at_1) == (
        jb.ncol, jb.nexp, jb.nsites, jb.nlay, jb.top_at_1)
    for f in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis", "sfc_alb", "sza", "tsi"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f))
    for g in jb.gas_concs.gas_names:
        np.testing.assert_array_equal(pb.gas_concs.get_raw(g).numpy(),
                                      np.asarray(jb.gas_concs.get_raw(g)))


def test_rfmip_single_column_block_solves_as_its_column():
    """block(0, 1), the single-column edge case, solves like column 0 of
    the whole problem."""
    _, pd = rfmip_pair(synthesize_rfmip(5, 8, seed=15))
    model = pnet.load_model_netcdf(LW_MODEL, device=CPU)
    whole = rfmip_clear_sky_lw(pd, [model], device=CPU)
    one = rfmip_clear_sky_lw(pd.block(0, 1), [model], device=CPU)
    assert tuple(one.flux_up.shape) == (1, 9)
    for n in ("flux_up", "flux_dn"):
        np.testing.assert_allclose(getattr(one, n).numpy(), getattr(whole, n)[:1].numpy(),
                                   rtol=1e-6, atol=1e-4)


# -- containers ------------------------------------------------------------------------

def _spectral_pair():
    lims = np.array([[0, 3], [3, 5]])
    wvn = np.array([[10.0, 250.0], [250.0, 500.0]])
    return JSM.create(lims, wvn), PSM.create(lims, wvn)


def test_container_extents_and_zeros_nstr_match_jax():
    js, ps = _spectral_pair()
    jz, pz = jop.zeros_nstr(3, 4, 6, js), pop.zeros_nstr(3, 4, 6, ps)
    assert (pz.nmom, pz.ncol, pz.nlay, pz.ngpt) == (jz.nmom, jz.ncol, jz.nlay, jz.ngpt) == (3, 4, 6, 5)
    for f in ("tau", "ssa", "p"):
        assert getattr(pz, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(pz, f).numpy(), np.asarray(getattr(jz, f)))
    assert pz.ssa.data_ptr() != pz.tau.data_ptr()  # separate storage, as the other zeros_*
    for jf, pf in ((jop.zeros_1scl, pop.zeros_1scl), (jop.zeros_2str, pop.zeros_2str)):
        j, p = jf(2, 7, js), pf(2, 7, ps)
        assert (p.ncol, p.nlay, p.ngpt) == (j.ncol, j.nlay, j.ngpt) == (2, 7, 5)


def test_source_extents_and_subset_match_jax():
    js, ps = _spectral_pair()
    rng = np.random.default_rng(5)
    lay, lev = rng.uniform(0, 1, (6, 4, 5)), rng.uniform(0, 1, (6, 5, 5))
    sfc, jac, pf = rng.uniform(0, 1, (6, 5)), rng.uniform(0, 1, (6, 5)), rng.uniform(0, 1, (6, 4, 5))
    for frac in (None, pf):
        j = jsrc.SourceFuncLW(*(jnp.asarray(a) for a in (lay, lev, sfc, jac)), js,
                              None if frac is None else jnp.asarray(frac))
        p = psrc.SourceFuncLW(*(torch.from_numpy(a) for a in (lay, lev, sfc, jac)), ps,
                              None if frac is None else torch.from_numpy(frac))
        assert (p.ncol, p.nlay, p.ngpt) == (j.ncol, j.nlay, j.ngpt) == (6, 4, 5)
        jsub, psub = j.subset(2, 3), p.subset(2, 3)
        for f in ("lay_source", "lev_source", "sfc_source", "sfc_source_jac", "planck_frac"):
            a, b = getattr(psub, f), getattr(jsub, f)
            assert (a is None) == (b is None) == (f == "planck_frac" and frac is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sw_j = jsrc.SourceFuncSW(jnp.asarray(sfc), js)
    sw_p = psrc.SourceFuncSW(torch.from_numpy(sfc), ps)
    assert (sw_p.ncol, sw_p.ngpt) == (sw_j.ncol, sw_j.ngpt) == (6, 5)


# -- netCDF listing, zero_array, exports ---------------------------------------------

def test_ncio_listing_and_read_all_match_jax(tmp_path):
    path = str(tmp_path / "f.nc")
    rng = np.random.default_rng(6)
    variables = {"a": (("x", "y"), rng.uniform(0, 1, (2, 3))),
                 "b": (("y",), np.arange(3, dtype=np.int32)),
                 "c": (("x", "n"), pncio.strings_to_chararray(["ab", "c"], 4))}
    pncio.write_nc(path, {"x": 2, "y": 3, "n": 4}, variables)
    with pncio.NCFile(path) as p, jncio.NCFile(path) as j:
        assert p.variables() == j.variables() and sorted(p.variables()) == ["a", "b", "c"]
        assert [p.var_dims(v) for v in "abc"] == [j.var_dims(v) for v in "abc"] == [
            ("x", "y"), ("y",), ("x", "n")]
    for names in (None, ["b"]):
        got, ref = pncio.read_all(path, names), jncio.read_all(path, names)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_zero_array_matches_jax():
    got, ref = pval.zero_array((2, 3)), jval.zero_array((2, 3))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape and not got.any()
    assert pval.zero_array([4], dtype=torch.float64).dtype == torch.float64


def test_package_exports_what_the_jax_package_exports():
    with open(os.path.join(REPO, "rte_rrtmgp_nn_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names}
    assert len(names) > 40
    assert sorted(n for n in names if not hasattr(ppkg, n)) == []


# -- McICA cloud sampling ----------------------------------------------------------------

def _sampling_inputs(seed=8, ncol=5, nlay=7, ngpt=6):
    rng = np.random.default_rng(seed)
    randoms = rng.uniform(0, 1, (ncol, nlay, ngpt)).astype(np.float32)
    cf = np.where(rng.uniform(0, 1, (ncol, nlay)) > 0.4, rng.uniform(0, 1, (ncol, nlay)), 0.0)
    cf[:, 2] = 0.0  # a clear layer between cloudy ones
    overlap = rng.uniform(0, 1, (ncol, nlay - 1)).astype(np.float32)
    overlap[0] = 1.0  # maximum overlap in column 0
    return randoms, cf.astype(np.float32), overlap


def test_sampled_masks_match_jax():
    randoms, cf, overlap = _sampling_inputs()
    t, j = torch.from_numpy, jnp.asarray
    got = pcs.sampled_mask_max_ran(t(randoms), t(cf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcs.sampled_mask_max_ran(j(randoms), j(cf))))
    got_e = pcs.sampled_mask_exp_ran(t(randoms), t(cf), t(overlap))
    np.testing.assert_array_equal(
        got_e.numpy(), np.asarray(jcs.sampled_mask_exp_ran(j(randoms), j(cf), j(overlap))))
    assert got.dtype == torch.bool and got.any() and not got.all()
    assert not got[:, 2].any()  # the clear layer
    # rho = 1 is maximum overlap
    np.testing.assert_array_equal(got_e[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("kind", ["1scl", "2str"])
def test_draw_samples_match_jax(kind):
    rng = np.random.default_rng(9)
    js, ps = _spectral_pair()
    band = [rng.uniform(0, 1, (3, 4, 2)).astype(np.float32) for _ in range(3)]
    jb, pb = JSM.bands_only(js.band_lims_wvn_array), PSM.bands_only(ps.band_lims_wvn_array)
    if kind == "1scl":
        jc, pc = jop.OpticalProps1scl(jnp.asarray(band[0]), jb), pop.OpticalProps1scl(
            torch.from_numpy(band[0]), pb)
    else:
        jc = jop.OpticalProps2str(*(jnp.asarray(b) for b in band), jb)
        pc = pop.OpticalProps2str(*(torch.from_numpy(b) for b in band), pb)
    mask = rng.uniform(0, 1, (3, 4, 5)) > 0.5
    got = pcs.draw_samples_to(ps, torch.from_numpy(mask), pc)
    ref = jcs.draw_samples_to(js, jnp.asarray(mask), jc)
    assert type(got).__name__ == type(ref).__name__ and got.spectral is ps
    fields = ("tau",) if kind == "1scl" else ("tau", "ssa", "g")
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    bmask = mask[..., :2]
    got = pcs.draw_samples(torch.from_numpy(bmask), pc)
    ref = jcs.draw_samples(jnp.asarray(bmask), jc)
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    for mod, c in ((pcs, pc), (jcs, jc)):
        with pytest.raises(ValueError, match="draw_samples_to"):
            mod.draw_samples(np.ones((3, 4, 5), bool), c)
    with pytest.raises(ValueError, match="must be band-resolved"):
        pcs.draw_samples_to(ps, torch.from_numpy(mask), pop.OpticalProps1scl(
            torch.zeros(3, 4, 5), ps))


# -- flux output -------------------------------------------------------------------------

def test_write_fluxes_rfmip_and_compare_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(10)
    nexp, nsites, nlev = 2, 3, 5
    fluxes = {"rlu": rng.uniform(0, 400, (6, nlev)), "rsd": rng.uniform(0, 1300, (6, nlev))}
    for plev in (rng.uniform(0, 1e5, (6, nlev)), np.linspace(1.0, 1e5, nlev)):
        p_path, j_path = str(tmp_path / "p.nc"), str(tmp_path / "j.nc")
        pfo.write_fluxes_rfmip(p_path, {k: torch.from_numpy(v) for k, v in fluxes.items()},
                               plev, nexp, nsites)
        jfo.write_fluxes_rfmip(j_path, fluxes, plev, nexp, nsites)
        got, ref = pncio.read_all(p_path), jncio.read_all(j_path)
        assert list(got) == list(ref) == ["rlu", "rsd", "pres_level"]
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == (nexp, nsites, nlev)
            np.testing.assert_array_equal(got[k], ref[k])
        for mod in (pfo, jfo):
            assert mod.compare_flux_files(p_path, j_path, verbose=False) == {
                "passed": True, "max_diffs": {"rlu": 0.0, "rsd": 0.0, "pres_level": 0.0}}
    bumped = dict(fluxes, rsd=fluxes["rsd"] + 1e-3)
    jfo.write_fluxes_rfmip(j_path, bumped, plev, nexp, nsites)
    for kw in ({}, {"variables": ["rsd"], "fail_threshold": 1e-2}):
        got = pfo.compare_flux_files(p_path, j_path, verbose=True, **kw)
        ref = jfo.compare_flux_files(p_path, j_path, verbose=True, **kw)
        assert got == ref and got["passed"] == bool(kw)
    out = capsys.readouterr().out
    assert out.count("rsd: max abs diff") == 4 and out.count("FAILED variables") == 2
    # no common variable is a failed comparison, not a vacuous pass
    pncio.write_nc(str(tmp_path / "x.nc"), {"a": 2}, {"flux_up": (("a",), np.ones(2, np.float32))})
    for mod in (pfo, jfo):
        assert mod.compare_flux_files(p_path, str(tmp_path / "x.nc"), verbose=False) == {
            "passed": False, "max_diffs": {}}
