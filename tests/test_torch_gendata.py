"""The port's training-data generation (training/gendata.py) against the
JAX package's, on test_training's mini RFMIP problem (3 experiments x 8
sites x 16 layers) and the synthetic k-distributions (LW 16 bands x 4
g-points, SW 14 x 4).

The arrays agree within LW 2e-3 / SW 2e-2 W/m2 on fluxes (the port's
kernel-vs-staged bounds; the port solves LW broadband, the JAX package sums
spectral fluxes) and 1e-5 relative on tau, ssa, the Planck fraction and
col_dry; the features exactly where the inputs are the same float32 numbers
and to 1e-6 through log and the fourth roots. The files have the same
variables, dimensions, dtypes and attributes, and each package reads the
other's file back.
"""
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.training import gendata as jgen
from rte_rrtmgp_nn_tpu.utils import ncio as jncio
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import RFMIPData as PData
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs as PGasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload_kdist
from rte_rrtmgp_nn_tpu_torch.training import gendata as pgen
from test_lut_gas_optics import GASES
from test_torch_core import CPU
from test_training import mini_rfmip  # noqa: F401  (fixture)

LW_ATOL, SW_ATOL, RTOL = 2e-3, 2e-2, 1e-5


def port_data(jd) -> PData:
    """The port's RFMIPData of a JAX RFMIPData (the same numpy arrays)."""
    gases = PGasConcs.create({k: np.array(v) for k, v in jd.gas_concs.concs.items()})
    return PData(play=jd.play, plev=jd.plev, tlay=jd.tlay, tlev=jd.tlev, tsfc=jd.tsfc,
                 sfc_emis=jd.sfc_emis, sfc_alb=jd.sfc_alb, sza=jd.sza, tsi=jd.tsi,
                 gas_concs=gases, nexp=jd.nexp, nsites=jd.nsites, nlay=jd.nlay,
                 top_at_1=jd.top_at_1)


@pytest.fixture(scope="module")
def kd_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("kd")
    paths = {"lw": str(d / "lw.nc"), "sw": str(d / "sw.nc")}
    generate_kdist_nc(paths["lw"], kind="lw", gpts_per_band=4, nband=16)
    generate_kdist_nc(paths["sw"], kind="sw", gpts_per_band=4, nband=14)
    return paths


def _file(path):
    with jncio.NCFile(path) as f:
        names = sorted(f.variables())
        return {n: (f.var_dims(n), f.read(n)) for n in names}


def _same_layout(p_path, j_path):
    p, j = _file(p_path), _file(j_path)
    assert list(p) == list(j)
    for n in p:
        assert p[n][0] == j[n][0] and p[n][1].dtype == j[n][1].dtype and \
            p[n][1].shape == j[n][1].shape, n
    from scipy.io import netcdf_file
    with netcdf_file(p_path, "r", mmap=False) as a, netcdf_file(j_path, "r", mmap=False) as b:
        assert a.dimensions == b.dimensions
        assert a.features == b.features


def _hold(out_p, out_j, flux_names, flux_atol, exact, rel):
    for n in exact:
        np.testing.assert_allclose(out_p[n], np.asarray(out_j[n]), rtol=1e-6, err_msg=n)
    for n in rel:
        np.testing.assert_allclose(out_p[n], np.asarray(out_j[n]), rtol=RTOL, atol=1e-30,
                                   err_msg=n)
    for n in flux_names:
        np.testing.assert_allclose(out_p[n], np.asarray(out_j[n]), rtol=0, atol=flux_atol,
                                   err_msg=n)


def test_lw_gendata_matches_jax_and_files_cross_read(kd_paths, mini_rfmip, tmp_path):
    jkd = jload_kdist(kd_paths["lw"], GASES)
    pkd = pload_kdist(kd_paths["lw"], GASES, device=CPU)
    jp, pp = str(tmp_path / "j.nc"), str(tmp_path / "p.nc")
    out_j = jgen.generate_lw_training_data(jp, jkd, mini_rfmip, gas_order=GASES)
    out_p = pgen.generate_lw_training_data(pp, pkd, port_data(mini_rfmip), gas_order=GASES)
    assert out_p["tau_lw_gas"].shape == (3, 8, 16, 64)
    _hold(out_p, out_j, ("rsu", "rsd"), LW_ATOL, ("rrtmgp_lw_input", "pres_level"),
          ("tau_lw_gas", "planck_fraction", "col_dry"))
    _same_layout(pp, jp)
    for pred in ("lw_absorption", "lw_planck_frac", "lw_both"):
        for a, b in ((jgen.load_training_data(pp, pred), pgen.load_training_data(pp, pred)),
                     (pgen.load_training_data(jp, pred), jgen.load_training_data(jp, pred))):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    x, y, cd = pgen.load_training_data(pp, "lw_both")
    assert x.shape == (3 * 8 * 16, 7) and y.shape == (3 * 8 * 16, 128) and cd.dtype == np.float64
    np.testing.assert_allclose(out_p["planck_fraction"].sum(-1), pkd.nband, rtol=1e-4)


def test_sw_gendata_matches_jax_and_files_cross_read(kd_paths, mini_rfmip, tmp_path):
    jkd = jload_kdist(kd_paths["sw"], GASES)
    pkd = pload_kdist(kd_paths["sw"], GASES, device=CPU)
    jp, pp = str(tmp_path / "j.nc"), str(tmp_path / "p.nc")
    out_j = jgen.generate_sw_training_data(jp, jkd, mini_rfmip, gas_order=GASES)
    out_p = pgen.generate_sw_training_data(pp, pkd, port_data(mini_rfmip), gas_order=GASES)
    _hold(out_p, out_j, ("rsu", "rsd", "rsd_dir"), SW_ATOL, ("rrtmgp_sw_input", "pres_level"),
          ("tau_sw_gas", "ssa_sw_gas", "col_dry"))
    _same_layout(pp, jp)
    for pred in ("sw_absorption", "sw_rayleigh"):
        for u, v in zip(jgen.load_training_data(pp, pred), pgen.load_training_data(jp, pred)):
            assert u.shape == v.shape and u.dtype == v.dtype
            np.testing.assert_allclose(u, v, rtol=RTOL, atol=1e-30)
    _, ya, _ = pgen.load_training_data(pp, "sw_absorption")
    _, yr, _ = pgen.load_training_data(pp, "sw_rayleigh")
    np.testing.assert_allclose(ya + yr, out_p["tau_sw_gas"].reshape(-1, pkd.ngpt),
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="unknown predictand"):
        pgen.load_training_data(pp, "sw_both")


def test_pack_features_matches_jax(mini_rfmip):
    import jax.numpy as jnp

    d, pd = mini_rfmip, port_data(mini_rfmip)
    ref = jgen.pack_features(jnp.asarray(d.play), jnp.asarray(d.tlay), d.gas_concs, GASES)
    gases = PGasConcs({k: v.float() for k, v in pd.gas_concs.concs.items()})
    got = pgen.pack_features(torch.as_tensor(d.play), torch.as_tensor(d.tlay), gases, GASES)
    assert got.shape == (24, 16, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_kdist_planck_table_is_contiguous_for_the_kernels(kd_paths):
    """A k-distribution file stores totplnk (band, temperature): the loaded
    table is made contiguous, as K1, K6 and the drivers' launch checks read
    it (rfmip_clear_sky_lw with a k-distribution's table on CUDA refused it
    as "totplnk: not contiguous" before)."""
    import jax.numpy as jnp

    table = pload_kdist(kd_paths["lw"], GASES, device=CPU).planck
    assert table.totplnk.is_contiguous() and table.totplnk_diff.is_contiguous()
    ref = jload_kdist(kd_paths["lw"], GASES).planck
    np.testing.assert_array_equal(table.totplnk.numpy(), np.asarray(ref.totplnk))
    t = np.linspace(150.0, 360.0, 41)
    np.testing.assert_allclose(table.interpolate(torch.as_tensor(t)).numpy(),
                               np.asarray(ref.interpolate(jnp.asarray(t))), rtol=1e-6)
