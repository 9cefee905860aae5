"""The port's clear-sky regression harness (drivers/clear_sky_regression.py)
against the JAX package's, as tests/test_regression_harness.py runs it:
the 10 LW and 3 SW solver variants over one atmosphere on the synthetic
k-distributions (LW 16 bands x 4 g-points, SW 14 x 4), the cross-checks of
verify_variants with the core invariants at 1e-5 relative, and the fields
file. Every field agrees with the JAX package's within LW 2e-3 / SW 2e-2
W/m2 (the port's bounds against the JAX package).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.drivers import clear_sky_regression as jreg
from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.drivers import clear_sky_regression as preg
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs as PGasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist as pload_kdist
from rte_rrtmgp_nn_tpu_torch.utils import ncio
from test_lut_gas_optics import GASES, make_atmosphere
from test_torch_core import CPU

TIGHT = ("lw_vr", "lw_subset", "lw_inc1scl", "lw_inc2str", "sw_vr", "sw_tsi")


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    d = tmp_path_factory.mktemp("kd")
    plw, psw = str(d / "lw.nc"), str(d / "sw.nc")
    generate_kdist_nc(plw, kind="lw", gpts_per_band=4, nband=16)
    generate_kdist_nc(psw, kind="sw", gpts_per_band=4, nband=14)
    jlw, jsw = jload_kdist(plw, GASES), jload_kdist(psw, GASES)
    plw_kd, psw_kd = pload_kdist(plw, GASES, device=CPU), pload_kdist(psw, GASES, device=CPU)
    play, plev, tlay, tlev, tsfc, gc = make_atmosphere(ncol=6, nlay=14)
    pgc = PGasConcs.create({k: np.array(v) for k, v in gc.concs.items()})
    emis = np.full((6, jlw.nband), 0.97)
    mu0, alb = np.full((6,), 0.7), np.full((6, jsw.nband), 0.12)
    atm = [np.asarray(a) for a in (play, plev, tlay, tlev, tsfc)]
    jf = jreg.run_lw_variants(jlw, play, plev, tlay, tlev, tsfc, gc, jnp.asarray(emis))
    jf.update(jreg.run_sw_variants(jsw, play, plev, tlay, gc, jnp.asarray(mu0), jnp.asarray(alb)))
    pf = preg.run_lw_variants(plw_kd, *atm, pgc, emis, device=CPU)
    pf.update(preg.run_sw_variants(psw_kd, *atm[:3], pgc, mu0, alb, device=CPU))
    return pf, jf


def test_variants_match_jax(fields):
    pf, jf = fields
    assert sorted(pf) == sorted(jf)
    for name in pf:
        assert pf[name].shape == np.shape(jf[name]), name
        atol = 2e-3 if name.startswith("lw") else 2e-2
        np.testing.assert_allclose(pf[name], np.asarray(jf[name]), rtol=0, atol=atol, err_msg=name)


def test_verification_invariants_and_fields_file(fields, tmp_path):
    pf, jf = fields
    checks = preg.verify_variants(pf)
    assert sorted(checks) == sorted(jreg.verify_variants(jf))
    for tight in TIGHT:
        assert checks[tight] < 1e-5, (tight, checks[tight])
    assert "lw_flux_up_3ang" in pf and "lw_flux_up_optang" in pf
    p = str(tmp_path / "test_atmospheres.nc")
    preg.write_fields(p, pf)
    with ncio.NCFile(p) as f:
        assert f.has_var("lw_flux_up_vr") and f.has_var("sw_flux_dir")
        assert f.var_dims("lw_flux_up_subset") == ("col_sub", "lev")
        np.testing.assert_array_equal(f.read("lw_flux_up"), pf["lw_flux_up"].astype(np.float64))
    broken = dict(pf, lw_flux_up_vr=pf["lw_flux_up_vr"] + 1.0)
    with pytest.raises(AssertionError, match="lw_vr"):
        preg.verify_variants(broken)
