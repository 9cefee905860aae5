"""The port's command-line entry points against the JAX package's scripts,
and the last keyword arguments of the JAX package.

- scripts/torch_run_rfmip.py, torch_run_allsky.py and torch_eval_rfmip.py
  run in this process with ``--device cpu`` on the files
  ``testing.write_rfmip_file`` and the all-sky writers make under a temp
  dir (11 RFMIP experiments x 4 sites x 60 layers, so that every forcing
  pair of the eval metrics exists; the Garand file at 12 columns), with
  the in-repo demo nets under the reference's BEST file names. The JAX
  scripts run on the same files as subprocesses with JAX_PLATFORMS=cpu:
  run as scripts they have 64-bit mode off (this suite's conftest turns it
  on in process). Fluxes within LW 2e-3 / SW 2e-2 W/m2, the printed means
  likewise, the eval's metric block parsed as a training harness parses
  it: the same header, 8 values each within 2e-3.
- Without a CUDA device each port script's default ``--device cuda``
  exits non-zero naming ``--device cpu``; it does not run on the CPU.
- ``read_rfmip(forcing_index=)`` against JAX, and the F12 record.
- ``lw_solver_noscat_lay_major(inc_flux, lw_ds, sfc_source_jac)`` and
  ``lw_broadband_sweeps`` called positionally, against JAX: in float64 at
  rtol 1e-5; the solver in float32 too, at the LW bound (the linear-in-tau
  source factor amplifies an ulp of exp(-tau D) by about 1/(tau D) near
  the series threshold, so two float32 exps differ beyond 1e-5 relative
  there, as tests/test_torch_solvers.py holds the default call).
"""
import glob
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import rfmip_io as jio
from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip_io as pio
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.utils import cli, ncio
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
ART = os.path.join(ROOT, "artifacts")
LW_MODEL = os.path.join(ART, "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
LW64_MODEL = os.path.join(ART, "lw-g128-demo_both_64_64_HR_2.62e-01_FRC_2.07e+01.nc")
SW_MODEL = os.path.join(ART, "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the port's bounds against the JAX package
# the eval metrics: HR MAE [K/day] and flux biases [W/m2]. Measured here the
# two packages' blocks agree to the printed digits; the bound is the LW flux
# bound, which the biases inherit
METRIC_ATOL = 2e-3
NEXP, NSITES, NLAY, ALLSKY_NCOL = 11, 4, 60, 12
PORT_SCRIPTS = ("torch_run_rfmip", "torch_run_allsky", "torch_eval_rfmip",
                "torch_run_regression", "torch_train_demo", "torch_train_demo_sw",
                "torch_calibrate_sw_g112", "torch_calibrate_sw_solar")
# the flags each script requires (the reference checkout's files), here
# naming files that do not exist
REQUIRED_PATHS = {
    "torch_run_rfmip": ["--input", "missing.nc", "--models-dir", "missing"],
    "torch_run_allsky": ["--input", "missing.nc", "--lw-cloud-coeffs", "missing-lw.nc",
                         "--sw-cloud-coeffs", "missing-sw.nc", "--models-dir", "missing"],
    "torch_eval_rfmip": ["missing-model.nc", "--rfmip", "missing.nc"],
    "torch_run_regression": [],
    "torch_train_demo": ["--teacher", "missing-model.nc", "--rfmip", "missing.nc"],
    "torch_train_demo_sw": ["--models-dir", "missing", "--rfmip", "missing.nc"],
    "torch_calibrate_sw_g112": ["--rfmip", "missing.nc", "--models-dir", "missing"],
    "torch_calibrate_sw_solar": ["--garand", "missing.nc", "--sw-cloud-coeffs", "missing-sw.nc",
                                 "--models-dir", "missing"],
}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"cli_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(name, args, capsys) -> str:
    capsys.readouterr()
    assert load_script(name).main([*args, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def run_jax(script, args, cwd) -> str:
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, script), *args], cwd=cwd,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def numbers_after(label, text) -> list:
    return [float(m) for m in re.findall(re.escape(label) + r"\s*(-?[0-9.]+)", text)]


def read(path, name):
    with ncio.NCFile(str(path)) as f:
        return f.read(name, np.float64)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The RFMIP file, the all-sky files and two model dirs: the g-128 demo
    net (128 wide) and the SW demo net under the BEST names, and the
    64-wide LW demo net under the LW BEST name (the eval's reference)."""
    d = tmp_path_factory.mktemp("cli")
    T.write_rfmip_file(str(d / "rfmip.nc"), NEXP, NSITES, NLAY, seed=0)
    write_nc(str(d / "garand.nc"), *T.garand_nc_variables(T.synthesize_garand(NLAY, seed=0)))
    for band, spec in (("lw", lw_spectral_g128()), ("sw", sw_spectral_g112())):
        write_nc(str(d / f"{band}-lut.nc"), *T.cloud_optics_nc_variables(
            T.synthesize_cloud_optics(spec, seed=0, flavour="lut")))
    for sub, lw in (("models", LW_MODEL), ("models64", LW64_MODEL)):
        (d / sub).mkdir()
        shutil.copy(lw, d / sub / cli.LW_MODEL_FILE)
    for name in cli.SW_MODEL_FILES:
        shutil.copy(SW_MODEL, d / "models" / name)
    return d


def test_run_rfmip_matches_the_jax_script(files, capsys):
    common = ["--input", str(files / "rfmip.nc"), "--models-dir", str(files / "models"),
              "--tag", "t"]
    jout = run_jax("run_rfmip.py", [*common, "--output-dir", "jax"], files)
    pout = run_port("torch_run_rfmip", [*common, "--output-dir", str(files / "port")], capsys)
    for name, atol in (("rlu", LW_ATOL), ("rld", LW_ATOL), ("rsu", SW_ATOL), ("rsd", SW_ATOL)):
        got, ref = read(files / "port" / f"{name}_t.nc", name), read(files / "jax" / f"{name}_t.nc", name)
        assert got.shape == ref.shape == (NEXP, NSITES, NLAY + 1), name
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)
        np.testing.assert_array_equal(read(files / "port" / f"{name}_t.nc", "pres_level"),
                                      read(files / "jax" / f"{name}_t.nc", "pres_level"))
    for label in ("mean flux up  :", "mean flux down:"):
        got, ref = numbers_after(label, pout), numbers_after(label, jout)
        assert len(got) == len(ref) == 2, label
        assert abs(got[0] - ref[0]) <= LW_ATOL and abs(got[1] - ref[1]) <= SW_ATOL, label
    assert pout.count("    wrote ") == jout.count("    wrote ") == 4


def test_run_allsky_matches_the_jax_script(files, capsys):
    common = ["--input", str(files / "garand.nc"), "--lw-cloud-coeffs", str(files / "lw-lut.nc"),
              "--sw-cloud-coeffs", str(files / "sw-lut.nc"), "--models-dir",
              str(files / "models"), "--ncol", str(ALLSKY_NCOL), "--nloops", "2"]
    jout = run_jax("run_allsky.py", [*common, "--output", "jax-allsky.nc"], files)
    pout = run_port("torch_run_allsky", [*common, "--output", str(files / "port-allsky.nc")],
                    capsys)
    for name in ("lw_flux_up", "lw_flux_dn", "sw_flux_up", "sw_flux_dn"):
        got, ref = read(files / "port-allsky.nc", name), read(files / "jax-allsky.nc", name)
        assert got.shape == ref.shape == (ALLSKY_NCOL, NLAY + 1), name
        np.testing.assert_allclose(got, ref, rtol=0, atol=SW_ATOL if name[0] == "s" else LW_ATOL,
                                   err_msg=name)
    for band, atol in (("LW", LW_ATOL), ("SW", SW_ATOL)):
        pat = rf"mean {band} flux dn:\s*(-?[0-9.]+) up:\s*(-?[0-9.]+)"
        got, ref = re.findall(pat, pout), re.findall(pat, jout)
        assert len(got) == len(ref) == 1, band
        np.testing.assert_allclose(np.float64(got[0]), np.float64(ref[0]), rtol=0, atol=atol)
    assert f"ncol = {ALLSKY_NCOL}: LW+SW in" in pout


def metric_block(out: str):
    """The '--------'-delimited block as a training harness parses it:
    (the header's names, the 8 values)."""
    lines = out.splitlines()
    i = lines.index("--------")
    assert lines[i + 2] == "--------"
    return lines[i + 1].split(", "), [float(v) for v in lines[i + 3].split(",")]


def test_eval_rfmip_matches_the_jax_script(files, capsys):
    rfmip = ["--rfmip", str(files / "rfmip.nc")]
    ref = str(files / "ref64.nc")
    run_port("torch_eval_rfmip", [str(files / "models64" / cli.LW_MODEL_FILE), *rfmip,
                                  "--save-fluxes", ref], capsys)
    model = str(files / "models" / cli.LW_MODEL_FILE)
    jout = run_jax("eval_rfmip.py", [model, *rfmip, "--ref-fluxes", ref, "--save-fluxes",
                                     "jax-eval.nc", "--cpu"], files)
    pout = run_port("torch_eval_rfmip", [model, *rfmip, "--ref-fluxes", ref, "--save-fluxes",
                                         str(files / "port-eval.nc"), "--cpu", "--figures",
                                         str(files / "figs")], capsys)
    (jnames, jm), (pnames, pm) = metric_block(jout), metric_block(pout)
    assert pnames == jnames and len(pnames) == 8
    assert pout.splitlines()[-1] == ", ".join(f"{m:8.4f}" for m in pm)
    assert all(abs(v) > 0 for v in jm), jm  # every forcing pair exists in the file
    np.testing.assert_allclose(pm, jm, rtol=0, atol=METRIC_ATOL)
    for name in ("rlu", "rld"):
        np.testing.assert_allclose(read(files / "port-eval.nc", name),
                                   read(files / "jax-eval.nc", name), rtol=0, atol=LW_ATOL)
    for label in ("mean of flux_down is:", "mean of flux_up is:"):
        np.testing.assert_allclose(numbers_after(label, pout), numbers_after(label, jout),
                                   rtol=0, atol=LW_ATOL)
    assert len(glob.glob(str(files / "figs" / "*.png"))) == 2


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_scripts_refuse_cuda_without_a_device(name, monkeypatch, capsys):
    """The default --device cuda on a host without CUDA exits with status 2
    and names --device cpu, before any file is read (the required paths
    are given and name no file)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = REQUIRED_PATHS[name]
    with pytest.raises(SystemExit) as e:
        load_script(name).main(args)
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("forcing_index", [None, 1, 2, 3, 4])
def test_read_rfmip_forcing_index_matches_jax(files, forcing_index):
    path = str(files / "rfmip.nc")
    j = jio.read_rfmip(path, forcing_index=forcing_index)
    p = pio.read_rfmip(path, forcing_index=forcing_index)
    assert p.gas_concs.gas_names == j.gas_concs.gas_names
    expect = (pio.NN_LW_GASES if forcing_index in (None, 1)
              else pio.GAS_SETS[forcing_index][0])
    assert set(p.gas_concs.gas_names) <= set(expect)
    for g in p.gas_concs.gas_names:
        np.testing.assert_array_equal(p.gas_concs.get_raw(g).numpy(),
                                      np.asarray(j.gas_concs.get_raw(g)), err_msg=g)
    assert pio.GAS_SETS == jio.GAS_SETS


@pytest.mark.parametrize("forcing_index", [0, 5])
def test_read_rfmip_refuses_an_unknown_forcing_index(files, forcing_index):
    for reader in (jio.read_rfmip, pio.read_rfmip):
        with pytest.raises(ValueError, match="forcing_index must be in"):
            reader(str(files / "rfmip.nc"), forcing_index=forcing_index)


def test_forcing_index_3_reads_cfc12_not_cfc12eq_f12(files):
    """ROADMAP Queue 3 F12, logged, not repaired: the reference's
    determine_gas_names (mo_rfmip_io.F90:317-416) reads the equivalent
    concentrations cfc12eq and hfc134aeq for forcing index 3; both packages
    take only the k-distribution names of GAS_SETS and so read cfc12_GM and
    hfc134a_GM. The port follows the JAX package; this test records which
    variables each reads, so that a repair shows here."""
    path = str(files / "rfmip.nc")
    with ncio.NCFile(path) as f:
        raw = {v: f.read(v, np.float64)[0] * 1e-12
               for v in ("cfc12_GM", "cfc12eq_GM", "hfc134a_GM", "hfc134aeq_GM")}
    assert raw["cfc12_GM"] != raw["cfc12eq_GM"] and raw["hfc134a_GM"] != raw["hfc134aeq_GM"]
    for data in (jio.read_rfmip(path, forcing_index=3), pio.read_rfmip(path, forcing_index=3)):
        for gas, read_var, not_var in (("cfc12", "cfc12_GM", "cfc12eq_GM"),
                                       ("hfc134a", "hfc134a_GM", "hfc134aeq_GM")):
            got = float(np.asarray(data.gas_concs.get_raw(gas))[0, 0])
            assert got == pytest.approx(raw[read_var], rel=1e-6), gas
            assert got != pytest.approx(raw[not_var], rel=1e-3), gas


def _lay_major_inputs(rng, dtype, nlay=10, ncol=7, ngpt=16):
    f32 = lambda a: np.asarray(a, dtype)
    return {
        "tau": f32(np.exp(rng.uniform(np.log(1e-6), np.log(20.0), (nlay, ncol, ngpt)))),
        "lay": f32(rng.uniform(0.5, 4.0, (nlay, ncol, ngpt))),
        "lev": f32(rng.uniform(0.5, 4.0, (nlay + 1, ncol, ngpt))),
        "emis": f32(rng.uniform(0.9, 1.0, (ncol, ngpt))),
        "sfc": f32(rng.uniform(2.0, 5.0, (ncol, ngpt))),
        "inc_flux": f32(rng.uniform(0.0, 3.0, (ncol, ngpt))),
        "lw_ds": f32(rng.uniform(1.5, 2.0, (ncol, ngpt))),
        "sfc_source_jac": f32(rng.uniform(0.01, 0.1, (ncol, ngpt))),
    }


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("given", [(), ("inc_flux",), ("lw_ds",), ("sfc_source_jac",),
                                   ("inc_flux", "lw_ds", "sfc_source_jac")])
def test_lw_solver_noscat_lay_major_keywords_match_jax(rng, given, dtype):
    a = _lay_major_inputs(rng, dtype)
    tol = {"rtol": 1e-5} if dtype == np.float64 else {"rtol": 0, "atol": LW_ATOL}
    pos = [a[k] for k in ("tau", "lay", "lev", "emis", "sfc")]
    kw = {k: a[k] for k in given}
    ref = jlw.lw_solver_noscat_lay_major(*map(jnp.asarray, pos),
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
    got = plw.lw_solver_noscat_lay_major(*map(torch.from_numpy, pos),
                                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    for n in ("flux_up", "flux_dn", "flux_up_jac"):
        r, g = getattr(ref, n), getattr(got, n)
        assert (g is None) == (r is None) == (n == "flux_up_jac" and "sfc_source_jac" not in given)
        if g is not None:
            assert g.dtype == torch.from_numpy(a["tau"]).dtype
            np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=n, **tol)
    if "inc_flux" in given:  # the incident flux is the top level's down flux
        np.testing.assert_allclose(got.flux_dn[:, 0].numpy(), a["inc_flux"].sum(-1), rtol=1e-6)


def test_lw_broadband_sweeps_takes_the_jax_positional_arguments(rng):
    """(trans, src_dn, src_up, sfc_emis, sfc_source, inc_flux, weight,
    sfc_source_jac) positionally, inc_flux a flux, as the JAX function."""
    a = _lay_major_inputs(rng, np.float64)
    trans = np.exp(-a["tau"])
    args = [trans, a["lay"], a["lev"][1:], a["emis"], a["sfc"], a["inc_flux"], 0.3,
            a["sfc_source_jac"]]
    wrap = lambda f, x: x if isinstance(x, float) else f(x)
    ref = jlw.lw_broadband_sweeps(*(wrap(jnp.asarray, x) for x in args))
    got = plw.lw_broadband_sweeps(*(wrap(torch.from_numpy, x) for x in args))
    for n in ("flux_up", "flux_dn", "flux_up_jac"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   rtol=1e-5, err_msg=n)
    np.testing.assert_allclose(got.flux_dn[:, 0].numpy(), a["inc_flux"].sum(-1), rtol=1e-6)
