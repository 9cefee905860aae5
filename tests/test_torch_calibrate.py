"""scripts/torch_calibrate_sw_g112.py and torch_calibrate_sw_solar.py
against the JAX package's scripts/calibrate_sw_g112.py and
calibrate_sw_solar.py, on the CPU.

The files are made under a temp dir: the RFMIP file of
tests/test_torch_train_demo.py (11 experiments x 4 sites x 60 layers), a
models dir with the in-repo SW absorption demo net under both g-112 BEST
names and a 224-output net under the g-224 BEST name
(testing.sw_g224_net_arrays from seed 0, written by the port), and a
synthetic Garand file with lookup-table SW cloud coefficients
(testing.synthesize_garand / synthesize_cloud_optics, seed 0). Each JAX
script runs as a subprocess with JAX_PLATFORMS=cpu and its file constants
(and OUT, and the solar targets) pointed at these; each port script runs in
this process with --device cpu.

Held, port against JAX:
- calibrate_sw_g112: the written weights (each band's sum to 1) to
  G112_RTOL plus G112_ATOL, the per-band residual lines to their printed
  digits (G112_RESID_ATOL). NNLS on float32 optical depths that differ by
  rounding moves a small weight relatively more than the taus move:
  measured on this suite's CPU, 3.0e-7 at most, 3.8e-5 relative for a
  weight above 1e-6; the same 63 weights are 0 in both.
- calibrate_sw_solar: the 14 band responses within SW 2e-2 W/m2 (printed
  to 1e-3; measured 8.6e-4 between the unrounded port's and JAX's printed
  values); the fractions within SOLAR_ATOL: a fraction moves its band's
  source by TSI times its change, 0.014 W/m2 at 1e-5, inside the SW flux
  bound (the normal equations amplify the responses' float32 differences:
  measured 7.9e-7, 1.2e-4 relative); beyond it float64 decides (the port's
  SW takes float64 two-stream coefficients, the JAX script's float32 ones,
  ROADMAP Queue 3 F1): the port within SOLAR_ATOL of the fractions fitted
  to the float64 responses and nearer to them than JAX; the achieved fluxes equal to the
  targets. The targets are a point that positive fractions reach (the
  port's responses times the shipped SW_SOLAR_BAND_FRAC_CAL); with the
  reference's targets the stand-in nets need negative fractions, and both
  scripts refuse them alike.
Neither script writes into either package or artifacts/ when its outputs
are pointed elsewhere; the port's default --out is its own weights module.
"""
import hashlib
import os
import re
import shutil

import numpy as np
import pytest

from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import SW_SOLAR_BAND_FRAC_CAL, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.models.network import (
    load_model_netcdf, nn_model_from_arrays, save_model_netcdf)
from rte_rrtmgp_nn_tpu_torch.utils import cli
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc
from test_torch_train_demo import NEXP, NLAY, NSITES, ROOT, SW_TEACHER, load_script, run_jax

G112_RTOL, G112_ATOL, G112_RESID_ATOL = 1e-5, 1e-6, 1e-5
SW_ATOL = 2e-2
SOLAR_ATOL = 1e-5
GUARDED = ("rte_rrtmgp_nn_tpu", "rte_rrtmgp_nn_tpu_torch/gasoptics", "artifacts")


def tree_digest() -> dict:
    """path -> sha1 of every file under GUARDED (compiled caches aside)."""
    out = {}
    for top in GUARDED:
        for d, dirs, names in os.walk(os.path.join(ROOT, top)):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            for n in names:
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, ROOT)] = hashlib.sha1(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("calibrate")
    T.write_rfmip_file(str(d / "rfmip.nc"), NEXP, NSITES, NLAY, seed=0)
    (d / "models").mkdir()
    for name in cli.SW_MODEL_FILES:
        shutil.copy(SW_TEACHER, d / "models" / name)
    sw = load_model_netcdf(SW_TEACHER, device="cpu")
    save_model_netcdf(str(d / "models" / cli.SW_G224_MODEL_FILE),
                      nn_model_from_arrays(*T.sw_g224_net_arrays(sw, 0), device="cpu"))
    write_nc(str(d / "garand.nc"), *T.garand_nc_variables(T.synthesize_garand(NLAY, seed=0)))
    write_nc(str(d / "sw-lut.nc"), *T.cloud_optics_nc_variables(
        T.synthesize_cloud_optics(sw_spectral_g112(), seed=0, flavour="lut")))
    return d


def weights_of(path) -> np.ndarray:
    scope = {}
    exec(open(path).read(), scope)
    return scope["SW_G112_WEIGHTS"]


def residual_lines(out: str) -> list:
    return [float(v) for v in re.findall(r"rms transmission residual ([0-9.]+)", out)]


def test_calibrate_sw_g112_matches_the_jax_script(files, capsys):
    before = tree_digest()
    jout = run_jax("calibrate_sw_g112.py", {"RFMIP": str(files / "rfmip.nc"),
                                            "MODELS": str(files / "models") + os.sep,
                                            "OUT": str(files / "jax_weights.py")}, [], files).stdout
    capsys.readouterr()
    mod = load_script("torch_calibrate_sw_g112")
    assert mod.main(["--rfmip", str(files / "rfmip.nc"), "--models-dir", str(files / "models"),
                     "--out", str(files / "port_weights.py"), "--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    assert tree_digest() == before
    got, ref = weights_of(files / "port_weights.py"), weights_of(files / "jax_weights.py")
    assert got.shape == ref.shape == (112,)
    np.testing.assert_allclose(got, ref, rtol=G112_RTOL, atol=G112_ATOL)
    np.testing.assert_allclose(np.add.reduceat(got, mod.BAND_STARTS), 1.0, rtol=1e-6)
    assert len(residual_lines(pout)) == len(residual_lines(jout)) == 14
    np.testing.assert_allclose(residual_lines(pout), residual_lines(jout), rtol=0,
                               atol=G112_RESID_ATOL)
    assert "GENERATED by scripts/torch_calibrate_sw_g112.py" in open(files / "port_weights.py").read()
    assert pout.splitlines()[-1] == f"wrote {files / 'port_weights.py'}"


def test_calibrate_sw_g112_writes_the_port_s_module_by_default():
    mod = load_script("torch_calibrate_sw_g112")
    assert os.path.normpath(mod.OUT) == os.path.join(
        ROOT, "rte_rrtmgp_nn_tpu_torch", "gasoptics", "sw_g112_weights.py")


def solar_args(files) -> list:
    return ["--garand", str(files / "garand.nc"), "--sw-cloud-coeffs", str(files / "sw-lut.nc"),
            "--models-dir", str(files / "models"), "--device", "cpu"]


def jax_solar_consts(files, targets) -> dict:
    d = {"D": str(files / "models") + os.sep, "GARAND": str(files / "garand.nc"),
         "CSW": str(files / "sw-lut.nc")}
    return d if targets is None else {**d, "TARGET_DN": targets[0], "TARGET_UP": targets[1]}


def responses(out: str) -> np.ndarray:
    return np.array([(float(a), float(b)) for a, b in
                     re.findall(r"band +\d+: dn= *([0-9.]+) +up= *([0-9.]+)", out)])


def fractions(out: str) -> np.ndarray:
    lines = out.splitlines()
    i = lines.index("calibrated fractions (paste into planck.SW_SOLAR_BAND_FRAC_CAL):")
    text = ""
    for ln in lines[i + 1:]:
        text += ln
        if ln.rstrip().endswith("]"):
            break
    return np.array([float(v) for v in text.strip("[] ").split(",")])


def fractions64(mod, files, monkeypatch) -> np.ndarray:
    """The port script's fractions fitted to its band responses in float64
    (the nets and allsky_sw in float64 on the CPU), at its set targets."""
    import functools

    import torch

    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import solar_band_fractions

    spec = sw_spectral_g112()
    models = [load_model_netcdf(str(files / "models" / f), device="cpu", dtype=torch.float64)
              for f in cli.SW_MODEL_FILES]
    monkeypatch.setattr(mod, "allsky_sw", functools.partial(mod.allsky_sw, dtype=torch.float64))
    resp = mod.band_responses(str(files / "garand.nc"), str(files / "sw-lut.nc"), models, spec,
                              "cpu")
    return mod.band_fractions(resp, solar_band_fractions(spec.band_lims_wvn_array,
                                                         calibrated=False))


def test_calibrate_sw_solar_matches_the_jax_script(files, capsys, monkeypatch):
    before = tree_digest()
    mod = load_script("torch_calibrate_sw_solar")
    spec = sw_spectral_g112()
    models = [load_model_netcdf(str(files / "models" / f), device="cpu")
              for f in cli.SW_MODEL_FILES]
    targets = SW_SOLAR_BAND_FRAC_CAL @ mod.band_responses(
        str(files / "garand.nc"), str(files / "sw-lut.nc"), models, spec, "cpu")
    jout = run_jax("calibrate_sw_solar.py", jax_solar_consts(files, list(targets)), [],
                   files).stdout
    mod.TARGET_DN, mod.TARGET_UP = targets
    capsys.readouterr()
    assert mod.main(solar_args(files)) == 0
    pout = capsys.readouterr().out
    assert tree_digest() == before
    rp, rj = responses(pout), responses(jout)
    assert rp.shape == rj.shape == (14, 2) and (rp > 0).all()
    np.testing.assert_allclose(rp, rj, rtol=0, atol=SW_ATOL)
    fp, fj = fractions(pout), fractions(jout)
    assert fp.shape == fj.shape == (14,) and (fp > 0).all()
    beyond = np.abs(fp - fj) > SOLAR_ATOL
    if beyond.any():
        f64 = fractions64(mod, files, monkeypatch)
        assert np.abs(fp - f64).max() <= SOLAR_ATOL, (fp, fj, f64)
        assert np.all(np.abs(fp - f64)[beyond] < np.abs(fj - f64)[beyond]), (fp, fj, f64)
    np.testing.assert_allclose(fp.sum(), 1.0, rtol=1e-7)
    achieved = lambda out: [float(v) for v in re.search(
        r"achieved dn/up: ([0-9.]+) / ([0-9.]+)", out).groups()]
    np.testing.assert_allclose(achieved(pout), targets, rtol=1e-7)
    np.testing.assert_allclose(achieved(jout), targets, rtol=1e-7)


def test_calibrate_sw_solar_refuses_negative_fractions_as_jax_does(files):
    """At the reference's targets (946.975 / 325.291 W/m2) the stand-in
    nets' responses need negative fractions: both scripts raise
    AssertionError and print no fractions."""
    mod = load_script("torch_calibrate_sw_solar")
    assert (mod.TARGET_DN, mod.TARGET_UP) == (946.975098, 325.290985)
    r = run_jax("calibrate_sw_solar.py", jax_solar_consts(files, None), [], files, ok=False)
    assert r.returncode != 0 and "AssertionError" in r.stderr
    assert "calibrated fractions" not in r.stdout
    with pytest.raises(AssertionError):
        mod.main(solar_args(files))
