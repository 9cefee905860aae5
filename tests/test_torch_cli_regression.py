"""scripts/torch_run_regression.py against scripts/run_regression.py, and
the K7 route of ops/lw_solver.lw_solver_noscat_lay_major on the card.

The JAX script runs as a subprocess with JAX_PLATFORMS=cpu (64-bit mode
off, as a user runs it: its float64 atmosphere is truncated to float32);
the port's script runs in this process with ``--device cpu`` at the same
defaults (8 columns x 20 layers, the synthetic 16 x 4 / 14 x 4
k-distributions). Every field by name within LW 2e-3 / SW 2e-2 W/m2 (the
bounds tests/test_torch_regression.py holds the harness to), the same
checks, each passing, and the same exit status. Beyond 2e-2 a SW column is
decided by float64 under the rule of ROADMAP Queue 3 F1: at mu0 = 0.7 a
g-point of every column lies within 4e-3 of the two-stream resonance
k*mu0 = 1, where float32 two-stream coefficients lose accuracy as
1/|k*mu0 - 1|. The port's coefficients are float64
(ops/sw_solver.pifm_coefficients), so its every column is within 2e-2 of
the float64 harness; the JAX script's are float32, so its column's
distance from the float64 harness times its |k*mu0 - 1| must stay below
testing.SW_F1_LAW (one column, 8.8e-5 from the resonance, was 0.034 W/m2
from the port's float32 coefficients here). The harness's broadband LW
solves reach the transport kernel's wrapper once each (on CUDA one launch
of K7 each).

This file imports neither JAX nor the JAX package: on a GPU host without
JAX its card test runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cli_regression.py
"""
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.config import config
from rte_rrtmgp_nn_tpu_torch.drivers.clear_sky_regression import run_sw_variants
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.gasoptics.lut_gas_optics import gas_optics_sw_lut
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
from rte_rrtmgp_nn_tpu_torch.utils import ncio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the port's bounds against the JAX package
# the harness's LW solves but the Jacobian's: default, no-tlev, 3 angles,
# optimal angles, tsfc + 1, subset, vertical reverse, and the two increments
# by zero (each leaves absorption optical depths)
BROADBAND_LW_SOLVES = 9


def port_script():
    spec = importlib.util.spec_from_file_location(
        "cli_torch_run_regression", os.path.join(SCRIPTS, "torch_run_regression.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checks_of(out: str) -> dict:
    """The verification table: check name -> (max rel diff, status)."""
    return {m[0]: (float(m[1]), m[2]) for m in re.findall(
        r"^  (\w+)\s+max rel diff\s+(\S+)\s+\(tol \S+\)\s+(ok|FAIL)$", out, re.M)}


def read_all(path) -> dict:
    with ncio.NCFile(str(path)) as f:
        return {n: f.read(n, np.float64) for n in f.variables()}


def sw_float64(directory, ncol=8, nlay=20, mu0=0.7, alb=0.12):
    """The SW variants of the scripts' defaults in float64 on the CPU, and
    per column the smallest |k*mu0 - 1| over layers and g-points (k the
    PIFM eigenvalue of the LUT optical properties, g = 0)."""
    path = os.path.join(directory, "sw64.nc")
    generate_kdist_nc(path, kind="sw", gpts_per_band=4, nband=14)
    kd = load_kdist(path, list(T.REGRESSION_GASES), torch.float64, device="cpu")
    play, plev, tlay, _, _, vmr = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                   for a in T.make_atmosphere(ncol, nlay))
    gc = GasConcs.create({g: np.asarray(v, np.float64) for g, v in vmr.items()})
    f64 = run_sw_variants(kd, play, plev, tlay, gc, torch.full((ncol,), mu0, dtype=torch.float64),
                          torch.full((ncol, kd.nband), alb, dtype=torch.float64), device="cpu")
    props, _ = gas_optics_sw_lut(kd, play, plev, tlay, gc)
    g1, g2 = (8.0 - 5.0 * props.ssa) * 0.25, 0.75 * props.ssa
    k = torch.sqrt(torch.clamp_min((g1 - g2) * (g1 + g2), config.k_min))
    return f64, (k * mu0 - 1.0).abs().amin((1, 2)).numpy()


def test_run_regression_matches_the_jax_script(tmp_path, capsys):
    r = subprocess.run([sys.executable, os.path.join(SCRIPTS, "run_regression.py"),
                        "--output", "jax.nc"], cwd=tmp_path,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                       text=True, timeout=600)
    capsys.readouterr()
    rc = port_script().main(["--output", str(tmp_path / "port.nc"), "--device", "cpu"])
    pout = capsys.readouterr().out
    assert rc == r.returncode == 0, r.stderr[-3000:]
    jchecks, pchecks = checks_of(r.stdout), checks_of(pout)
    assert sorted(pchecks) == sorted(jchecks) and len(pchecks) == 8
    assert all(status == "ok" for _, status in pchecks.values()), pchecks
    assert "all verification checks passed" in pout
    jf, pf = read_all(tmp_path / "jax.nc"), read_all(tmp_path / "port.nc")
    assert sorted(pf) == sorted(jf)
    f64, dist = sw_float64(str(tmp_path))
    for name in pf:
        assert pf[name].shape == jf[name].shape, name
        if name.startswith("lw"):
            np.testing.assert_allclose(pf[name], jf[name], rtol=0, atol=LW_ATOL, err_msg=name)
            continue
        col_err = np.abs(pf[name] - jf[name]).max(1)
        beyond = col_err > SW_ATOL
        port_f64 = np.abs(pf[name] - f64[name]).max(1)
        jax_f64 = np.abs(jf[name] - f64[name]).max(1)
        assert port_f64.max() <= SW_ATOL, (name, port_f64)
        assert (jax_f64 * dist)[beyond].max(initial=0.0) <= T.SW_F1_LAW, (name, col_err, dist)


def test_regression_broadband_solves_reach_the_transport_kernel(tmp_path, monkeypatch, capsys):
    """Each broadband LW solve of the harness is one call of K7's wrapper
    (on CUDA one launch); the Jacobian's solve is not."""
    calls = []
    wrapper = k7.lw_noscat_broadband_angles

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(k7, "lw_noscat_broadband_angles", counted)
    assert port_script().main(["--ncol", "4", "--nlay", "6", "--output",
                               str(tmp_path / "f.nc"), "--device", "cpu"]) == 0
    assert len(calls) == BROADBAND_LW_SOLVES, calls
    assert calls.count((2, 6, 64)) == 1  # the column subset
    assert "all verification checks passed" in capsys.readouterr().out


def test_run_regression_returns_1_on_a_failed_check(tmp_path, capsys):
    """A check above its tolerance (every check, at a negative --fail-tol)
    makes the script print the failures and return 1, where the JAX script
    exits 1 on verify_variants' AssertionError."""
    rc = port_script().main(["--ncol", "4", "--nlay", "6", "--fail-tol", "-1", "--output",
                             str(tmp_path / "f.nc"), "--device", "cpu"])
    assert rc == 1
    assert "FAILED checks: regression checks failed" in capsys.readouterr().out


@pytest.mark.cuda
def test_lay_major_k7_route_against_its_plain_path():
    """On the card lw_solver_noscat_lay_major is one launch of K7's angles
    mode on the layer-major fields (transposed views, no copy), with a
    per-(column, g-point) secant and an incident flux; it agrees with its
    PyTorch path on the same CUDA tensors within LW 2e-3 W/m2, and beyond
    it float64 decides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(7)
    nlay, ncol, ngpt = 60, 256, 128
    u = lambda lo, hi, *shape: (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(dev)
    tau = torch.exp(u(np.log(1e-6), np.log(20.0), nlay, ncol, ngpt))
    args = (tau, u(0.5, 4.0, nlay, ncol, ngpt), u(0.5, 4.0, nlay + 1, ncol, ngpt),
            u(0.9, 1.0, ncol, ngpt), u(2.0, 5.0, ncol, ngpt))
    kw = {"inc_flux": u(0.0, 3.0, ncol, ngpt), "lw_ds": u(1.5, 2.0, ncol, ngpt)}
    n0 = k7.MODE_LAUNCHES["angles"]
    got = plw.lw_solver_noscat_lay_major(*args, **kw)
    torch.cuda.synchronize()
    assert k7.MODE_LAUNCHES["angles"] == n0 + 1
    plain = plw.lw_solver_noscat_lay_major_plain(*args, **kw)
    ref64 = plw.lw_solver_noscat_lay_major_plain(*(a.double() for a in args),
                                                 **{k: v.double() for k, v in kw.items()})
    for n in ("flux_up", "flux_dn"):
        k, p, r = (getattr(s, n).double() for s in (got, plain, ref64))
        err = float((k - p).abs().max())
        assert err <= LW_ATOL or float((k - r).abs().max()) <= float((p - r).abs().max()), n
