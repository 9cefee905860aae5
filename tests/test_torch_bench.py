"""The port's benchmark entry points (bench_torch.py,
scripts/torch_bench_allsky.py, scripts/torch_bench_gcm.py) on the CPU,
against the JAX package.

- Each entry's main() runs in this process with ``--device cpu`` at a small
  size (16 columns x 60 layers; the GCM sweep 64 columns in blocks of 32).
  Its JSON carries the JAX script's keys (bench.py:292-306,
  scripts/bench_allsky.py:176-192, scripts/bench_gcm.py:91-120) and the
  port's own, every metric name ends in ``_cpu``, and its output check
  against the port's float64 CPU run passes.
- The printed mean fluxes are held against the JAX package's cores on the
  same numpy inputs and the same demo nets (loaded by JAX's
  load_model_netcdf): ``_lw_core_lay_major`` / ``_sw_core_lay_major``,
  ``_allsky_lw_core_lay_major`` / ``_allsky_sw_core_lay_major``,
  ``gcm_sweep_allsky`` / ``gcm_sweep_lw``; LW within 2e-3, SW within 2e-2
  W/m2.
- Without a CUDA device each entry's default ``--device cuda`` exits with
  status 2 naming ``--device cpu`` and prints no metric.
- The multi-card bench's pass statistics on given numbers (ROADMAP F11).
"""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import allsky as jallsky
from rte_rrtmgp_nn_tpu.drivers import gcm as jgcm
from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.utils import bench
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc
from test_torch_core import LW_MODEL, SW_MODEL, model_pair, rfmip_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the port against the JAX package
NCOL, NLAY, SEED = 16, 60, 0
GCM_NCOL, GCM_BLOCK = 64, 32
SMALL = ["--device", "cpu", "--reps", "1", "--batch", "1"]

# the keys each JAX script prints
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "lw_ms", "sw_ms", "lw_ms_percall",
              "sw_ms_percall", "timing", "ncol", "vs_baseline_lw", "vs_baseline_sw", "backend"}
ALLSKY_KEYS = {"metric", "value", "unit", "ncol", "core", "lw_ms", "sw_ms", "lw_ms_percall",
               "sw_ms_percall", "timing", "lw_mean_dn", "lw_mean_up", "sw_mean_dn",
               "sw_mean_up"}
GCM_KEYS = {"allsky": {"metric", "value", "unit", "ncol", "block", "elapsed_s", "mean_olr",
                       "mean_lw_sfc_dn", "mean_sw_sfc_dn", "precision", "backend"},
            "lw": {"metric", "value", "unit", "ncol", "block", "elapsed_s", "mean_olr",
                   "mean_sfc_dn", "precision", "backend"}}
# the keys the port adds to each
PORT_KEYS = {"device", "inputs", "seed", "max_abs_dflux_lw", "correct", "build_s"}


def load(path):
    name = "bench_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ENTRIES = {"bench_torch": "bench_torch.py",
           "torch_bench_allsky": "scripts/torch_bench_allsky.py",
           "torch_bench_gcm": "scripts/torch_bench_gcm.py"}


def run(name, args, capsys) -> list:
    """main(args) of an entry: its JSON lines; the exit status must be 0."""
    assert load(ENTRIES[name]).main(list(args)) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert lines
    for line in lines:
        assert line["metric"].endswith("_cpu") and line["backend"] == "cpu"
        assert line["device"]["platform"] == "cpu" and line["build_s"] is None
        assert line["correct"] is True, line
    return lines


@pytest.fixture(scope="module")
def models():
    jl, _ = model_pair(LW_MODEL)
    js, _ = model_pair(SW_MODEL)
    return {"lw": [jl], "sw": [js, js]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The all-sky and GCM entries' synthetic inputs, written where the
    JAX package reads them too: the Garand file and the lookup-table cloud
    files the entries make from SEED."""
    d = tmp_path_factory.mktemp("bench")
    paths = {"garand": str(d / "garand.nc"), "lw": str(d / "lw-lut.nc"),
             "sw": str(d / "sw-lut.nc")}
    write_nc(paths["garand"], *T.garand_nc_variables(T.synthesize_garand(NLAY, SEED)))
    for band, spec in (("lw", lw_spectral_g128()), ("sw", sw_spectral_g112())):
        write_nc(paths[band], *T.cloud_optics_nc_variables(
            T.synthesize_cloud_optics(spec, SEED, "lut")))
    return paths


def _means(lw, sw) -> dict:
    return {f"{band}_mean_{d}": float(np.mean(np.asarray(getattr(fb, f"flux_{d}"))))
            for band, fb in (("lw", lw), ("sw", sw)) for d in ("dn", "up")}


def _hold_means(got: dict, want: dict) -> None:
    for k, v in want.items():
        atol = LW_ATOL if k.startswith("lw") or "olr" in k or "lw_sfc" in k else SW_ATOL
        assert abs(got[k] - v) <= atol, (k, got[k], v)


@pytest.fixture(scope="module")
def jax_rfmip_means(models) -> dict:
    """The JAX package's lay-major clear-sky cores on the entry's inputs:
    their mean fluxes."""
    jd, _ = rfmip_pair(T.synthesize_rfmip(NCOL, NLAY, SEED))
    lspec, sspec = jplanck.lw_spectral_g128(), jplanck.sw_spectral_g112()
    f = lambda a: jnp.asarray(a, jnp.float32)
    concs = {k: f(v) for k, v in jd.gas_concs.concs.items()}
    lw = jrfmip._lw_core_lay_major(
        models["lw"], jplanck.PlanckTable.compute(lspec.band_lims_wvn_array, dtype=jnp.float32),
        lspec, f(jd.play), f(jd.plev), f(jd.tlay), f(jd.tlev), f(jd.tsfc),
        f(np.broadcast_to(jd.sfc_emis[:, None], (NCOL, lspec.nband))), concs,
        top_at_1=jd.top_at_1)
    sw = jrfmip._sw_core_lay_major(
        models["sw"], sspec, f(jrfmip.default_solar_source(sspec)), f(jd.play), f(jd.plev),
        f(jd.tlay), f(jd.sfc_alb), f(np.cos(np.deg2rad(jd.sza))), jnp.asarray(jd.sza < 90.0),
        f(jd.tsi), concs, top_at_1=jd.top_at_1)
    return _means(lw, sw)


@pytest.fixture(scope="module")
def jax_allsky_means(models, files) -> dict:
    """The JAX package's lay-major all-sky cores on the entry's files:
    their mean fluxes."""
    atm = jallsky.read_garand(files["garand"], NCOL)
    co_lw = jallsky.load_cloud_optics_checked(files["lw"])
    co_sw = jallsky.load_cloud_optics_checked(files["sw"])
    clouds = [jnp.asarray(a, jnp.float32)
              for a in jallsky.make_clouds(atm.play, atm.tlay, co_lw)]
    lspec, sspec = jplanck.lw_spectral_g128(), jplanck.sw_spectral_g112()
    f = lambda a: jnp.asarray(a, jnp.float32)
    concs = {k: f(v) for k, v in atm.gas_concs.concs.items()}
    lw = jallsky._allsky_lw_core_lay_major(
        models["lw"], jplanck.PlanckTable.compute(lspec.band_lims_wvn_array, dtype=jnp.float32),
        lspec, co_lw, f(atm.play), f(atm.plev), f(atm.tlay), f(atm.tlev), f(atm.tlev[:, -1]),
        f(np.full((NCOL, lspec.nband), 0.98)), *clouds, concs, top_at_1=True)
    alb = f(np.full((NCOL, sspec.nband), 0.06))
    sw = jallsky._allsky_sw_core_lay_major(
        models["sw"], sspec, f(jrfmip.resolve_solar_source(sspec)), co_sw, f(atm.play),
        f(atm.plev), f(atm.tlay), f(np.full(NCOL, 0.86)), alb, alb, *clouds, concs,
        top_at_1=True)
    return _means(lw, sw)


@pytest.mark.parametrize("core", ["auto", "mega", "staged"])
def test_bench_torch_matches_jax(jax_rfmip_means, core, capsys):
    (line,) = run("bench_torch", ["--ncol", str(NCOL), "--core", core, *SMALL], capsys)
    assert BENCH_KEYS | PORT_KEYS | {"max_abs_dflux_sw"} <= set(line)
    assert line["metric"] == "rfmip_clearsky_lw_sw_columns_per_s_per_chip_cpu"
    assert line["core"] == ("staged+staged" if core == "auto" else f"{core}+{core}")
    assert (line["inputs"], line["seed"], line["ncol"]) == ("synthetic", SEED, NCOL)
    # cuda_ms: 3 warm-up calls and 1 sample of 1; host_ms: 1 warm-up, 1 sample; the check's
    assert line["calls"] == {"lw": 3 + 1 + 1 + 1 + 1, "sw": 3 + 1 + 1 + 1 + 1}
    _hold_means(line, jax_rfmip_means)


def test_bench_torch_mult_replicates_the_columns(capsys):
    """--mult N runs N copies of the columns: the mean fluxes of the copies
    are those of one, the check holds the first ones."""
    (one,) = run("bench_torch", ["--ncol", "8", "--core", "mega", *SMALL], capsys)
    (two,) = run("bench_torch", ["--ncol", "8", "--mult", "2", "--core", "mega", *SMALL], capsys)
    assert (one["ncol"], two["ncol"], two["check_ncol"]) == (8, 16, 16)
    for k in ("lw_mean_dn", "lw_mean_up", "sw_mean_dn", "sw_mean_up"):
        assert two[k] == pytest.approx(one[k], rel=1e-6), k


@pytest.mark.parametrize("core", ["auto", "mega"])
def test_torch_bench_allsky_matches_jax(jax_allsky_means, files, core, capsys):
    flags = ["--garand", files["garand"], "--lw-cloud-coeffs", files["lw"],
             "--sw-cloud-coeffs", files["sw"]]
    (line,) = run("torch_bench_allsky", ["--ncol", str(NCOL), "--core", core, *flags, *SMALL],
                  capsys)
    assert ALLSKY_KEYS | PORT_KEYS | {"max_abs_dflux_sw"} <= set(line)
    assert line["metric"] == "allsky_lw_sw_columns_per_s_per_chip_cpu"
    assert line["inputs"] == "files" and line["seed"] is None
    _hold_means(line, jax_allsky_means)


def test_torch_bench_allsky_synthesizes_the_same_files(files, capsys):
    """Without file flags the entry writes the same synthetic files from
    the seed: its means equal those of the files given by flag."""
    (synth,) = run("torch_bench_allsky", ["--ncol", str(NCOL), *SMALL], capsys)
    (given,) = run("torch_bench_allsky", ["--ncol", str(NCOL), "--garand", files["garand"],
                                          "--lw-cloud-coeffs", files["lw"],
                                          "--sw-cloud-coeffs", files["sw"], *SMALL], capsys)
    assert (synth["inputs"], synth["seed"]) == ("synthetic", SEED)
    for k in ("lw_mean_dn", "lw_mean_up", "sw_mean_dn", "sw_mean_up"):
        assert synth[k] == given[k], k


def test_torch_bench_gcm_matches_jax(models, files, capsys):
    args = ["--ncol", str(GCM_NCOL), "--block", str(GCM_BLOCK), "--lw-cloud-coeffs",
            files["lw"], "--sw-cloud-coeffs", files["sw"], "--device", "cpu"]
    sky, lw = run("torch_bench_gcm", args, capsys)
    assert GCM_KEYS["allsky"] | PORT_KEYS | {"max_abs_dflux_sw"} <= set(sky)
    assert GCM_KEYS["lw"] | PORT_KEYS <= set(lw)
    assert sky["metric"] == "gcm_allsky_lw_sw_columns_per_s_per_chip_cpu"
    assert lw["metric"] == "gcm_clearsky_lw_columns_per_s_per_chip_cpu"
    assert sky["blocks"] == lw["blocks"] == 2 and sky["ncol"] == GCM_NCOL
    host, base, _ = load(ENTRIES["torch_bench_gcm"]).gcm_columns(
        load(ENTRIES["torch_bench_gcm"]).parse(args)[1])
    jsky = jgcm.gcm_sweep_allsky(host, models["lw"], models["sw"],
                                 jallsky.load_cloud_optics_checked(files["lw"]),
                                 jallsky.load_cloud_optics_checked(files["sw"]),
                                 block_size=GCM_BLOCK, top_at_1=base.top_at_1)
    jlw = jgcm.gcm_sweep_lw(host, models["lw"], block_size=GCM_BLOCK, top_at_1=base.top_at_1)
    _hold_means(sky, {k: jsky[k] for k in ("mean_olr", "mean_lw_sfc_dn", "mean_sw_sfc_dn")})
    _hold_means(lw, {k: jlw[k] for k in ("mean_olr", "mean_sfc_dn")})


def test_torch_bench_gcm_resident_metric_names(capsys):
    (line,) = run("torch_bench_gcm", ["--ncol", str(GCM_NCOL), "--block", str(GCM_BLOCK),
                                      "--lw-only", "--resident", "--precision", "mixed",
                                      "--device", "cpu"], capsys)
    assert line["metric"] == "gcm_clearsky_lw_columns_per_s_per_chip_resident_cpu"
    assert line["precision"] == "mixed"


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entries_refuse_cuda_without_a_device(name, monkeypatch, capsys):
    """The default --device cuda on a host without CUDA exits with status 2
    and names --device cpu, and no metric is printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        load(ENTRIES[name]).main([])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "--device cpu" in out.err and "metric" not in out.out


def test_multichip_pass_statistics():
    """ROADMAP F11: every pass's per-card rate and its efficiency against
    the first count's median, with the median and quartiles over passes."""
    mc = load("scripts/torch_bench_multichip.py")
    st = mc.pass_stats({1: [100.0, 120.0, 110.0, 90.0, 130.0], 4: [55.0, 110.0, 88.0]})
    assert st[1]["per_chip"]["median"] == 110.0
    assert (st[1]["per_chip"]["q1"], st[1]["per_chip"]["q3"]) == (100.0, 120.0)
    assert st[1]["efficiency"]["passes"] == pytest.approx([10 / 11, 12 / 11, 1.0, 9 / 11,
                                                           13 / 11])
    assert st[4]["efficiency"]["passes"] == pytest.approx([0.5, 1.0, 0.8])
    assert st[4]["efficiency"]["median"] == pytest.approx(0.8)
    assert st[4]["efficiency"]["q1"] == pytest.approx(0.65)
    assert st[4]["efficiency"]["q3"] == pytest.approx(0.9)
    assert st[4]["efficiency"]["n_samples"] == 3


def test_multichip_core_sets_are_disjoint_and_equal(monkeypatch):
    mc = load("scripts/torch_bench_multichip.py")
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(10)))
    sets = mc.core_sets(4)
    assert sets == [[0, 1], [2, 3], [4, 5], [6, 7]]
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3})
    assert mc.core_sets(2) == [[3], [3]]


def test_hold_fluxes_takes_the_f1_law_on_the_staged_route():
    """The output check: LW within 2e-3; an SW column beyond 2e-2 only by
    the F1 law, and only where a resonance distance is given: for a result
    whose two-stream coefficients are float32, such as the JAX package's
    staged route (the port's own routes pass none,
    test_staged_entries_take_no_f1_law)."""
    ref = {"lw": {"flux_up": np.zeros((3, 2))}, "sw": {"flux_dn": np.zeros((3, 2))}}
    card = {"lw": {"flux_up": np.full((3, 2), 1e-3)},
            "sw": {"flux_dn": np.array([[0.0, 0.0], [0.1, 0.0], [0.0, 0.0]])}}
    assert bench.hold_fluxes(card, ref)["correct"] is False
    held = bench.hold_fluxes(card, ref, sw_resonance=np.array([1.0, 0.02, 1.0]))
    assert held == {"max_abs_dflux_lw": 1e-3, "max_abs_dflux_sw": 0.1, "sw_f1_columns": 1,
                    "correct": True}
    assert not bench.hold_fluxes(card, ref, sw_resonance=np.array([1.0, 0.1, 1.0]))["correct"]
    card["lw"]["flux_up"][1, 1] = 3e-3
    assert bench.hold_fluxes(card, ref)["correct"] is False


@pytest.mark.parametrize("name", ["bench_torch", "torch_bench_allsky"])
def test_staged_entries_take_no_f1_law(name, files, monkeypatch, capsys):
    """Every SW route of the port takes float64 two-stream coefficients
    (ops/sw_solver.pifm_coefficients), so the staged route's output check
    holds SW within 2e-2 W/m2 in every column: the entry passes no
    resonance distance and reports sw_f1_columns 0."""
    asked = []
    hold = bench.hold_fluxes

    def spy(*args, **kw):
        asked.append(kw)
        return hold(*args, **kw)

    monkeypatch.setattr(bench, "hold_fluxes", spy)
    flags = ([] if name == "bench_torch" else
             ["--garand", files["garand"], "--lw-cloud-coeffs", files["lw"],
              "--sw-cloud-coeffs", files["sw"]])
    (line,) = run(name, ["--ncol", "64", "--core", "staged", *flags, *SMALL], capsys)
    assert asked == [{}]
    assert line["sw_f1_columns"] == 0 and line["max_abs_dflux_sw"] <= SW_ATOL
