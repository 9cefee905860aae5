"""The port's training diagnostics (training/diagnostics.py) against the
JAX package's, the spans and trace of utils/timing.py, and the pieces of
the LUT training recipe (training/lut_recipe.py, testing's RFMIP
experiments) against scripts/train_from_lut.py's.

heating_rate_stats and the heating rates the figures plot agree with the
JAX package's exactly (float64, the same numpy statistics; the heating
rate's sign is the package's, ROADMAP Queue 3 F4). The figure functions
run (matplotlib is here; the module imports without it).
"""
import os

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from rte_rrtmgp_nn_tpu.extensions.heating_rates import compute_heating_rate_kday  # noqa: E402
from rte_rrtmgp_nn_tpu.training import diagnostics as jdiag  # noqa: E402
from rte_rrtmgp_nn_tpu_torch import testing  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.gas_concs import get_ref_vmr  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.training import diagnostics as pdiag  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.training import lut_recipe as R  # noqa: E402
from rte_rrtmgp_nn_tpu_torch.utils import timing  # noqa: E402


@pytest.fixture
def flux_profiles(rng):
    n, nlev = 40, 61
    plev = np.linspace(100.0, 1e5, nlev)[None, :] * np.ones((n, 1))
    up = 200.0 + np.cumsum(rng.uniform(0, 2, (n, nlev)), axis=1)
    dn = 50.0 + np.cumsum(rng.uniform(0, 4, (n, nlev)), axis=1)
    return up, dn, up + rng.normal(0, 0.5, up.shape), dn + rng.normal(0, 0.5, dn.shape), plev


def test_heating_rate_stats_equal_jax(rng, flux_profiles):
    t = rng.normal(1.0, 0.5, (100, 60))
    p = t + rng.normal(0, 0.1, t.shape)
    got, ref = pdiag.heating_rate_stats(t, p), jdiag.heating_rate_stats(t, p)
    assert got == ref and len(got["text"]) == 4
    up, dn, _, _, plev = flux_profiles
    np.testing.assert_array_equal(pdiag._hr_kday(up, dn, plev),
                                  np.asarray(compute_heating_rate_kday(up, dn, plev)))


def test_figures_run(flux_profiles, rng, tmp_path):
    up, dn, up_p, dn_p, plev = flux_profiles
    hr_t, hr_p = pdiag._hr_kday(up, dn, plev), pdiag._hr_kday(up_p, dn_p, plev)
    fig = pdiag.plot_heating_rate_error(hr_t, hr_p, plev)
    assert len(fig.axes) == 1 and fig.axes[0].get_ylim()[0] > fig.axes[0].get_ylim()[1]
    fig = pdiag.plot_flux_and_hr_error(up, dn, up_p, dn_p, plev)
    assert len(fig.axes) == 3 and all(len(a.lines) == 1 for a in fig.axes)
    tau = rng.lognormal(-2, 2, (500, 16))
    tau_p = tau * np.exp(rng.normal(0, 0.05, tau.shape))
    assert pdiag.plot_hist2d_tau(tau, tau_p, nbins=30).axes[0].get_xlabel() == "Optical depth"
    assert pdiag.plot_hist2d_transmittance(tau, tau_p, nbins=30).axes[0].get_xlabel() == \
        "Transmittance"
    rt = rng.uniform(0, 1, (500, 4))
    fig = pdiag.plot_hist2d_reftrans(rt, np.clip(rt + rng.normal(0, 0.02, rt.shape), 0, 1), 20)
    assert [a.get_xlabel() for a in fig.axes if a.get_xlabel()][:4] == ["Rdif", "Tdif", "Rdir",
                                                                        "Tdir"]
    paths = pdiag.save_eval_figures(tmp_path, up, dn, up_p, dn_p, plev, prefix="demo")
    assert len(paths) == 2 and all(os.path.getsize(p) > 1000 for p in paths)


def test_region_timers_trace_and_throughput(tmp_path):
    """utils/timing: an operator's trace (start_trace / stop_trace) holds
    the spans run while it records; spans record nothing around it."""
    timing.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already"):
        timing.start_trace(str(tmp_path))
    for _ in range(3):
        with timing.span("rte.probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    timing.stop_trace()
    assert not torch.autograd._profiler_enabled()
    with timing.span("rte.after"):
        torch.ones(8).sum()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        text = f.read()
    assert text.count('"rte.probe"') >= 3 and "rte.after" not in text
    with pytest.raises(RuntimeError, match="no trace"):
        timing.stop_trace()


def _jax_script_rows(rng, nexp, nsites, nlay, npairs):
    """scripts/train_from_lut.py's data_iter rows, verbatim."""
    EVAL_PAIRS = np.array([(0, 1), (3, 0), (3, 1), (0, 10), (0, 9)])
    site = rng.integers(0, nsites, npairs)
    lay = rng.integers(0, nlay, npairs)
    n_eval = npairs // 2
    ab = EVAL_PAIRS[rng.choice(len(EVAL_PAIRS), n_eval, p=[0.15, 0.15, 0.2, 0.25, 0.25])]
    ra = rng.integers(0, nexp, npairs - n_eval)
    rb = (ra + rng.integers(1, nexp, npairs - n_eval)) % nexp
    ea = np.concatenate([ab[:, 0], ra])
    eb = np.concatenate([ab[:, 1], rb])
    return np.concatenate([(ea * nsites + site) * nlay + lay, (eb * nsites + site) * nlay + lay])


def test_pair_rows_are_the_jax_scripts_and_stay_inside_small_problems():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        np.testing.assert_array_equal(R.sample_pair_rows(a, 18, 100, 60, 1024),
                                      _jax_script_rows(b, 18, 100, 60, 1024))
    rows = R.sample_pair_rows(np.random.default_rng(0), 3, 8, 16, 64)
    assert rows.shape == (128,) and rows.max() < 3 * 8 * 16
    exp_a, exp_b = rows[:64] // (8 * 16), rows[64:] // (8 * 16)
    assert (exp_a != exp_b).all() and ((exp_a[:32] == 0) & (exp_b[:32] == 1)).all()
    np.testing.assert_array_equal(R.pair_index(3, "cpu").numpy(), [[0, 3], [1, 4], [2, 5]])


def test_rfmip_experiments_share_the_sites_and_set_the_scenarios():
    d = testing.synthesize_rfmip_experiments(18, 5, 7, seed=2)
    data = rfmip_data_from_arrays(d)
    assert (data.nexp, data.nsites, data.ncol) == (18, 5, 90)
    site = testing.synthesize_rfmip(5, 7, seed=2)
    for k in ("play", "tlay", "tsfc", "sza"):
        np.testing.assert_array_equal(d[k][5 * 17:], site[k])
    np.testing.assert_array_equal(d["gases"]["h2o"][5:10], site["gases"]["h2o"])
    vmr = lambda g, e: float(d["gases"][g][5 * e, 0])
    ref = lambda i, g: np.float32(get_ref_vmr(i, g))
    assert [vmr("co2", e) for e in (0, 1, 3)] == [ref(1, "co2"), ref(2, "co2"), ref(3, "co2")]
    assert vmr("ch4", 9) == ref(2, "ch4") and vmr("n2o", 9) == ref(1, "n2o")
    assert vmr("n2o", 10) == ref(2, "n2o") and vmr("ch4", 10) == ref(1, "ch4")
    assert vmr("co2", 2) == np.float32(4 * get_ref_vmr(2, "co2"))
    with pytest.raises(ValueError):
        testing.synthesize_rfmip_experiments(19, 5, 7, seed=2)
