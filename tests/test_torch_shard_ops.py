"""The port's parallel/shard_ops.py against the JAX package's: the eval
metric core on the same float32 inputs (nexp 3 and 11, every forcing pair
present at 11, both orientations), the core split over a two-device CPU
mesh against the core on one device, and the distributed flux statistics
and the column-local program against the JAX shard_map versions.

Tolerances: the metrics are float32 sums over float32 counts on both
sides. The JAX core takes a forcing bias as a difference of differences of
float32 means of fluxes near 250 W/m2, which cancellation leaves about
3e-5 W/m2 from float64; the port regroups the same sum as a difference of
mean biases (shard_ops._metrics_from_partials), which stays within 1e-6 of
float64. So the port is held to float64 (numpy) at 1e-6, and to the JAX
core at 1e-4 W/m2 absolute (the JAX core's own rounding, also held against
float64 here) and rtol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.parallel import shard_ops as jso
from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh as jmake_mesh, shard_columns as jshard
from rte_rrtmgp_nn_tpu.training import eval_loop as jev
from rte_rrtmgp_nn_tpu_torch.parallel import shard_ops as pso
from rte_rrtmgp_nn_tpu_torch.parallel.sharding import make_mesh
from rte_rrtmgp_nn_tpu_torch.training import eval_loop as pev

MESH2 = make_mesh(devices=["cpu", "cpu"])
ATOL, RTOL = 1e-4, 2e-5


def _metrics64(up, dn, ref_up, ref_dn, plev, top_at_1=True):
    """The 8 metrics in float64 numpy, by the JAX core's formulas."""
    up, dn, ref_up, ref_dn, plev = (np.asarray(a, np.float64) for a in (up, dn, ref_up, ref_dn, plev))
    toa, sfc = (0, -1) if top_at_1 else (-1, 0)
    hr = lambda u, d: 9.80665 / 1004.64 * np.diff(d - u, axis=-1) / np.diff(plev, axis=-1) * 86400.0
    dp = np.abs(np.diff(plev, axis=-1))
    wmae = np.sum(dp / dp.sum(-1, keepdims=True) * np.abs(hr(up, dn) - hr(ref_up, ref_dn)), -1)
    nexp = up.shape[0]
    m = lambda x: x.mean()
    rf_toa = lambda r, e: 0.0 if max(r, e) >= nexp else (
        -(m(ref_up[e, :, toa]) - m(ref_up[r, :, toa])) + (m(up[e, :, toa]) - m(up[r, :, toa])))
    rf_sfc = lambda r, e: 0.0 if max(r, e) >= nexp else (
        (m(ref_dn[r, :, sfc]) - m(ref_dn[e, :, sfc])) - (m(dn[r, :, sfc]) - m(dn[e, :, sfc])))
    return np.array([m(wmae), m(wmae[0]), m(up[..., toa] - ref_up[..., toa]),
                     rf_toa(0, 1), rf_toa(3, 0), rf_sfc(3, 1), rf_sfc(0, 10), rf_sfc(0, 9)])


def _fields(nexp, nsites=16, nlev=13, seed=3, top_at_1=True):
    """(up, dn, ref_up, ref_dn, plev), each (nexp, nsites, nlev) float32,
    with fluxes near the reference ones and the forcings between
    experiments real: each experiment shifts its reference fluxes."""
    r = np.random.default_rng(seed)
    plev = np.linspace(100.0, 100000.0, nlev, dtype=np.float32)
    if not top_at_1:
        plev = plev[::-1]
    plev = np.broadcast_to(plev, (nexp, nsites, nlev)).copy()
    shift = r.uniform(-3, 3, (nexp, 1, 1))
    ref_up = (r.uniform(150, 400, (nexp, nsites, nlev)) + shift).astype(np.float32)
    ref_dn = (r.uniform(50, 350, (nexp, nsites, nlev)) - shift).astype(np.float32)
    up = ref_up + r.normal(0, 0.5, ref_up.shape).astype(np.float32)
    dn = ref_dn + r.normal(0, 0.5, ref_dn.shape).astype(np.float32)
    return up, dn, ref_up, ref_dn, plev


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("nexp", [3, 11])
def test_metric_core_matches_jax(nexp, top_at_1):
    f = _fields(nexp, top_at_1=top_at_1)
    got = pso.rfmip_eval_metrics_core(*map(torch.as_tensor, f), top_at_1=top_at_1)
    ref = np.asarray(jso.rfmip_eval_metrics_core(*map(jnp.asarray, f), top_at_1=top_at_1))
    assert got.dtype == torch.float32 and got.shape == (8,)
    exact = _metrics64(*f, top_at_1=top_at_1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref, exact, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # pairs beyond a smaller experiment axis give exactly 0, as in JAX
    if nexp == 3:
        assert (got[[4, 5, 6, 7]] == 0).all() and (ref[[4, 5, 6, 7]] == 0).all()
    else:
        assert np.count_nonzero(ref) == 8


@pytest.mark.parametrize("nexp", [3, 11])
def test_eval_metrics_matches_jax_on_flat_columns(nexp):
    """eval_metrics takes (nexp * nsites, nlev) arrays, numpy or tensors,
    and returns float64 numpy."""
    up, dn, rup, rdn, plev = (a.reshape(-1, a.shape[-1]) for a in _fields(nexp))
    ref = jev.eval_metrics(up, dn, rup, rdn, plev, nexp)
    got = pev.eval_metrics(torch.as_tensor(up), torch.as_tensor(dn), rup, rdn, plev, nexp)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pev.eval_metrics(up, dn, rup, rdn, plev, nexp), got)


@pytest.mark.parametrize("top_at_1", [True, False])
def test_sharded_metrics_equal_the_core(top_at_1):
    """The sites split over two CPU devices (8 and 8, then 9 and 8): the
    per-device partial sums added on the first device give the core's
    metrics to 1e-6 (W/m2, K/day)."""
    for nsites in (16, 17):
        f = [torch.as_tensor(a) for a in _fields(11, nsites=nsites, top_at_1=top_at_1)]
        single = pso.rfmip_eval_metrics_core(*f, top_at_1=top_at_1)
        sharded = pso.rfmip_eval_metrics_sharded(MESH2, *f, top_at_1=top_at_1)
        np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-6, atol=1e-6)
        # given as the devices' shares already
        shares = [list(torch.split(a, [-(-nsites // 2), nsites // 2], dim=1)) for a in f]
        again = pso.rfmip_eval_metrics_sharded(MESH2, *shares, top_at_1=top_at_1)
        np.testing.assert_array_equal(again.numpy(), sharded.numpy())


def test_flux_stats_and_error_stats_match_jax():
    r = np.random.default_rng(7)
    x = r.normal(100.0, 20.0, (33, 13)).astype(np.float32)
    y = x + r.normal(0.0, 0.5, x.shape).astype(np.float32)
    jmesh = jmake_mesh(n_col=4, n_gpt=2)
    xs, ys = jshard(jnp.asarray(x[:32]), jmesh), jshard(jnp.asarray(y[:32]), jmesh)
    jstats = jax.jit(lambda a: jso.flux_stats(jmesh, a))(xs)
    jerr = jax.jit(lambda a, b: jso.weighted_error_stats(jmesh, a, b))(ys, xs)
    for mesh in (make_mesh(devices=["cpu"]), MESH2):
        got = pso.flux_stats(mesh, torch.as_tensor(x[:32]))
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in jstats], rtol=1e-6)
        err = pso.weighted_error_stats(mesh, torch.as_tensor(y[:32]), torch.as_tensor(x[:32]))
        np.testing.assert_allclose([float(v) for v in err], [float(v) for v in jerr], rtol=1e-5)
    # a ragged split (17 and 16 columns) against numpy
    mean, lo, hi = pso.flux_stats(MESH2, torch.as_tensor(x))
    assert abs(float(mean) - x.mean()) < 1e-3 and float(lo) == x.min() and float(hi) == x.max()
    mae, rmse, mx = pso.weighted_error_stats(MESH2, torch.as_tensor(y), torch.as_tensor(x))
    d = np.abs(y - x)
    assert abs(float(mae) - d.mean()) < 1e-5 and abs(float(rmse) - np.sqrt((d * d).mean())) < 1e-5
    assert float(mx) == d.max()


def test_columnwise_shard_map_matches_jax():
    """A column-local LW solve run on each device's share of the columns
    and joined in order, against the JAX shard_map on 8 devices."""
    from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat as jsolve
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_solver_noscat as psolve

    r = np.random.default_rng(11)
    ncol, nlay, ngpt = 64, 9, 16
    mk = lambda *s: r.uniform(0.1, 1.0, s).astype(np.float32)
    args = (mk(ncol, nlay, ngpt), mk(ncol, nlay, ngpt), mk(ncol, nlay + 1, ngpt),
            mk(ncol, ngpt), mk(ncol, ngpt))
    jmesh = jmake_mesh(n_col=8)

    def jfn(*a):
        out = jsolve(*a, broadband=True)
        return out.flux_up, out.flux_dn

    jup, jdn = jax.jit(jso.columnwise_shard_map(jmesh, jfn, n_array_args=5))(
        *jshard(tuple(map(jnp.asarray, args)), jmesh))

    def pfn(*a):
        out = psolve(*a, broadband=True)
        return {"up": out.flux_up, "dn": out.flux_dn}

    got = pso.columnwise_shard_map(MESH2, pfn, n_array_args=5)(*map(torch.as_tensor, args))
    assert got["up"].shape == (ncol, nlay + 1)
    np.testing.assert_allclose(got["up"].numpy(), np.asarray(jup), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["dn"].numpy(), np.asarray(jdn), rtol=1e-6, atol=1e-6)
    one = pso.columnwise_shard_map(make_mesh(devices=["cpu"]), pfn, 5)(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(one["up"].numpy(), got["up"].numpy())
    with pytest.raises(TypeError, match="5 arrays, expected 4"):
        pso.columnwise_shard_map(MESH2, pfn, 4)(*map(torch.as_tensor, args))
