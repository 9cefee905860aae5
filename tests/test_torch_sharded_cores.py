"""The port's sharded fused cores (drivers.rfmip lw_mega_core_sharded /
sw_mega_core_sharded) on two gloo ranks on the CPU, where K1 and K2 are
their plain twins, against the JAX package's sharded cores on a two-device
CPU mesh (the Pallas megakernels in interpret mode) within the JAX
package's own bounds, LW 2e-3 and SW 2e-2 W/m2, and against the port's
unsharded cores bit for bit: each rank's block and the gathered whole.
Also the one-process form over two CPU devices, and _conc_shard_spec
against the JAX PartitionSpecs. 12 columns (6 a device, as the JAX cores
need the count to divide) x 10 layers, both orientations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_workers as W
from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh as jmake_mesh
from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist
from rte_rrtmgp_nn_tpu_torch.parallel.sharding import make_mesh
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL, model_pair, rfmip_pair

NCOL, NLAY = 12, 10
LW_ATOL, SW_ATOL = 2e-3, 2e-2


@pytest.fixture(scope="module", params=[True, False], ids=["top_at_1", "bottom_first"])
def case(request):
    arrays = synthesize_rfmip(NCOL, NLAY, seed=31, top_at_1=request.param)
    ranks = pdist.launch(W.sharded_cores, 2, arrays, LW_MODEL, SW_MODEL, device="cpu")
    return arrays, ranks


def _port_unsharded(pd):
    _, lw = model_pair(LW_MODEL)
    _, sw = model_pair(SW_MODEL)
    spec, sspec = pplanck.lw_spectral_g128(), pplanck.sw_spectral_g112()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32)
    fl = fused.lw_core([lw], table, spec, *rfmip.lw_canonical_inputs(pd, spec, CPU),
                       top_at_1=pd.top_at_1)
    fs = rfmip._sw_core_mega_canon([sw, sw], solar, *rfmip.sw_canonical_inputs(pd, CPU),
                                   top_at_1=pd.top_at_1)
    return {"lw": [fl.flux_up.numpy(), fl.flux_dn.numpy()],
            "sw": [fs.flux_up.numpy(), fs.flux_dn.numpy(), fs.flux_dn_dir.numpy()]}


def _jax_sharded(jd):
    jlw, _ = model_pair(LW_MODEL)
    jsw, _ = model_pair(SW_MODEL)
    spec, sspec = jplanck.lw_spectral_g128(), jplanck.sw_spectral_g112()
    table = jplanck.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32)
    solar = jnp.asarray(jrfmip.default_solar_source(sspec), jnp.float32)
    mesh = jmake_mesh(n_col=2, devices=jax.devices()[:2])
    play_t, plev_t, tlay_t, tlev_t, concs_t = jrfmip.canonicalize_rfmip_inputs(jd)
    concs = {k: jnp.asarray(v, jnp.float32) for k, v in concs_t.items()}
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)
    lw = jax.jit(jrfmip.lw_mega_core_sharded(mesh, [jlw], table, spec, top_at_1=jd.top_at_1,
                                             tile_c=8))
    up, dn = lw(f32(play_t), f32(plev_t), f32(tlay_t), f32(tlev_t), f32(jd.tsfc),
                jnp.broadcast_to(f32(jd.sfc_emis)[:, None], (NCOL, spec.nband)), concs)
    sw = jax.jit(jrfmip.sw_mega_core_sharded(mesh, [jsw, jsw], sspec, solar,
                                             top_at_1=jd.top_at_1))
    mu0 = f32(np.cos(np.deg2rad(jd.sza)))
    usecol = jnp.asarray(jd.sza < 90.0 - 0.5 * np.finfo(np.float32).eps)
    s = sw(f32(play_t), f32(plev_t), f32(tlay_t), f32(jd.sfc_alb), mu0, usecol, f32(jd.tsi),
           concs)
    return {"lw": [np.asarray(up), np.asarray(dn)], "sw": [np.asarray(v) for v in s]}


def test_sharded_cores_match_the_unsharded_core_bit_for_bit(case):
    arrays, ranks = case
    _, pd = rfmip_pair(arrays)
    ref = _port_unsharded(pd)
    for r, out in enumerate(ranks):
        s, n = (0, 6) if r == 0 else (6, 6)
        for k in ("lw", "sw"):
            for got, whole, want in zip(out[k], out[k + "_all"], ref[k]):
                np.testing.assert_array_equal(whole, want)
                np.testing.assert_array_equal(got, want[s:s + n])


def test_sharded_cores_match_the_jax_sharded_cores(case):
    arrays, ranks = case
    jd, _ = rfmip_pair(arrays)
    ref = _jax_sharded(jd)
    for k, atol in (("lw", LW_ATOL), ("sw", SW_ATOL)):
        for got, want in zip(ranks[0][k + "_all"], ref[k]):
            assert got.shape == want.shape == (NCOL, NLAY + 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_one_process_mesh_of_two_devices_runs_a_share_per_device():
    _, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=31))
    ref = _port_unsharded(pd)
    _, lw = model_pair(LW_MODEL)
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    fn = rfmip.lw_mega_core_sharded(make_mesh(devices=["cpu", "cpu"]), [lw], table, spec, True)
    for got, want in zip(fn(*rfmip.lw_canonical_inputs(pd, spec, CPU)), ref["lw"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_conc_shard_spec_matches_jax():
    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=31))
    concs_t = rfmip.canonicalize_rfmip_inputs(pd)[4]
    jspec = jrfmip._conc_shard_spec(jrfmip.canonicalize_rfmip_inputs(jd)[4])
    pspec = rfmip._conc_shard_spec(concs_t)
    assert set(pspec) == set(jspec) and any(v is None for v in pspec.values())
    for k, v in pspec.items():
        assert (v == 1) == (tuple(jspec[k]) == (None, "col")), k


def test_sharded_cores_refuse_what_they_cannot_split():
    """A solar source of other g-points; columns whose ceil shares leave a
    device without any (5 columns on 4: pad them, as the JAX cores need)."""
    _, sw = model_pair(SW_MODEL)
    sspec = pplanck.sw_spectral_g112()
    with pytest.raises(ValueError, match="for 112 g-points"):
        rfmip.sw_mega_core_sharded(make_mesh(devices=["cpu"]), [sw, sw], sspec, torch.ones(56),
                                   True)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32)
    fn = rfmip.sw_mega_core_sharded(make_mesh(devices=["cpu"] * 4), [sw, sw], sspec, solar, True)
    _, pd = rfmip_pair(synthesize_rfmip(5, NLAY, seed=31))
    with pytest.raises(ValueError, match="leave a share of a 4-way 'col' split empty"):
        fn(*rfmip.sw_canonical_inputs(pd, CPU))
