"""PyTorch port against the JAX package: NN gas optics (column dry amount,
input packing with the missing-gas block, LW/SW prediction) and the
layer-major Planck sources. Same numpy inputs on both sides; module
outputs to rtol 1e-5 (float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.drivers.rfmip import canonicalize_rfmip_inputs as j_canon
from rte_rrtmgp_nn_tpu.gas_concs import GasConcs as JGC
from rte_rrtmgp_nn_tpu.gasoptics import nn_gas_optics as jgo
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import canonicalize_rfmip_inputs as p_canon
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs as PGC
from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as pgo
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL, close, model_pair, rfmip_pair

NCOL, NLAY = 11, 9


@pytest.fixture(scope="module")
def canon():
    """Canonical layer-major inputs of one synthesized atmosphere, as numpy
    (both packages' canonicalization must agree exactly)."""
    d = synthesize_rfmip(NCOL, NLAY, seed=7, top_at_1=False)
    jd, pd = rfmip_pair(d)
    jc, pc = j_canon(jd), p_canon(pd)
    for a, b in zip(jc[:4], pc[:4]):
        np.testing.assert_array_equal(a, b)
    assert jc[4].keys() == pc[4].keys()
    for k in jc[4]:
        np.testing.assert_array_equal(jc[4][k], pc[4][k])
    return pc


@pytest.fixture(scope="module")
def tables():
    spec = jplanck.lw_spectral_g128()
    return (jplanck.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32),
            pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU))


def _gases(concs):
    return (JGC({k: jnp.asarray(v, jnp.float32) for k, v in concs.items()}),
            PGC({k: torch.as_tensor(v, dtype=torch.float32) for k, v in concs.items()}))


def test_col_dry(canon):
    play, plev, tlay, tlev, concs = canon
    h2o = concs["h2o"]
    close(pgo.get_col_dry_lay_major(torch.from_numpy(h2o), torch.from_numpy(plev)).numpy(),
          np.asarray(jgo.get_col_dry_lay_major(jnp.asarray(h2o), jnp.asarray(plev))))
    close(pgo.get_col_dry(torch.from_numpy(h2o.T.copy()), torch.from_numpy(plev.T.copy())).numpy(),
          np.asarray(jgo.get_col_dry(jnp.asarray(h2o.T), jnp.asarray(plev.T))))


@pytest.mark.parametrize("scenario", [0, 1])
@pytest.mark.parametrize("path", [LW_MODEL, SW_MODEL], ids=["lw", "sw"])
def test_compute_nn_inputs_split(canon, scenario, path):
    """Lanes, the const block of the missing gases and perm, with zero and
    present-day reference VMRs for the missing gases."""
    play, plev, tlay, tlev, concs = canon
    jm, pm = model_pair(path)
    jg, pg = _gases(concs)
    with jco(nn_scenario_index=scenario):
        jl, jc, jperm = jgo.compute_nn_inputs_split(
            jnp.asarray(play), jnp.asarray(tlay), jg, jm, (), lay_major=True)
        jx = jgo.compute_nn_inputs(jnp.asarray(play), jnp.asarray(tlay), jg, jm)
    with pco(nn_scenario_index=scenario):
        pl, pc, pperm = pgo.compute_nn_inputs_split(
            torch.from_numpy(play), torch.from_numpy(tlay), pg, pm)
        px = pgo.compute_nn_inputs(torch.from_numpy(play), torch.from_numpy(tlay), pg, pm)
    assert list(pperm) == list(jperm)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        close(a.numpy(), b, atol=1e-7)
    assert tuple(pc.shape) == tuple(jc.shape)
    close(pc.numpy(), jc, atol=1e-7)
    close(px.numpy(), jx, atol=1e-7)
    n_missing = len(pm.input_names) - len(pl)
    if path == LW_MODEL:
        assert n_missing == 9 and pc.shape == (NCOL, 9)
    else:
        assert n_missing == 0 and pc.shape == (NCOL, 1)
    w1a, w1c = pgo.split_first_layer(pm, pperm, len(pl))
    w1 = np.asarray(jm.weights[0])
    np.testing.assert_array_equal(w1a.numpy(), w1[np.asarray(jperm[:len(pl)])])
    if n_missing:
        np.testing.assert_array_equal(w1c.numpy(), w1[np.asarray(jperm[len(pl):])])
    else:
        np.testing.assert_array_equal(w1c.numpy(), 0.0)


def test_predict_nn_lw_and_sw(canon):
    play, plev, tlay, tlev, concs = canon
    jg, pg = _gases(concs)
    col_dry = pgo.get_col_dry_lay_major(torch.from_numpy(concs["h2o"]), torch.from_numpy(plev))
    cd = jnp.asarray(col_dry.numpy())
    jm, pm = model_pair(LW_MODEL)
    jx = jgo.compute_nn_inputs(jnp.asarray(play), jnp.asarray(tlay), jg, jm)
    x = torch.tensor(np.asarray(jx))
    jt, jp = jgo.predict_nn_lw([jm], jx, cd, use_pallas=False)
    pt, pp = pgo.predict_nn_lw([pm], x, col_dry)
    # tau is y**8: 8x the relative error of y; below 1e-12 it underflows
    # differently and is physically zero
    close(pt.numpy(), jt, rtol=1e-4, atol=1e-12)
    close(pp.numpy(), jp, atol=1e-7)
    js, ps = model_pair(SW_MODEL)
    jx = jgo.compute_nn_inputs(jnp.asarray(play), jnp.asarray(tlay), jg, js)
    x = torch.tensor(np.asarray(jx))
    jt, jssa = jgo.predict_nn_sw([js, js], jx, cd, use_pallas=False)
    pt, pssa = pgo.predict_nn_sw([ps, ps], x, col_dry)
    close(pt.numpy(), jt, rtol=1e-4, atol=1e-12)
    # ssa where tau is not an underflow residue; the same net twice gives 1/2
    big = np.asarray(jt) > 1e-12
    close(pssa.numpy()[big], np.asarray(jssa)[big])
    np.testing.assert_array_equal(pssa.numpy()[pt.numpy() > 0], 0.5)


@pytest.mark.parametrize("top_at_1", [True, False])
def test_compute_planck_source_nn(canon, tables, rng, top_at_1):
    play, plev, tlay, tlev, concs = canon
    spec_j, spec_p = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt, pt = tables
    pfrac = rng.uniform(0, 0.2, (NLAY, NCOL, spec_p.ngpt)).astype(np.float32)
    tsfc = rng.uniform(250, 310, NCOL).astype(np.float32)
    ref = jplanck.compute_planck_source_nn(
        jnp.asarray(pfrac), jnp.asarray(tlay), jnp.asarray(tlev), jnp.asarray(tsfc),
        spec_j, jt, top_at_1=top_at_1, lay_axis=0)
    got = pplanck.compute_planck_source_nn(
        torch.from_numpy(pfrac), torch.from_numpy(tlay), torch.from_numpy(tlev),
        torch.from_numpy(tsfc), spec_p, pt, top_at_1=top_at_1)
    for g, r in zip(got, ref):
        close(g.numpy(), r, atol=1e-6)
