"""The port's LW front-end kernel (K6, ``ops/cuda/lw_prep.py``) against the
JAX package's ``lw_prep_pallas`` run in interpret mode on the same inputs,
and the prep LW core (``drivers/rfmip._lw_core_prep``) against the JAX core
in both vertical orientations.

Tolerances: the transmittance to rtol 2e-5 (the MLP kernel's bound: the two
frameworks order the matrix products' sums differently, and (...)**8
amplifies that eightfold) plus 1e-7 absolute, less than an ulp of a
transmittance near 1, for the opaque cells: exp(-tl) carries tl's relative
error times tl, so a transmittance of 1e-11 is only good to 5e-4 of itself;
the sources, which are differences of nearly
equal Planck terms, to 2e-5 times the largest g-point Planck source of the
case (an absolute bound scaled by what is subtracted); the core's fluxes to
2e-3 W/m2. The column count is not a multiple of the Pallas tile.

The CUDA kernel itself is tested on the card by test_torch_cuda_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.ops.pallas.lw_megakernel import lw_prep_pallas
from rte_rrtmgp_nn_tpu_torch.drivers import fused
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
from rte_rrtmgp_nn_tpu_torch.testing import model_arrays, synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, model_pair, random_arrays, rfmip_pair

NCOL, NLAY = 13, 8
TRANS_RTOL, TRANS_ATOL, SRC_RTOL_OF_PLANCK, LW_ATOL = 2e-5, 1e-7, 2e-5, 2e-3


def _prep_args(model, device, ncol=NCOL, nlay=NLAY, seed=31):
    """lw_prep's arguments from a synthesized atmosphere, canonical
    layer-major, on ``device``."""
    _, data = rfmip_pair(synthesize_rfmip(ncol, nlay, seed))
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=device)
    play_t, plev_t, tlay_t, tlev_t, tsfc, _, concs_t = prfmip.lw_canonical_inputs(
        data, spec, device)
    gases = GasConcs(concs_t)
    col_dry = go.get_col_dry_lay_major(gases.get_vmr("h2o", nlay, ncol), plev_t)
    x = go.compute_nn_inputs(play_t, tlay_t, gases, model)
    return (model, x, col_dry, table.interpolate(tlay_t), table.interpolate(tlev_t),
            table.interpolate(tsfc), spec.gpt2band_tensor(device))


def test_twin_matches_jax_kernel():
    jm, pm = model_pair(LW_MODEL)
    args = _prep_args(pm, CPU)
    _, x, col_dry, b_lay, b_lev, b_sfc, g2b = args
    spec = jplanck.lw_spectral_g128()
    one_hot = jnp.asarray(spec.gpt2band[None, :] == np.arange(spec.nband)[:, None], jnp.float32)
    j = lambda t: jnp.asarray(t.numpy())
    ref = lw_prep_pallas(jm, j(x), j(col_dry), j(b_lay), j(b_lev), j(b_sfc), one_hot,
                         tile_c=8, interpret=True)
    got = k6.lw_prep_plain(*args)
    assert NCOL % 8 != 0  # a ragged last tile on the JAX side
    for g in got[:3]:
        assert tuple(g.shape) == (NLAY, NCOL, spec.ngpt)
    assert tuple(got[3].shape) == (NCOL, spec.ngpt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=TRANS_RTOL,
                               atol=TRANS_ATOL)
    # the largest g-point Planck source: fraction times band Planck value
    from rte_rrtmgp_nn_tpu_torch.ops.cuda.mlp import fused_predict_lw_both_plain

    _, pf = fused_predict_lw_both_plain(pm, x, col_dry)
    idx = g2b.long()
    planck_max = max(float((pf * b_lay[..., idx]).max()), float((pf * b_lev[:-1][..., idx]).max()),
                     float(got[3].max()))
    atol = SRC_RTOL_OF_PLANCK * planck_max
    for name, g, r in zip(("src_dn", "src_up", "sfc_src"), got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0.0, atol=atol, err_msg=name)
    assert float(got[1].abs().max()) > 100 * atol  # the bound is far below the sources


def test_level_below_takes_the_next_layers_fraction():
    """src_dn of layer l is built on pfrac[l+1] * B_lev[l+1] (the level-top
    source of the layer below), the bottom layer on its own fraction: a
    change of the Planck value at level l+1 moves src_dn[l] and src_up[l+1]
    and nothing else."""
    _, pm = model_pair(LW_MODEL)
    args = list(_prep_args(pm, CPU, ncol=3, nlay=5))
    base = k6.lw_prep_plain(*args)
    args[4] = args[4].clone()
    args[4][3] *= 1.5
    moved = k6.lw_prep_plain(*args)
    dn = (moved[1] - base[1]).abs().amax((1, 2)) > 0
    up = (moved[2] - base[2]).abs().amax((1, 2)) > 0
    assert dn.tolist() == [False, False, True, False, False]
    assert up.tolist() == [False, False, False, True, False]
    assert torch.equal(moved[0], base[0]) and torch.equal(moved[3], base[3])


@pytest.mark.parametrize("top_at_1", [True, False])
def test_prep_core_matches_jax_core(top_at_1):
    d = synthesize_rfmip(NCOL, NLAY, seed=32, top_at_1=top_at_1)
    jd, pd = rfmip_pair(d)
    jm, pm = model_pair(LW_MODEL)
    jspec, pspec = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(jspec.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(pspec.band_lims_wvn_array, device=CPU)
    j = lambda a: jnp.asarray(a, jnp.float32)
    emis = np.broadcast_to(np.asarray(d["sfc_emis"], np.float32)[:, None], (NCOL, jspec.nband))
    ref = jrfmip._lw_core_prep(
        [jm], jt, jspec, j(jd.play), j(jd.plev), j(jd.tlay), j(jd.tlev), j(jd.tsfc), j(emis),
        {k: j(v) for k, v in jd.gas_concs.concs.items()}, top_at_1=top_at_1, tile_c=8)
    got = prfmip._lw_core_prep([pm], pt, pspec, *prfmip.lw_staged_inputs(pd, pspec, CPU),
                               top_at_1=top_at_1)
    assert tuple(got.flux_up.shape) == (NCOL, NLAY + 1)
    for n in ("flux_up", "flux_dn", "flux_net"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=LW_ATOL, err_msg=n)
    # the prep core and the fused-kernel core solve the same problem
    mega = fused.lw_core([pm], pt, pspec, *prfmip.lw_canonical_inputs(pd, pspec, CPU),
                         top_at_1=top_at_1)
    np.testing.assert_allclose(got.flux_dn.numpy(), mega.flux_dn.numpy(), atol=LW_ATOL)
    np.testing.assert_allclose(got.flux_up.numpy(), mega.flux_up.numpy(), atol=LW_ATOL)


def test_wrapper_runs_the_twin_on_cpu():
    """CPU tensors take the plain twin (bit-identical) and launch nothing."""
    _, pm = model_pair(LW_MODEL)
    args = _prep_args(pm, CPU, ncol=4, nlay=3)
    before = k6.LAUNCHES
    for a, b in zip(k6.lw_prep(*args), k6.lw_prep_plain(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert k6.LAUNCHES == before


def test_prep_core_off_the_cpu_launches_the_kernel_never_the_twin(monkeypatch):
    """Off the CPU the prep core reaches the kernel's launch once, then the
    transport kernel's fields mode once (K7), and no plain twin. Meta
    tensors stand in for the card: the launches are recorded instead of
    run, and the twins raise."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    meta = torch.device("meta")
    launched = []

    def launch(model, x, col_dry, b_lay, b_lev, b_sfc, g2b, d_secant):
        launched.append((tuple(x.shape), tuple(b_lev.shape), d_secant))
        nlay, ncol, _ = x.shape
        field = torch.empty((nlay, ncol, g2b.shape[0]), device=x.device)
        return field, field, field, field[0]

    def k7_fields(trans, src_dn, src_up, sfc_emis, sfc_source):
        launched.append(("k7 fields", tuple(trans.shape), tuple(sfc_emis.shape)))
        return [torch.empty((trans.shape[1], trans.shape[0] + 1), device=trans.device)] * 2

    def twin(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran off the CPU")

    monkeypatch.setattr(k6, "_launch", launch)
    monkeypatch.setattr(k7, "_launch_fields", k7_fields)
    monkeypatch.setattr(k7, "lw_broadband_sweeps", twin)
    monkeypatch.setattr(k6, "lw_prep_plain", twin)
    monkeypatch.setattr(mlp, "fused_predict_lw_both_plain", twin)
    _, pm = model_pair(LW_MODEL)
    net = nn_model_from_arrays(*model_arrays(pm), device=meta)
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=meta)
    _, pd = rfmip_pair(synthesize_rfmip(6, 5, seed=33))
    got = prfmip._lw_core_prep([net], table, spec, *prfmip.lw_staged_inputs(pd, spec, meta),
                               top_at_1=True)
    assert got.flux_dn.device == meta and tuple(got.flux_dn.shape) == (6, 6)
    assert launched == [((5, 6, 18), (6, 6, 16), 1.66), ("k7 fields", (5, 6, 128), (6, 128))]


def test_launch_refuses_what_the_kernel_does_not_take():
    """_launch raises before it touches the library: a tensor on neither
    the CPU nor CUDA, and (checked first on CUDA, here through the shared
    model test) a net that is not 3-layer softsign."""
    from rte_rrtmgp_nn_tpu_torch.config import megakernel_model_ok

    _, pm = model_pair(LW_MODEL)
    args = list(_prep_args(pm, CPU, ncol=3, nlay=4))
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k6.lw_prep(*args)
    relu = nn_model_from_arrays(*random_arrays((18, 8, 8, 256), ("relu", "relu", "linear"), 0),
                                device=CPU)
    assert megakernel_model_ok([pm]) and not megakernel_model_ok([relu])


def test_launch_refuses_a_non_softsign_net_off_the_cpu(monkeypatch):
    """With a device that passes for CUDA the wrapper refuses a ReLU net
    with the reason, before any tensor check or library call."""
    relu = nn_model_from_arrays(*random_arrays((18, 8, 8, 256), ("relu", "relu", "linear"), 0),
                                device=CPU)

    class FakeCuda:
        type = "cuda"

    class X:
        device = FakeCuda()

    with pytest.raises(NotImplementedError, match="3-layer softsign"):
        k6._launch(relu, X(), None, None, None, None, None, 1.66)


# -- the kernel's launch plan and the launch ------------------------------------------

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90


@pytest.mark.parametrize("nlay", [1, 13, 60, 61])
def test_plan_covers_every_layer_once_and_fits(nlay):
    """The layer groups of lw_prep_plan are contiguous and cover every layer
    once; the geometry is whole groups of 128 threads and 16 layers per MLP
    pass; the shared memory is the sum of the kernel's regions (per group
    the k-major MLP scratch, 20 floats per k; the weights' two slabs of
    whole rows of the widest layer; col_dry; the two nlay x ngpt fields)
    and fits sm_90."""
    ngpt = 128
    plan = k6.lw_prep_plan(nlay, 18, 128, 128, ngpt)
    covered = []
    for grp in range(plan.groups):
        lbeg = min(grp * plan.layers_per_group, nlay)
        covered += range(lbeg, min(lbeg + plan.layers_per_group, nlay))
    assert covered == list(range(nlay))
    assert plan.groups in (1, 2, 4) and plan.groups <= nlay
    assert plan.threads == 128 * plan.groups and plan.rows_per_pass == 16
    assert plan.slab_floats % 4 == 0 and plan.slab_floats >= 4 * 2 * ngpt
    floats = (plan.groups * 20 * (18 + 128 + 128) + 2 * plan.slab_floats + ((nlay + 3) & ~3)
              + 2 * nlay * ngpt)
    assert plan.smem_bytes == 4 * floats <= SMEM_LIMIT


@pytest.mark.parametrize("case,match", [
    (dict(nlay=400, ngpt=128), "too many layers"),
    (dict(nlay=60, ngpt=129), "ngpt 129 > 128"),
    (dict(nlay=60, ngpt=128, wide=2048), "net is too wide"),
    (dict(nlay=0, ngpt=128), "must be positive"),
])
def test_plan_refuses_in_words(case, match):
    """The fields of too many layers, more g-points than a group has
    threads, a net whose scratch does not fit beside the fields, no layer:
    refused with the reason."""
    wide = case.get("wide", 128)
    with pytest.raises(ValueError, match=match):
        k6.lw_prep_plan(case["nlay"], 18, wide, wide, case["ngpt"])


def test_wrapper_off_the_cpu_reaches_the_launch_with_the_plan(monkeypatch):
    """Off the CPU lw_prep hands the launch entry its arguments, the net and
    lw_prep_plan's geometry, and counts the launch; meta tensors stand in
    for the card and a recording library for the kernel, and the twin
    raises."""
    import types

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    seen = []

    def launch(args, net, plan, device, stream):
        a, p = args._obj, plan._obj
        seen.append(((a.ncol, a.nlay, a.nf, a.ngpt, a.nband), (net._obj.h1, net._obj.nout),
                     tuple(getattr(p, f) for f, _ in build.MegaPlan._fields_)))
        return 0

    def twin(*a, **k):
        raise AssertionError("the plain twin ran for a tensor that is not on the CPU")

    monkeypatch.setattr(build, "_lib", types.SimpleNamespace(lw_prep_launch=launch))
    monkeypatch.setattr(build, "launch_target", lambda what, dev: (0, 0))
    monkeypatch.setattr(k6, "_smem_limit", lambda dev: SMEM_LIMIT)
    monkeypatch.setattr(k6, "lw_prep_plain", twin)
    _, pm = model_pair(LW_MODEL)
    meta = torch.device("meta")
    args = [a.to(meta) for a in _prep_args(pm, CPU, ncol=5, nlay=13)[1:]]
    model = nn_model_from_arrays(*model_arrays(pm), device=meta)
    n = k6.LAUNCHES
    got = k6.lw_prep(model, *args)
    assert [tuple(t.shape) for t in got] == [(13, 5, 128)] * 3 + [(5, 128)]
    assert seen == [((5, 13, 18, 128, 16), (128, 256),
                     tuple(k6.lw_prep_plan(13, 18, 128, 128, 128)))]
    assert k6.LAUNCHES == n + 1
