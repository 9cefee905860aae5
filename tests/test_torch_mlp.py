"""PyTorch port against the JAX package: the plain twins of the MLP kernel
(K3 fused_predict_lw_both, K4 fused_predict_tau, K5 fused_predict_sw)
against the JAX Pallas kernels in interpret mode, on a ragged row count
and on a seeded 8-layer net that uses all seven activations; the NN
prediction and the column-major LW/SW gas optics against the JAX
functions; two-model LW against one-model LW. Bounds: tau and pfrac rtol
2e-5 (the JAX package's kernel bounds, tests/test_pallas_mlp.py), ssa
atol 2e-5; gas optics tau rtol 1e-4 (tau is y**8: 8x the relative error
of y; below 1e-12 it underflows differently and is physically zero)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gas_concs import GasConcs as JGC
from rte_rrtmgp_nn_tpu.gasoptics import nn_gas_optics as jgo
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.ops.pallas import mlp as jmlp
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs as PGC
from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as pgo
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
from rte_rrtmgp_nn_tpu_torch.testing import (
    ALL_ACTIVATIONS, model_arrays, random_gas_optics_net_arrays, split_lw_both_arrays,
    synthesize_rfmip)
from test_torch_core import (
    CPU, LW_MODEL, SW_MODEL, close, jax_model_from_arrays, model_pair, rfmip_pair)

ROWS = (3, 23)  # 69 rows: not a multiple of the Pallas tile (32)
SW_PAIR = [f"artifacts/sw-synth56-lut_{k}_128_128_HR_4.22e-02_FRC_1.44e-01.nc"
           for k in ("absorption", "rayleigh")]


def _deep_arrays(n_out):
    """A seeded net 18 -> 24 x 7 -> n_out: the seven activations between its
    hidden layers, a linear output."""
    return random_gas_optics_net_arrays((18,) + (24,) * 7 + (n_out,),
                                        ALL_ACTIVATIONS + ("linear",), seed=51)


def _pair_of(arrays):
    return jax_model_from_arrays(*arrays), nn_model_from_arrays(*arrays, device=CPU)


def _inputs(nin, seed=52):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, ROWS + (nin,)).astype(np.float32)
    cd = rng.uniform(1e20, 5e21, ROWS).astype(np.float32)
    return x, cd


def _models(case):
    """(JAX models, port models) of one kernel case."""
    if case in ("lw_demo", "sw_demo"):
        j, p = model_pair(LW_MODEL if case == "lw_demo" else SW_MODEL)
        return [j] if case == "lw_demo" else [j, j], [p] if case == "lw_demo" else [p, p]
    if case == "lw_deep":
        j, p = _pair_of(_deep_arrays(64))
        return [j], [p]
    if case == "tau_half":
        j, p = _pair_of(split_lw_both_arrays(*model_arrays(model_pair(LW_MODEL)[1]))[0])
        return [j], [p]
    if case == "tau_deep":
        j, p = _pair_of(_deep_arrays(32))
        return [j], [p]
    pairs = [model_pair(path) for path in SW_PAIR]
    return [q[0] for q in pairs], [q[1] for q in pairs]


@pytest.mark.parametrize("case", ["lw_demo", "lw_deep", "tau_half", "tau_deep", "sw_demo",
                                  "sw_pair"])
def test_twins_match_jax_kernels(case):
    jm, pm = _models(case)
    x, cd = _inputs(pm[0].n_inputs)
    jx, jcd, tx, tcd = jnp.asarray(x), jnp.asarray(cd), torch.from_numpy(x), torch.from_numpy(cd)
    if case.startswith("lw"):
        ref = jmlp.fused_predict_lw_both(jm[0], jx, jcd, tile_b=32, interpret=True)
        got = mlp.fused_predict_lw_both_plain(pm[0], tx, tcd)
        bounds = ((2e-5, 1e-8), (2e-5, 1e-9))
    elif case.startswith("tau"):
        ref = (jmlp.fused_predict_tau(jm[0], jx, jcd, tile_b=32, interpret=True),)
        got = (mlp.fused_predict_tau_plain(pm[0], tx, tcd),)
        bounds = ((2e-5, 1e-8),)
    else:
        ref = jmlp.fused_predict_sw(jm[0], jm[1], jx, jcd, tile_b=32, interpret=True)
        got = mlp.fused_predict_sw_plain(pm[0], pm[1], tx, tcd)
        bounds = ((2e-5, 1e-8), (0.0, 2e-5))
    for g, r, (rtol, atol) in zip(got, ref, bounds):
        assert tuple(g.shape) == ROWS + (r.shape[-1],)
    close(got[0].numpy(), ref[0], rtol=bounds[0][0], atol=bounds[0][1])
    if case.startswith("lw"):
        close(got[1].numpy(), ref[1], rtol=bounds[1][0], atol=bounds[1][1])
    elif case.startswith("sw"):
        # ssa where tau is not an underflow residue: XLA on the CPU flushes
        # denormal tau to 0 (ssa 0), PyTorch keeps it (ssa 1/2 with one
        # net standing in for both)
        big = np.asarray(ref[0]) > 1e-12
        close(got[1].numpy()[big], np.asarray(ref[1])[big], atol=bounds[1][1])
        assert (got[1].numpy()[got[0].numpy() == 0] == 0).all()
    if case == "sw_pair":  # a real Rayleigh net: ssa varies
        assert float(got[1].std()) > 1e-3


def test_wrappers_run_the_twins_on_cpu():
    """On CPU tensors each wrapper is its twin, bit for bit, and launches
    nothing."""
    before = dict(mlp.LAUNCHES)
    _, (lw,) = _models("lw_demo")
    _, (sw, _) = _models("sw_demo")
    x, cd = map(torch.from_numpy, _inputs(18))
    for a, b in zip(mlp.fused_predict_lw_both(lw, x, cd), mlp.fused_predict_lw_both_plain(lw, x, cd)):
        assert torch.equal(a, b)
    x7 = x[..., :7]
    assert torch.equal(mlp.fused_predict_tau(sw, x7, cd), mlp.fused_predict_tau_plain(sw, x7, cd))
    for a, b in zip(mlp.fused_predict_sw(sw, sw, x7, cd), mlp.fused_predict_sw_plain(sw, sw, x7, cd)):
        assert torch.equal(a, b)
    assert mlp.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        mlp.fused_predict_tau(sw, x7.to("meta"), cd.to("meta"))


@pytest.fixture(scope="module")
def atmos():
    """One synthesized atmosphere, column-major, as (numpy dict, JAX gases,
    port gases)."""
    d = synthesize_rfmip(11, 9, seed=53)
    return d, JGC.create(d["gases"]), PGC.create(d["gases"])


@pytest.mark.parametrize("models", ["one", "two"])
def test_predict_nn_lw_and_sw(atmos, models):
    d, jg, pg = atmos
    jm, pm = model_pair(LW_MODEL)
    if models == "two":
        halves = split_lw_both_arrays(*model_arrays(pm))
        jms = [jax_model_from_arrays(*a) for a in halves]
        pms = [nn_model_from_arrays(*a, device=CPU) for a in halves]
    else:
        jms, pms = [jm], [pm]
    col_dry = pgo.get_col_dry(pg.get_vmr("h2o", 11, 9), torch.from_numpy(d["plev"]))
    jcd = jnp.asarray(col_dry.numpy())
    jx = jgo.compute_nn_inputs(jnp.asarray(d["play"]), jnp.asarray(d["tlay"]), jg, jm)
    x = torch.from_numpy(np.array(jx))
    jt, jp = jgo.predict_nn_lw(jms, jx, jcd, use_pallas=False)
    pt, pp = pgo.predict_nn_lw(pms, x, col_dry)
    close(pt.numpy(), jt, rtol=1e-4, atol=1e-12)
    close(pp.numpy(), jp, atol=1e-7)
    js, ps = (list(q) for q in zip(*(model_pair(p) for p in SW_PAIR)))
    jx = jgo.compute_nn_inputs(jnp.asarray(d["play"]), jnp.asarray(d["tlay"]), jg, js[0])
    x = torch.from_numpy(np.array(jx))
    jt, jssa = jgo.predict_nn_sw(js, jx, jcd, use_pallas=False)
    pt, pssa = pgo.predict_nn_sw(ps, x, col_dry)
    close(pt.numpy(), jt, rtol=1e-4, atol=1e-12)
    close(pssa.numpy(), jssa, atol=2e-5)
    jt, _ = jgo.predict_nn_sw(js, jx, jcd, with_rayleigh=False, use_pallas=False)
    pt, none = pgo.predict_nn_sw(ps, x, col_dry, with_rayleigh=False)
    assert none is None
    close(pt.numpy(), jt, rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("top_at_1", [True, False])
def test_gas_optics_lw_and_sw_nn(top_at_1):
    """The column-major entry points, with interp_tlev for the level
    temperatures and Helmert gravity for the column dry amount."""
    d = synthesize_rfmip(11, 9, seed=54, top_at_1=top_at_1)
    jg, pg = JGC.create(d["gases"]), PGC.create(d["gases"])
    j, t = (lambda k: jnp.asarray(d[k])), (lambda k: torch.from_numpy(d[k]))
    jm, pm = model_pair(LW_MODEL)
    spec_j, spec_p = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(spec_j.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(spec_p.band_lims_wvn_array, device=CPU)
    close(pgo.interp_tlev(t("tlay"), t("play"), t("plev")).numpy(),
          jgo.interp_tlev(j("tlay"), j("play"), j("plev")), rtol=1e-5)
    lat = np.linspace(-80, 80, 11).astype(np.float32)
    close(pgo.get_col_dry(pg.get_vmr("h2o", 11, 9), t("plev"), torch.from_numpy(lat)).numpy(),
          jgo.get_col_dry(jg.get_vmr("h2o", 11, 9), j("plev"), jnp.asarray(lat)), rtol=1e-5)
    jtau, jsrc = jgo.gas_optics_lw_nn([jm], j("play"), j("plev"), j("tlay"), j("tsfc"), jg, spec_j,
                                      jt, top_at_1=top_at_1, save_pfrac=True, use_pallas=False)
    ptau, psrc = pgo.gas_optics_lw_nn([pm], t("play"), t("plev"), t("tlay"), t("tsfc"), pg, spec_p,
                                      pt, top_at_1=top_at_1, save_pfrac=True)
    close(ptau.numpy(), jtau, rtol=1e-4, atol=1e-12)
    for n in ("lay_source", "lev_source", "sfc_source", "sfc_source_jac", "planck_frac"):
        close(getattr(psrc, n).numpy(), getattr(jsrc, n), rtol=1e-4, atol=1e-6)
    js, ps = model_pair(SW_MODEL)
    spec_sj, spec_sp = jplanck.sw_spectral_g112(), pplanck.sw_spectral_g112()
    solar = prfmip.default_solar_source(spec_sp).astype(np.float32)
    jtau, jssa, jtoa = jgo.gas_optics_sw_nn([js, js], j("play"), j("plev"), j("tlay"), jg, spec_sj,
                                            jnp.asarray(solar), use_pallas=False)
    ptau, pssa, ptoa = pgo.gas_optics_sw_nn([ps, ps], t("play"), t("plev"), t("tlay"), pg, spec_sp,
                                            torch.from_numpy(solar))
    close(ptau.numpy(), jtau, rtol=1e-4, atol=1e-12)
    big = np.asarray(jtau) > 1e-12
    close(pssa.numpy()[big], np.asarray(jssa)[big])
    np.testing.assert_array_equal(ptoa.numpy(), np.asarray(jtoa))


def test_two_model_lw_equals_one_model():
    """The demo net split into its absorption and Planck-fraction halves
    gives the one-model fluxes (staged and multi-angle paths)."""
    _, pm = model_pair(LW_MODEL)
    halves = [nn_model_from_arrays(*a, device=CPU) for a in split_lw_both_arrays(*model_arrays(pm))]
    _, pd = rfmip_pair(synthesize_rfmip(9, 8, seed=55))
    for n in (1, 3):
        one = prfmip.rfmip_clear_sky_lw(pd, [pm], n_gauss_angles=n, device="cpu")
        with pco(use_megakernel=False):
            two = prfmip.rfmip_clear_sky_lw(pd, halves, n_gauss_angles=n, device="cpu")
        for name in ("flux_up", "flux_dn"):
            np.testing.assert_allclose(getattr(two, name).numpy(), getattr(one, name).numpy(),
                                       atol=1e-4, err_msg=f"{name}, {n} angles")


def test_hold_kernel_rule():
    """Within the bound of the twin passes; beyond it, float64 decides,
    allowing the kernel FLOAT32_SPREAD times the twin's own distance from
    float64."""
    from rte_rrtmgp_nn_tpu_torch.testing import FLOAT32_SPREAD, hold_kernel

    ref64 = torch.ones(4, dtype=torch.float64)
    twin = torch.tensor([1.0, 1.0, 1.0, 1.0 + 4e-5])  # 2 bounds from float64
    assert hold_kernel(twin, twin, ref64, 2e-5, 0.0) == {"kernel_twin": 0.0, "ok": True}
    near = torch.tensor([1.0, 1.0, 1.0, 1.0 - 1e-5])  # 2.5 bounds from the twin, 0.5 from f64
    assert hold_kernel(near, twin, ref64, 2e-5, 0.0)["ok"]
    within = torch.tensor([1.0, 1.0, 1.0 - 2e-5 * 2 * FLOAT32_SPREAD * 0.9, 1.0])
    assert hold_kernel(within, twin, ref64, 2e-5, 0.0)["ok"]
    beyond = torch.tensor([1.0, 1.0, 1.0 - 2e-5 * 2 * FLOAT32_SPREAD * 1.5, 1.0])
    r = hold_kernel(beyond, twin, ref64, 2e-5, 0.0)
    assert not r["ok"] and r["kernel_f64"] > FLOAT32_SPREAD * r["twin_f64"]


# -- the MLP kernel's launch plan, the net as the kernel reads it, the launch --------

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90
PLAN_NETS = {
    "lw_demo": [(18, 128, 128, 256)],
    "sw_demo_pair": [(7, 48, 48, 112)] * 2,
    "deep_all_activations": [(18,) + (40,) * 7 + (96,)],
    "hidden_512": [(18, 512, 512, 256)],
    "odd_outputs": [(18, 128, 128, 127)],
}


def _covered_once(rows, n_in, n_out, c, threads):
    """Walk the tiles of one layer as the kernel's threads walk them (round
    by round, (row tile, column tile) pairs) and count each (row, column)."""
    counts = np.zeros((rows, n_out), int)
    nct = -(-n_out // c)
    ntiles = nct * (rows // mlp.TILE_ROWS)
    for t0 in range(0, ntiles, threads):
        for t in range(t0, min(t0 + threads, ntiles)):
            rt, c0 = t // nct, (t % nct) * c
            counts[rt * mlp.TILE_ROWS:(rt + 1) * mlp.TILE_ROWS, c0:min(c0 + c, n_out)] += 1
    return bool((counts == 1).all())


@pytest.mark.parametrize("choices", [(256, 512), (512,)])
@pytest.mark.parametrize("name", list(PLAN_NETS))
def test_mlp_launch_plan_fits_and_covers_every_row_and_layer_once(monkeypatch, name, choices):
    """The plan's geometry is one the kernel is compiled for, as shipped
    (two blocks of 256 threads an SM where their shared memory fits, else
    one of 512) and at 512 threads alone, as the tuning script tries it; its
    shared memory is the sum of the kernel's regions (two k-major
    activation buffers as wide as the widest input or hidden layer, rows +
    4 floats from one k to the next, and two weight slabs of whole rows of
    the widest layer output, in 16-byte pieces), and the blocks that make
    512 threads fit an sm_90 SM together (1 KB reserved for each); the
    blocks cover every row once; in every layer the threads' tiles cover
    every (row, output) of a block once."""
    monkeypatch.setattr(mlp, "THREAD_CHOICES", choices)
    mlp.mlp_launch_plan.cache_clear()
    nets = PLAN_NETS[name]
    plan = mlp.mlp_launch_plan(*nets)
    mlp.mlp_launch_plan.cache_clear()
    width = max(max(d[:-1]) for d in nets)
    widest_out = max(max(d[1:]) for d in nets)
    assert plan.threads in choices and plan.rows in mlp.ROW_CHOICES
    assert plan.width == width
    assert plan.slab_floats % 4 == 0 and plan.slab_floats >= 4 * widest_out
    assert plan.smem_bytes == 4 * (2 * width * (plan.rows + 4) + 2 * plan.slab_floats)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 512 // plan.threads * (plan.smem_bytes + 1024) <= SMEM_LIMIT + 1024
    for n in (1, 31, 481, 108000):
        blocks = -(-n // plan.rows)
        starts = [b * plan.rows for b in range(blocks)]
        assert starts[-1] < n <= starts[-1] + plan.rows
    for d in nets:
        for i, (n_in, n_out) in enumerate(zip(d[:-1], d[1:])):
            c = 2 if i + 2 < len(d) else mlp.last_tile_columns(plan.rows, n_out, plan.threads)
            assert _covered_once(plan.rows, n_in, n_out, c, plan.threads), (d, i)


def test_mlp_launch_plan_takes_the_rows_that_keep_the_threads_busy():
    """Two blocks of 256 threads share an SM where their shared memory fits:
    the LW demo net's 128-wide layers give all 256 threads a tile at 32 rows
    per block, the SW nets' 48-wide layers need 64 rows for as few idle
    threads; 512-wide hidden layers leave no room for two blocks, so one
    block of 512 threads takes 32 rows. The last layer takes 8 x 4 tiles
    unless 8 x 2 ones fill the block in fewer rounds."""
    lw = mlp.mlp_launch_plan((18, 128, 128, 256))
    assert (lw.threads, lw.rows) == (256, 32)
    sw = mlp.mlp_launch_plan((7, 48, 48, 112), (7, 48, 48, 112))
    assert (sw.threads, sw.rows) == (256, 64)
    wide = mlp.mlp_launch_plan((18, 512, 512, 256))
    assert (wide.threads, wide.rows) == (512, 32)
    assert [mlp.last_tile_columns(r, n, t) for r, n, t in (
        (64, 256, 512), (64, 128, 512), (128, 112, 512), (32, 256, 256), (32, 128, 256),
        (64, 112, 256))] == [4, 2, 4, 4, 2, 4]
    # a smaller card limit leaves no room for two blocks, then costs the
    # weights' slabs their size, then rows
    small = mlp.mlp_launch_plan((18, 128, 128, 256), smem_limit=80_000)
    assert (small.threads, small.rows) == (512, 64) and small.slab_floats < 6144
    assert mlp.mlp_launch_plan((18, 128, 128, 256), smem_limit=50_000).rows == 32


@pytest.mark.parametrize("nets,match", [
    ([(18,) + (40,) * 8 + (96,)], "9-layer net is deeper than the kernel's 8"),
    ([(18, 513, 96)], "layer 513 wide is wider than the kernel's 512"),
    ([(18, 0, 96)], "must be positive"),
    ([(18, 512, 512, 256)], "too wide"),
])
def test_mlp_launch_plan_refuses_in_words(nets, match):
    """A net deeper or wider than the kernel takes, a zero width, and nets
    whose buffers do not fit the card's shared memory are refused with the
    reason."""
    limit = 100_000 if match == "too wide" else SMEM_LIMIT
    with pytest.raises(ValueError, match=match):
        mlp.mlp_launch_plan(*nets, smem_limit=limit)


@pytest.mark.parametrize("constant,value", [
    ("kThreads", mlp.THREADS), ("kTileRows", mlp.TILE_ROWS), ("kMaxLayers", 8),
    ("kMaxWidth", 512),
])
def test_mlp_constants_mirror_the_c_source(constant, value):
    """The plan reckons with the constants the kernel is compiled with
    (csrc/mlp.cu), the same as config's limits and build's struct size;
    the rows per block it may choose are the ones the launch entry
    instantiates."""
    import re

    from rte_rrtmgp_nn_tpu_torch.config import MLP_KERNEL_MAX_LAYERS, MLP_KERNEL_MAX_WIDTH
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    text = (build.CSRC_DIR / "mlp.cu").read_text()
    assert re.findall(rf"constexpr int {constant} = (\d+);", text) == [str(value)]
    assert (MLP_KERNEL_MAX_LAYERS, MLP_KERNEL_MAX_WIDTH) == (8, 512)
    assert build.MAX_LAYERS == 8
    entry = text[text.index('extern "C" int mlp_predict_launch'):]
    cases = re.findall(r"case (\d+): return launch_rows<(\d+)>", entry)
    assert [(int(a), int(b)) for a, b in cases] == [(r, r) for r in mlp.ROW_CHOICES]


def test_kernel_net_is_made_once_kept_with_the_model_and_dropped_when_it_moves():
    """The net as the kernel reads it (each layer's weight and bias, the
    output mean and std, widths and activation codes) is made once and kept
    with the model, so a call packs nothing; to() / double() and copies
    drop it with the tensors it points at."""
    import copy

    _, m = model_pair(LW_MODEL)
    net = mlp.kernel_net("test", m, CPU)
    assert mlp.kernel_net("test", m, CPU) is net and m.kernel_net == (CPU, m.tensor_key(), net)
    assert net.nlayers == 3 and list(net.dims[:4]) == [18, 128, 128, 256]
    assert list(net.act[:3]) == [mlp.ACT_CODES["softsign"]] * 2 + [mlp.ACT_CODES["linear"]]
    assert [net.w[i] for i in range(3)] == [w.data_ptr() for w in m.weights]
    assert [net.b[i] for i in range(3)] == [b.data_ptr() for b in m.biases]
    assert (net.omean, net.ostd) == (m.output_mean.data_ptr(), m.output_std.data_ptr())
    assert copy.deepcopy(m).kernel_net is None and m.kernel_net is not None
    m.to(torch.float32)
    assert m.kernel_net is None
    mlp.kernel_net("test", m, CPU)
    m.double()
    assert m.kernel_net is None
    with pytest.raises(ValueError, match="dtype torch.float64"):
        mlp.kernel_net("test", m, CPU)
    deep = nn_model_from_arrays(*random_gas_optics_net_arrays(
        (18,) + (24,) * 8 + (32,), ALL_ACTIVATIONS + ("linear", "linear"), seed=1), device=CPU)
    with pytest.raises(ValueError, match="deeper"):
        mlp.kernel_net("test", deep, CPU)


def test_wrappers_off_the_cpu_reach_the_launch_with_the_plan(monkeypatch):
    """Off the CPU each wrapper hands the launch entry its epilogue, the
    nets as the kernel reads them and mlp_launch_plan's geometry, and counts
    the launch; meta tensors stand in for the card and a recording library
    for the kernel, and every twin raises."""
    import types

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    seen = []

    def launch(epilogue, x, cd, net_a, net_b, plan, out0, out1, rows, device, stream):
        seen.append((epilogue, list(net_a._obj.dims), None if net_b is None else
                     list(net_b._obj.dims), tuple(getattr(plan._obj, f) for f, _ in
                                                  build.MlpPlan._fields_), rows))
        return 0

    def twin(*a, **k):
        raise AssertionError("a plain twin ran for a tensor that is not on the CPU")

    monkeypatch.setattr(build, "_lib", types.SimpleNamespace(mlp_predict_launch=launch))
    monkeypatch.setattr(build, "launch_target", lambda what, dev: (0, 0))
    monkeypatch.setattr(mlp, "_smem_limit", lambda dev: SMEM_LIMIT)
    for name in ("fused_predict_lw_both_plain", "fused_predict_tau_plain",
                 "fused_predict_sw_plain"):
        monkeypatch.setattr(mlp, name, twin)
    meta = torch.device("meta")
    on_meta = lambda arrays: nn_model_from_arrays(*arrays, device=meta)
    lw = on_meta(model_arrays(model_pair(LW_MODEL)[1]))
    tau = on_meta(split_lw_both_arrays(*model_arrays(model_pair(LW_MODEL)[1]))[0])
    sw = [on_meta(model_arrays(model_pair(p)[1])) for p in SW_PAIR]
    x, cd = torch.empty((5, 7, 18), device=meta), torch.empty((5, 7), device=meta)
    n = dict(mlp.LAUNCHES)
    got = mlp.fused_predict_lw_both(lw, x, cd)
    assert [tuple(t.shape) for t in got] == [(5, 7, 128)] * 2
    assert tuple(mlp.fused_predict_tau(tau, x, cd).shape) == (5, 7, 128)
    x7 = torch.empty((35, 7), device=meta)
    assert [tuple(t.shape) for t in mlp.fused_predict_sw(*sw, x7, cd.reshape(35))] == [(35, 56)] * 2
    dims = lambda m: list(m.dims) + [0] * (9 - len(m.dims))
    plan = lambda *ms: tuple(mlp.mlp_launch_plan(*(tuple(m.dims) for m in ms)))
    assert seen == [(0, dims(lw), None, plan(lw), 35), (1, dims(tau), None, plan(tau), 35),
                    (2, dims(sw[0]), dims(sw[1]), plan(*sw), 35)]
    assert mlp.LAUNCHES == {k: v + 1 for k, v in n.items()}
