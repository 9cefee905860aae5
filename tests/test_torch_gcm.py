"""The port's GCM sweep (drivers/gcm.py) against the JAX package on the same
numpy inputs: the host synthesis, the mixed-precision packer (every case
of the JAX package's own packing tests) and the fields an f32 sweep's step
takes (the lanes of the JAX package's packed block) bit for bit, the
dequantization to rtol 1e-6
with every threshold side identical, and gcm_sweep_lw / gcm_sweep_allsky
per column to LW 2e-3 and SW 2e-2 W/m2 for f32 and mixed precision, both
vertical orientations, lookup-table and Pade cloud files, on the staged
route and on the fused route through the kernels' plain twins. Beyond the
bound float64 decides (LW), and a staged-SW column near the two-stream
resonance is held by the F1 law (ROADMAP Queue 3 F1).

In the port alone: mixed against f32, night SW exactly 0, resident equal
to streamed, and the block step off the CPU (meta tensors) reaching only
the kernels of its route."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import gcm as jgcm
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.drivers import gcm as pgcm
from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.testing import (
    SW_F1_LAW, float64_copy, gcm_sw_resonance_distance, model_arrays, synthesize_rfmip)
from test_torch_cloud_optics import cloud_optics_pair
from test_torch_core import CPU, LW_MODEL, SW_MODEL, model_pair, rfmip_pair

NBASE, NLAY, NCOL, BLOCK = 24, 10, 150, 64  # 150 columns: two blocks of 64 and one of 22
LW_ATOL, SW_ATOL = 2e-3, 2e-2
GRAZING = slice(10, 20)  # columns given a grazing sun (sza 84.5-89.9 deg)


def _base(seed=3):
    """(JAX, port) RFMIPData; the per-layer gas profiles stored 2-D, as
    the JAX synthesize_gcm_columns takes them."""
    d = synthesize_rfmip(NBASE, NLAY, seed)
    for g, v in d["gases"].items():
        if v.ndim == 1:
            d["gases"][g] = np.broadcast_to(v[None], (NBASE, NLAY)).copy()
    return rfmip_pair(d)


def _host(top_at_1=True):
    """The GCM host of both packages (one dict: they are equal), with a
    band of grazing suns; vertically flipped for top_at_1 False (the
    flipped host of the JAX package's orientation test)."""
    jd, _ = _base()
    host = jgcm.synthesize_gcm_columns(jd, NCOL, seed=1)
    host["sza"][GRAZING] = np.linspace(84.5, 89.9, 10)
    if not top_at_1:
        host = {k: (v[:, ::-1].copy() if v.ndim == 2 else v) for k, v in host.items()}
    return host


@pytest.fixture(scope="module")
def models():
    jl, pl = model_pair(LW_MODEL)
    js, ps = model_pair(SW_MODEL)
    return {"lw": ([jl], [pl]), "sw": ([js, js], [ps, ps])}


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    """(JAX, port) cloud optics of synthetic LW and SW coefficient files,
    by flavour."""
    tmp = tmp_path_factory.mktemp("gcm-clouds")
    return {fl: (cloud_optics_pair(tmp, "lw", 5, fl), cloud_optics_pair(tmp, "sw", 6, fl))
            for fl in ("lut", "pade")}


_JAX_RUNS = {}


def _jax_sweep(kind, models, clouds, flavour, precision, top_at_1):
    """The JAX sweep of one case, run once per module."""
    key = (kind, flavour, precision, top_at_1)
    if key not in _JAX_RUNS:
        host = _host(top_at_1)
        if kind == "lw":
            _JAX_RUNS[key] = jgcm.gcm_sweep_lw(host, models["lw"][0], block_size=BLOCK,
                                               top_at_1=top_at_1, precision=precision)
        else:
            (jcl, _), (jcs, _) = clouds[flavour]
            _JAX_RUNS[key] = jgcm.gcm_sweep_allsky(host, models["lw"][0], models["sw"][0], jcl,
                                                   jcs, block_size=BLOCK, top_at_1=top_at_1,
                                                   precision=precision)
    return _JAX_RUNS[key]["diagnostics"]


def _hold_lw(port, ref, arbiter):
    """LW diagnostics within LW_ATOL of the JAX package; beyond it float64
    decides: the port must be at least as close to it as JAX."""
    err = np.abs(port - ref)
    if err.max() > LW_ATOL:
        f64 = arbiter()
        over = err > LW_ATOL
        assert np.all(np.abs(port - f64)[over] <= np.abs(ref - f64)[over]), err.max()


def _hold_sw(port, ref, dist):
    """SW surface down flux within SW_ATOL of the JAX package, or within
    the F1 law at a column near the two-stream resonance."""
    err = np.abs(port - ref)
    limit = np.maximum(SW_ATOL, SW_F1_LAW / dist)
    assert np.all(err <= limit), (err.max(), dist[err.argmax()])


# -- the host, the f32 fields and the packer -----------------------------------

@pytest.mark.parametrize("ncol", [17, NCOL])
def test_synthesize_gcm_columns_matches_jax(ncol):
    jd, pd = _base()
    ref = jgcm.synthesize_gcm_columns(jd, ncol, seed=5)
    got = pgcm.synthesize_gcm_columns(pd, ncol, seed=5)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["gas:co2"].ndim == 1 and got["gas:h2o"].ndim == 2


def test_synthesize_gcm_columns_takes_per_layer_profiles():
    """A gas stored as a per-layer profile (nlay,), as GasConcs allows, is
    shared by every column. The JAX function raises on it (ROADMAP Queue 3
    F6); with the profile stored 2-D the two agree."""
    d = synthesize_rfmip(NBASE, NLAY, 3)
    assert d["gases"]["ch4"].ndim == 1
    jd, pd = rfmip_pair(d)
    with pytest.raises(ValueError):
        jgcm.synthesize_gcm_columns(jd, NCOL, seed=1)
    got = pgcm.synthesize_gcm_columns(pd, NCOL, seed=1)
    ref = pgcm.synthesize_gcm_columns(_base()[1], NCOL, seed=1)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["gas:ch4"], np.full(NCOL, d["gases"]["ch4"][0]))


class _Packed(Exception):
    """Ends a JAX sweep once it has packed its host columns."""


@pytest.mark.parametrize("kind", ["lw", "allsky"])
def test_f32_sweep_steps_take_the_jax_packed_lanes(models, clouds, monkeypatch, kind):
    """The fields a precision="f32" sweep's step receives, joined over its
    blocks (two of 64 columns and a ragged 22), equal bit for bit the lanes
    of the JAX package's packed block for the same host (its
    _unpack_columns of the _pack_columns its sweep makes): the same fields
    in the same order, shapes and float32 values. The host arrays are left
    as they were."""
    host = _host()
    before = {k: v.copy() for k, v in host.items()}
    (jcl, pcl), (jcs, pcs) = clouds["lut"]
    pack = jgcm._pack_columns

    def packed(arrays):
        raise _Packed(pack(arrays))

    monkeypatch.setattr(jgcm, "_pack_columns", packed)
    with pytest.raises(_Packed) as stop:
        if kind == "lw":
            jgcm.gcm_sweep_lw(host, models["lw"][0], block_size=BLOCK)
        else:
            jgcm.gcm_sweep_allsky(host, models["lw"][0], models["sw"][0], jcl, jcs,
                                  block_size=BLOCK)
    ref, widths = stop.value.args[0]
    want = [np.asarray(w) for w in jgcm._unpack_columns(jnp.asarray(ref), tuple(widths))]

    blocks, job = [], pgcm._f32_job

    def recorded_job(arrays, body, nfix, dtype):
        step, arrays = job(arrays, body, nfix, dtype)

        def recorded(*fields):
            blocks.append([f.numpy().copy() for f in fields])
            return step(*fields)

        return recorded, arrays

    monkeypatch.setattr(pgcm, "_f32_job", recorded_job)
    if kind == "lw":
        pgcm.gcm_sweep_lw(host, models["lw"][1], block_size=BLOCK, device=CPU)
    else:
        pgcm.gcm_sweep_allsky(host, models["lw"][1], models["sw"][1], pcl, pcs,
                              block_size=BLOCK, device=CPU)
    assert [len(b) for b in blocks] == [len(want)] * 3
    assert [b[0].shape[0] for b in blocks] == [BLOCK, BLOCK, NCOL - 2 * BLOCK]
    for i, w in enumerate(want):
        got = np.concatenate([b[i] for b in blocks])
        assert got.dtype == w.dtype == np.float32 and got.shape == w.shape, i
        np.testing.assert_array_equal(got, w, err_msg=str(i))
    for k, v in before.items():
        np.testing.assert_array_equal(host[k], v, err_msg=k)


def _mixed_cases():
    """The specs of the JAX package's packing tests (test_aux_components.py:
    250-325) and of both GCM sweeps on a host."""
    rng = np.random.default_rng(0)
    roundtrip = [(rng.uniform(180.0, 320.0, (64, 60)).astype(np.float32), "lin"),
                 (np.exp(rng.uniform(0.0, 11.5, (64, 60))).astype(np.float32), "log"),
                 (np.exp(rng.uniform(-16.0, -3.5, (64, 60))).astype(np.float32), "log"),
                 (rng.uniform(250.0, 310.0, (64,)).astype(np.float32), "f32")]
    t = 263.0
    lane_a = np.linspace(262.9, 263.1, 64).astype(np.float64)
    lane_a[[7, 23]] = t  # exact-threshold values in a lane whose grid misses t
    lane_b = t + np.linspace(0.0, 0.05, 64) ** 2  # lane minimum exactly on t
    lane_b[11] = t + 1e-4
    arr = np.stack([lane_a, lane_b], axis=1)
    h = _host()
    allsky = [(h["play"], ("log", ((pgcm.CLOUD_P_MIN, ">"), pgcm.CLOUD_P_MAX))),
              (h["plev"][:, :1], "f32"), (np.diff(h["plev"], axis=1), "lin"),
              (h["tlay"], ("lin", ((pgcm.CLOUD_T_LIQ, ">"), pgcm.CLOUD_T_ICE))),
              (h["tlev"], "lin"), (h["tsfc"], "f32")]
    allsky += [(h[k], pgcm._gas_pack_kind(h[k])) for k in h if k.startswith("gas:")]
    return {"roundtrip": roundtrip, "strict_gt": [(arr, ("lin", ((t, ">"),)))],
            "plain_ge": [(arr, ("lin", (t,)))], "gcm_host": allsky}


@pytest.mark.parametrize("case", ["roundtrip", "strict_gt", "plain_ge", "gcm_host"])
def test_pack_columns_mixed_matches_jax(case):
    specs = _mixed_cases()[case]
    got = pgcm._pack_columns_mixed(specs)
    ref = jgcm._pack_columns_mixed(specs)
    assert got[3] == ref[3]  # layout
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    pf, pq, qmeta, layout = got
    deq = pgcm._unpack_columns_mixed(torch.from_numpy(pf), torch.from_numpy(pq),
                                     torch.from_numpy(qmeta), layout)
    want = jgcm._unpack_columns_mixed(jnp.asarray(pf), jnp.asarray(pq), jnp.asarray(qmeta), layout)
    # the codes as the sweeps stream them: their int16 bits
    bits = pgcm._unpack_columns_mixed(torch.from_numpy(pf), torch.from_numpy(pq.view(np.int16)),
                                      torch.from_numpy(qmeta), layout)
    for g, w, b in zip(deq, want, bits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        np.testing.assert_array_equal(g.numpy(), b.numpy())
    for (a, kind), g, w in zip(specs, deq, want):
        if isinstance(kind, tuple):
            raw = np.asarray(a, np.float32).astype(np.float64)
            for t in kind[1]:
                t, strict = (t[0], True) if isinstance(t, tuple) else (t, False)
                side = (lambda v: v > t) if strict else (lambda v: v >= t)
                np.testing.assert_array_equal(side(g.numpy().astype(np.float64)), side(raw))
                np.testing.assert_array_equal(side(g.numpy()), side(np.asarray(w)))


def test_pack_columns_mixed_log_rejects_nonpositive():
    for mod in (pgcm, jgcm):
        with pytest.raises(ValueError, match="requires positive"):
            mod._pack_columns_mixed([(np.zeros((4, 3), np.float32), "log")])


def test_gas_pack_kind_matches_jax():
    rng = np.random.default_rng(4)
    cases = [rng.uniform(1e-8, 1e-2, (20, 6)), rng.uniform(0.0, 1.0, 20),
             np.where(rng.uniform(0, 1, (20, 6)) > 0.5, rng.uniform(1e-6, 1e-3, (20, 6)), 0.0),
             np.concatenate([np.zeros((10, 6)), np.full((10, 6), 1e-9)]) + np.eye(20, 6) * 1e-3]
    for v in cases:
        assert pgcm._gas_pack_kind(v) == jgcm._gas_pack_kind(v)
    assert {pgcm._gas_pack_kind(v) for v in cases} == {"log", "f32", "lin"}


# -- the sweeps against the JAX package -------------------------------------------

@pytest.mark.parametrize("route", ["staged", "fused"])
@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_gcm_sweep_lw_matches_jax(models, precision, top_at_1, route):
    ref = _jax_sweep("lw", models, None, None, precision, top_at_1)
    host = _host(top_at_1)
    with pco(use_megakernel=route == "fused"):
        got = pgcm.gcm_sweep_lw(host, models["lw"][1], block_size=BLOCK, top_at_1=top_at_1,
                                precision=precision, device=CPU)
    assert got["ncol"] == NCOL and got["diagnostics"].shape == (NCOL, 2)
    assert got["mean_olr"] == pytest.approx(float(got["diagnostics"][:, 0].mean()))
    _hold_lw(got["diagnostics"], ref, lambda: pgcm.gcm_sweep_lw(
        host, [float64_copy(models["lw"][1][0])], block_size=BLOCK, top_at_1=top_at_1,
        dtype=torch.float64, device=CPU)["diagnostics"])


@pytest.mark.parametrize("route", ["staged", "fused"])
@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("flavour", ["lut", "pade"])
def test_gcm_sweep_allsky_matches_jax(models, clouds, flavour, precision, top_at_1, route):
    ref = _jax_sweep("allsky", models, clouds, flavour, precision, top_at_1)
    host = _host(top_at_1)
    (_, pcl), (_, pcs) = clouds[flavour]
    with pco(use_megakernel=route == "fused"):
        got = pgcm.gcm_sweep_allsky(host, models["lw"][1], models["sw"][1], pcl, pcs,
                                    block_size=BLOCK, top_at_1=top_at_1, precision=precision,
                                    device=CPU)
    diag = got["diagnostics"]
    assert diag.shape == (NCOL, 3) and np.isfinite(diag).all()
    assert got["mean_sw_sfc_dn"] == pytest.approx(float(diag[:, 2].mean()))

    def arbiter():
        lw64 = [float64_copy(models["lw"][1][0])]
        sw64 = [float64_copy(models["sw"][1][0])] * 2
        return pgcm.gcm_sweep_allsky(host, lw64, sw64, pcl.to(CPU, torch.float64),
                                     pcs.to(CPU, torch.float64), block_size=BLOCK,
                                     top_at_1=top_at_1, dtype=torch.float64,
                                     device=CPU)["diagnostics"][:, :2]

    _hold_lw(diag[:, :2], ref[:, :2], arbiter)
    dist = gcm_sw_resonance_distance(host, np.arange(NCOL), models["sw"][1], pcl, pcs)
    _hold_sw(diag[:, 2], ref[:, 2], dist)


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_gcm_flipped_host_gives_the_same_diagnostics(models, clouds, route):
    """A vertically flipped host with top_at_1 flipped is the same
    atmosphere: the diagnostics agree exactly, in the port as in the JAX
    package."""
    (_, pcl), (_, pcs) = clouds["lut"]
    with pco(use_megakernel=route == "fused"):
        runs = {top: (pgcm.gcm_sweep_lw(_host(top), models["lw"][1], block_size=BLOCK,
                                        top_at_1=top, device=CPU)["diagnostics"],
                      pgcm.gcm_sweep_allsky(_host(top), models["lw"][1], models["sw"][1], pcl,
                                            pcs, block_size=BLOCK, top_at_1=top,
                                            device=CPU)["diagnostics"])
                for top in (True, False)}
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_jax_sweep("lw", models, None, None, "f32", True),
                                  _jax_sweep("lw", models, None, None, "f32", False))


# -- the port alone ------------------------------------------------------------------

@pytest.mark.parametrize("route", ["staged", "fused"])
def test_gcm_mixed_matches_f32_and_night_sw_is_zero(models, clouds, route):
    """The JAX package's own bounds: LW 0.02 W/m2, all-sky 0.05 with the
    grazing band (those columns take the exact-f32 side sweep); night SW
    exactly 0 in both precisions."""
    host = _host()
    (_, pcl), (_, pcs) = clouds["lut"]
    with pco(use_megakernel=route == "fused"):
        lw = [pgcm.gcm_sweep_lw(host, models["lw"][1], block_size=BLOCK, precision=p,
                                device=CPU)["diagnostics"] for p in ("f32", "mixed")]
        sky = [pgcm.gcm_sweep_allsky(host, models["lw"][1], models["sw"][1], pcl, pcs,
                                     block_size=BLOCK, precision=p, device=CPU)["diagnostics"]
               for p in ("f32", "mixed")]
    assert np.abs(lw[0] - lw[1]).max() < 0.02
    assert np.abs(sky[0] - sky[1]).max() < 0.05
    mu0 = np.cos(np.deg2rad(host["sza"]))
    night = mu0 <= 0.0
    assert night.any() and ((mu0 > 0) & (mu0 <= 0.1)).sum() >= 10
    for d in sky:
        assert np.all(d[night, 2] == 0.0) and np.all(d[~night, 2] > 0.0)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_gcm_resident_equals_streamed(models, clouds, precision):
    host = _host()
    (_, pcl), (_, pcs) = clouds["pade"]
    kw = dict(block_size=BLOCK, precision=precision, device=CPU)
    for fn, args in ((pgcm.gcm_sweep_lw, (models["lw"][1],)),
                     (pgcm.gcm_sweep_allsky, (models["lw"][1], models["sw"][1], pcl, pcs))):
        streamed = fn(host, *args, warmup=True, **kw)
        resident = fn(host, *args, resident=True, **kw)
        np.testing.assert_array_equal(streamed["diagnostics"], resident["diagnostics"])
        assert resident["elapsed_s"] > 0 and resident["columns_per_s"] > 0


def test_gcm_sweeps_refuse_what_the_kernels_do_not_take(models, clouds):
    """On CUDA a float64 sweep is refused in the dispatch's words before any
    tensor reaches a card; an unknown precision is refused anywhere."""
    host = _host()
    (_, pcl), (_, pcs) = clouds["lut"]
    with pytest.raises(NotImplementedError, match="gcm_sweep_lw: .*runs only on the CPU"):
        pgcm.gcm_sweep_lw(host, models["lw"][1], dtype=torch.float64, device="cuda")
    with pytest.raises(NotImplementedError, match=r"gcm_sweep_allsky \(LW\): .*only on the CPU"):
        pgcm.gcm_sweep_allsky(host, models["lw"][1], models["sw"][1], pcl, pcs,
                              dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="precision 'bf16'"):
        pgcm.gcm_sweep_lw(host, models["lw"][1], precision="bf16", device=CPU)


# the fused route's kernels: one launch of each per block; the staged
# route's: the MLP kernel and the transport kernel (LW), the MLP kernel (SW)
_BLOCK_ROUTES = {
    "fused": (True, {"k1": 1, "k2": 1}, {"k1": 1}),
    "staged": (False, {"fused_predict_lw_both": 1, "k7": 1, "fused_predict_sw": 1},
               {"fused_predict_lw_both": 1, "k7": 1}),
}


@pytest.mark.parametrize("flavour", ["lut", "pade"])
@pytest.mark.parametrize("route", list(_BLOCK_ROUTES))
def test_gcm_block_off_the_cpu_launches_its_kernels_never_twins(models, clouds, monkeypatch,
                                                                route, flavour):
    """A GCM block off the CPU reaches only the kernel wrappers of its
    route, which launch, and never a kernel's plain twin. Meta tensors
    (shape and dtype without data) stand in for the card: the launches
    are recorded instead of run, each checks that the tensors it would
    hand the kernel are contiguous, and every twin raises."""
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2

    meta = torch.device("meta")
    launched, modes = {}, []

    def contiguous(*args):
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else [a]):
                assert not torch.is_tensor(t) or t.is_contiguous()

    def count(name):
        launched[name] = launched.get(name, 0) + 1

    def mlp_launch(name, nets, x, col_dry, ngpt, n_out):
        contiguous(x, col_dry)
        count(name)
        return [torch.empty(tuple(x.shape[:-1]) + (ngpt,), device=x.device)] * n_out

    def k7_launch(tau, *args):
        count("k7")
        return [torch.empty((tau.shape[0], tau.shape[1] + 1), device=tau.device)] * 2

    def mega_launch(name, n_out):
        def launch(mode, *args, **kwargs):
            contiguous(*args[1:], *kwargs.values())
            count(name)
            modes.append(mode)
            col_dry = args[5]
            return [torch.empty((col_dry.shape[1], col_dry.shape[0] + 1),
                                device=col_dry.device)] * n_out
        return launch

    def twin(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran off the CPU")

    monkeypatch.setattr(mlp, "_launch", mlp_launch)
    monkeypatch.setattr(k7, "_launch", k7_launch)
    monkeypatch.setattr(k1, "_launch", mega_launch("k1", 2))
    monkeypatch.setattr(k2, "_launch", mega_launch("k2", 3))
    for mod, names in ((mlp, ("fused_predict_lw_both_plain", "fused_predict_tau_plain",
                              "fused_predict_sw_plain")),
                       (k7, ("lw_noscat_broadband_plain",)),
                       (k1, ("lw_clearsky_mega4_plain", "lw_clearsky_mega5_plain")),
                       (k2, ("sw_clearsky_megakernel_plain",)),
                       (plw, ("lw_solver_noscat_lay_major", "lw_broadband_sweeps"))):
        for name in names:
            monkeypatch.setattr(mod, name, twin)

    mega, expect_sky, expect_lw = _BLOCK_ROUTES[route]
    mode = {"lut": "cld_lut", "pade": "cld_bands"}[flavour]
    lw = [nn_model_from_arrays(*model_arrays(models["lw"][1][0]), device=meta)]
    sw = [nn_model_from_arrays(*model_arrays(models["sw"][1][0]), device=meta)] * 2
    (_, pcl), (_, pcs) = clouds[flavour]
    host = _host()
    names = [k[4:] for k in host if k.startswith("gas:")]
    gases = [host[f"gas:{g}"][:BLOCK] for g in names]
    mu0 = np.cos(np.deg2rad(host["sza"][:BLOCK])).astype(np.float32)
    fields = [host[k][:BLOCK] for k in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis")]

    def unpacked(arrays):
        """The arrays as a sweep's step has them: each field its own
        contiguous block on the device."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(meta) for a in arrays]

    with pco(use_megakernel=mega):
        body = pgcm._allsky_body(lw, sw, pcl.to(meta), pcs.to(meta), names, True, torch.float32,
                                 pgcm._mesh_for(None, meta), meta)
        lanes = unpacked(fields + [host["sfc_alb"][:BLOCK], mu0, np.ones(BLOCK, np.float32)]
                         + gases)
        got = body(*lanes[:9], lanes[9:])
        assert got.device == meta and tuple(got.shape) == (BLOCK, 3)
        assert launched == expect_sky and modes == ([mode, mode] if mega else [])
        launched.clear(), modes.clear()
        body = pgcm._lw_body(lw, names, True, torch.float32, pgcm._mesh_for(None, meta), meta)
        lanes = unpacked(fields + gases)
        got = body(*lanes[:6], lanes[6:])
        assert tuple(got.shape) == (BLOCK, 2)
        assert launched == expect_lw and modes == (["clear"] if mega else [])


def test_gcm_mesh_names_the_current_card_by_index(monkeypatch):
    """device="cuda" (no index) becomes the current card by index, as the
    block tensors report their device: the step looks up the replicated
    models by it (a sweep with device="cuda" failed with a KeyError)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert pgcm._mesh_for(None, "cuda").devices == (torch.device("cuda", 0),)
    assert pgcm._mesh_for(None, "cuda:0").devices == (torch.device("cuda", 0),)
    assert pgcm._mesh_for(None, CPU).devices == (CPU,)
