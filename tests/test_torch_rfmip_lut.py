"""The RFMIP drivers' lookup-table route: ``rfmip_clear_sky_lw`` / ``_sw``
handed a k-distribution in place of the nets, on small synthetic
k-distributions (3 g-points a band) and RFMIP columns, in both vertical
orientations:

  - against the benchmark's plain reference (radbench/reference/lut.py,
    which reads the file itself) in float64;
  - against the JAX package's gas_optics_lw_lut -> rte_lw and
    gas_optics_sw_lut -> rte_sw on the same numpy inputs, scaled to each
    column's TSI and masked as the driver does, in float64 and in float32;
  - each refusal in words, the stages' spans, K7 once off the CPU, and the
    nets' dispatch as before.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radbench.reference import lut as RL
from radbench.reference import physics as RP
from rte_rrtmgp_nn_tpu import gas_concs as jgc
from rte_rrtmgp_nn_tpu.gasoptics import kdist as jkdist
from rte_rrtmgp_nn_tpu.gasoptics import lut_gas_optics as jlut
from rte_rrtmgp_nn_tpu.rte import rte_lw as jrte_lw
from rte_rrtmgp_nn_tpu.rte import rte_sw as jrte_sw
from rte_rrtmgp_nn_tpu.config import config_override as jconfig_override
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.config import config_override
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import PlanckTable, lw_spectral_g256
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from test_torch_core import CPU, LW_MODEL, SW_MODEL

# the module, which the package's ``config`` (the settings object) shadows
pconfig = importlib.import_module("rte_rrtmgp_nn_tpu_torch.config")

GPB, NEXP, NSITES, NLAY = 3, 3, 4, 12
# float64 (the same equations, summed in other orders; the port's
# two-stream floor config.k_min set by config.dtype = float64, as the
# reference's and JAX's are): SW to 1e-9 W/m2 (measured 3e-13); LW to 2e-7
# of the largest flux compared, since the linear-in-tau source
# (1 - T) / tau - T keeps only ~sqrt(eps) of its digits just above the
# series threshold tau = sqrt(eps), so the last bit of exp that two codes
# round apart moves a flux by ~eps / sqrt(eps) = 1.5e-8 of the fluxes
# (measured 3.2e-8)
F64_LW_REL, F64_SW_ATOL = 2e-7, 1e-9
# float32 against JAX: the suite's other driver comparisons (the two
# frameworks round log, exp and divides differently), W/m2
F32_LW_ATOL, F32_SW_ATOL = 2e-3, 2e-2
DTYPES = {"float64": (torch.float64, jnp.float64), "float32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("kdist")
    out = {}
    for band in ("lw", "sw"):
        out[band] = str(d / f"kdist-{band}.nc")
        generate_kdist_nc(out[band], kind=band, gases=T.LUT_GASES, gpts_per_band=GPB, seed=5)
    return out


def kdists(files, dtype_name):
    return {b: load_kdist(p, T.LUT_GASES, DTYPES[dtype_name][0], device=CPU)
            for b, p in files.items()}


def rfmip_arrays(top_at_1: bool, seed: int = 21) -> dict:
    """RFMIP experiments (their own gases, more than the k-distribution
    names), turned surface-first where ``top_at_1`` is False."""
    a = T.synthesize_rfmip_experiments(NEXP, NSITES, NLAY, seed)
    if not top_at_1:
        for f in ("play", "plev", "tlay", "tlev"):
            a[f] = np.ascontiguousarray(a[f][:, ::-1])
        a["gases"] = {g: np.ascontiguousarray(v[..., ::-1]) if v.ndim else v
                      for g, v in a["gases"].items()}
        a["top_at_1"] = False
    return a


def driver(a: dict, kd: dict):
    """Both drivers' LUT route in the k-distributions' dtype, which is also
    the working precision of config (the two-stream floor k_min)."""
    data = rfmip_data_from_arrays(a)
    dtype = kd["lw"].kmajor.dtype
    with config_override(dtype=dtype):
        return (prfmip.rfmip_clear_sky_lw(data, kd["lw"], dtype=dtype, device=CPU),
                prfmip.rfmip_clear_sky_sw(data, kd["sw"], dtype=dtype, device=CPU))


def sun(a: dict):
    """The driver's cos(sza), computed as drivers/rfmip._sun does (in the
    precision of the RFMIP arrays), and the day columns."""
    return np.cos(np.deg2rad(a["sza"])), a["sza"] < 90.0


@pytest.mark.parametrize("top_at_1", [True, False])
def test_lut_route_matches_the_plain_reference(files, top_at_1):
    a = rfmip_arrays(top_at_1)
    lw, sw = driver(a, kdists(files, "float64"))
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)
    gases = {g: t(v) for g, v in a["gases"].items()}
    ref = {b: RL.KDistOn(RL.read_kdist(p), CPU, RP.REFERENCE) for b, p in files.items()}
    up, dn = RL.lw_fluxes(ref["lw"], *(t(a[f]) for f in ("play", "plev", "tlay", "tlev", "tsfc",
                                                          "sfc_emis")),
                          gases, torch.float64, top_at_1)
    mu0, day = sun(a)
    mu0 = t(np.where(day, mu0, 1.0))
    sup, sdn, sdir = RL.sw_fluxes(ref["sw"], *(t(a[f]) for f in ("play", "plev", "tlay")), gases,
                                  mu0, t(a["tsi"]), t(a["sfc_alb"]), torch.float64, top_at_1)
    day = torch.as_tensor(day)
    for got, want in ((lw.flux_up, up), (lw.flux_dn, dn)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=F64_LW_REL * float(want.abs().max()))
    for got, want in ((sw.flux_up, sup), (sw.flux_dn, sdn), (sw.flux_dn_dir, sdir)):
        want = torch.where(day[:, None], want, 0.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=F64_SW_ATOL)
    assert float(sw.flux_dn[~day].abs().max()) == 0.0
    toa = 0 if top_at_1 else -1
    np.testing.assert_allclose(sw.flux_dn[day, toa].numpy(), (t(a["tsi"]) * mu0)[day].numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("top_at_1", [True, False])
def test_lut_route_matches_jax(files, top_at_1, dtype_name):
    pdt, jdt = DTYPES[dtype_name]
    a = rfmip_arrays(top_at_1)
    lw, sw = driver(a, kdists(files, dtype_name))
    jkd = {b: jkdist.load_kdist(p, T.LUT_GASES, dtype=jdt) for b, p in files.items()}
    j = lambda x: jnp.asarray(np.asarray(x), jdt)
    gc = jgc.GasConcs.create({g: j(a["gases"][g]) for g in T.LUT_GASES})
    play, plev, tlay, tlev, tsfc = (j(a[f]) for f in ("play", "plev", "tlay", "tlev", "tsfc"))
    ncol = play.shape[0]
    mu0, day = sun(a)
    with jconfig_override(dtype=jdt):
        props, src = jlut.gas_optics_lw_lut(jkd["lw"], play, plev, tlay, tsfc, gc, tlev=tlev,
                                            top_at_1=top_at_1)
        emis = jnp.broadcast_to(j(a["sfc_emis"])[:, None], (ncol, jkd["lw"].nband))
        jl = jrte_lw(props, top_at_1, src, emis, broadband=True)
        props, _ = jlut.gas_optics_sw_lut(jkd["sw"], play, plev, tlay, gc)
        solar = jkd["sw"].solar_source()
        toa = solar[None, :] * (j(a["tsi"]) / solar.sum())[:, None]
        alb = jnp.broadcast_to(j(a["sfc_alb"])[:, None], toa.shape)
        js = jrte_sw(props, top_at_1, j(np.where(day, mu0, 1.0)), toa, alb, alb,
                     broadband=True)
    f64 = dtype_name == "float64"
    lw_atol = lambda want: F64_LW_REL * float(np.abs(want).max()) if f64 else F32_LW_ATOL
    sw_tol = dict(rtol=0, atol=F64_SW_ATOL if f64 else F32_SW_ATOL)
    for got, want in ((lw.flux_up, jl.flux_up), (lw.flux_dn, jl.flux_dn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=lw_atol(np.asarray(want)))
    for got, want in ((sw.flux_up, js.flux_up), (sw.flux_dn, js.flux_dn),
                      (sw.flux_dn_dir, js.flux_dn_dir)):
        want = np.where(day[:, None], np.asarray(want), 0.0)
        np.testing.assert_allclose(got.numpy(), want, **sw_tol)


def test_gases_the_kdist_does_not_name_are_not_read(files):
    a = rfmip_arrays(True)
    assert set(a["gases"]) > set(T.LUT_GASES)
    kd = kdists(files, "float64")
    lw, sw = driver(a, kd)
    a["gases"] = {g: v * 7.0 if g not in T.LUT_GASES else v for g, v in a["gases"].items()}
    lw2, sw2 = driver(a, kd)
    for x, y in ((lw.flux_up, lw2.flux_up), (sw.flux_dn, sw2.flux_dn)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def nets():
    return {"lw": [load_model_netcdf(LW_MODEL, device=CPU)],
            "sw": 2 * [load_model_netcdf(SW_MODEL, device=CPU)]}


_REFUSALS = {
    "lw_nets_and_kdist": ("lw", lambda kd, n: [kd["lw"]] + n["lw"], {}, ValueError,
                          "takes nets or a k-distribution, not both"),
    "sw_nets_and_kdist": ("sw", lambda kd, n: [n["sw"][0], kd["sw"]], {}, ValueError,
                          "takes nets or a k-distribution, not both"),
    "sw_kdist_to_lw": ("lw", lambda kd, n: kd["sw"], {}, ValueError,
                       "an SW k-distribution (42 g-points) handed to the LW driver"),
    "lw_kdist_to_sw": ("sw", lambda kd, n: kd["lw"], {}, ValueError,
                       "an LW k-distribution (48 g-points) handed to the SW driver"),
    "float64_on_cuda": ("lw", lambda kd, n: kd["lw"], dict(dtype=torch.float64, device="cuda"),
                        NotImplementedError, "torch.float64 runs only on the CPU"),
    "tables_elsewhere": ("sw", lambda kd, n: kd["sw"], dict(device="cuda"), ValueError,
                         "the k-distribution's tables are torch.float32 on cpu, the call "
                         "torch.float32 on cuda"),
    "dtype_mismatch": ("lw", lambda kd, n: kd["lw"], dict(dtype=torch.float64), ValueError,
                       "the k-distribution's tables are torch.float32 on cpu, the call "
                       "torch.float64 on cpu"),
    "planck_table": ("lw", lambda kd, n: kd["lw"],
                     dict(planck_table=PlanckTable.compute(lw_spectral_g256().band_lims_wvn_array,
                                                           device=CPU)),
                     ValueError, "planck_table cannot be given with it"),
    "spectral": ("lw", lambda kd, n: kd["lw"], dict(spectral=lw_spectral_g256()), ValueError,
                 "spectral cannot be given with it"),
    "solar_and_kdist": ("sw", lambda kd, n: kd["sw"],
                        dict(solar_source=np.ones(42), kdist="kd"), ValueError,
                        "solar_source, kdist cannot be given with it"),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_refusals_in_words(files, nets, case):
    """Each misfit is refused in words by the check, before any tensor is
    made (the CUDA cases run here, with no card)."""
    band, models, kw, err, words = _REFUSALS[case]
    kd = kdists(files, "float32")
    data = rfmip_data_from_arrays(rfmip_arrays(True))
    kw = {"device": CPU, **kw}
    drv = prfmip.rfmip_clear_sky_lw if band == "lw" else prfmip.rfmip_clear_sky_sw
    with pytest.raises(err, match=words.replace("(", r"\(").replace(")", r"\)")):
        drv(data, models(kd, nets), **kw)


def test_a_gas_the_data_lacks_is_refused(files):
    a = rfmip_arrays(True)
    del a["gases"]["n2o"]
    with pytest.raises(ValueError, match=r"the k-distribution's gases \['n2o'\] are not in"):
        driver(a, kdists(files, "float64"))


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_the_nets_dispatch_as_before(nets, monkeypatch, band):
    """With nets the drivers take their route from resolve_use_megakernel
    (through config.driver_route), called once with the same arguments as
    before; with a k-distribution they do not ask it."""
    seen = []
    real = pconfig.resolve_use_megakernel
    monkeypatch.setattr(pconfig, "resolve_use_megakernel",
                        lambda **kw: seen.append(kw) or real(**kw))
    data = rfmip_data_from_arrays(T.synthesize_rfmip(5, 6, seed=3))
    if band == "lw":
        prfmip.rfmip_clear_sky_lw(data, nets["lw"], device=CPU)
        want = dict(lw=True, models=nets["lw"], device=CPU, dtype=torch.float32,
                    n_gauss_angles=1, scan_mode="sequential")
    else:
        prfmip.rfmip_clear_sky_sw(data, nets["sw"], device=CPU)
        want = dict(models=nets["sw"], device=CPU, dtype=torch.float32, scan_mode="sequential")
    assert seen == [want]
    assert prfmip.lut_kdist("x", band, nets[band], data, CPU, torch.float32) is None


def test_the_nets_route_is_taken_before_the_lut_check(nets):
    """A misfit net is still refused by the nets' own check, in its words."""
    data = rfmip_data_from_arrays(T.synthesize_rfmip(5, 6, seed=3))
    with pytest.raises(ValueError, match="rfmip_clear_sky_sw takes the g-112 SW nets"):
        prfmip.rfmip_clear_sky_sw(data, nets["lw"] * 2, device=CPU)


def _spans(fn, tmp_path) -> dict:
    """{span name: count} of the ``rte.*`` spans of fn()."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(
                "rte."):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_the_lut_stages_carry_spans(files, tmp_path):
    kd = kdists(files, "float32")
    data = rfmip_data_from_arrays(rfmip_arrays(True))
    lw = _spans(lambda: prfmip.rfmip_clear_sky_lw(data, kd["lw"], device=CPU), tmp_path)
    sw = _spans(lambda: prfmip.rfmip_clear_sky_sw(data, kd["sw"], device=CPU), tmp_path)
    lut = {"rte.lut.interp": 1, "rte.lut.optics": 1, "rte.lut.major": 1, "rte.lut.minor": 1}
    assert lw == {"rte.rfmip.lw": 1, "rte.check": 1, "rte.h2d": 1, **lut, "rte.lut.planck": 1,
                  "rte.solve.lw": 1}
    assert sw == {"rte.rfmip.sw": 1, "rte.check": 1, "rte.solar": 1, "rte.canon": 1,
                  "rte.h2d": 1, **lut, "rte.lut.rayleigh": 1, "rte.solve.sw": 1}


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_route_off_the_cpu_launches_its_kernels_once(files, monkeypatch, band):
    """Off the CPU the LUT route is one launch of K10 (the gas optics) and
    one of the solver, K7 for LW and K11 for SW, and never a kernel's plain
    twin. Meta tensors (shapes without data) stand in for the card."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lut_gas_optics as k10
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_2stream as k11

    meta = torch.device("meta")
    launched = []

    def k10_launch(mode, kd, play, tlay, col_gas):
        launched.append(f"k10.{mode}")
        return [torch.empty(tuple(play.shape) + (kd.ngpt,), device=play.device)] * 2

    def solver_launch(name, n_out):
        def launch(tau, *args):
            launched.append(name)
            return [torch.empty((tau.shape[0], tau.shape[1] + 1), device=tau.device)] * n_out
        return launch

    def twin(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran off the CPU")

    monkeypatch.setattr(k10, "_launch", k10_launch)
    monkeypatch.setattr(k7, "_launch", solver_launch("k7", 2))
    monkeypatch.setattr(k11, "_launch", solver_launch("k11", 3))
    for mod, name in ((k7, "lw_noscat_broadband_plain"), (k10, "lut_optics_lw_plain"),
                      (k10, "lut_optics_sw_plain")):
        monkeypatch.setattr(mod, name, twin)
    kd = load_kdist(files[band], T.LUT_GASES, torch.float32, device=meta)
    data = rfmip_data_from_arrays(rfmip_arrays(True))
    drv = prfmip.rfmip_clear_sky_lw if band == "lw" else prfmip.rfmip_clear_sky_sw
    fb = drv(data, kd, device=meta)
    assert launched == [f"k10.{band}", "k7" if band == "lw" else "k11"]
    assert tuple(fb.flux_dn.shape) == (NEXP * NSITES, NLAY + 1)


def test_kernel_tables_hold_the_minor_intervals(files):
    """KDist.kernel_tables: one int32 row a minor interval, the lower
    atmosphere's first, as K10 reads them, and contiguous tables."""
    kd = kdists(files, "float32")["lw"]
    t = kd.kernel_tables
    rows = t["minor"].tolist()
    want = []
    for upper, m in enumerate((kd.minor_lower, kd.minor_upper)):
        for i, (s, e) in enumerate(m.limits_gpt):
            flags = int(m.scales_with_density[i]) + 2 * int(m.scale_by_complement[i])
            want.append([upper, s, e, m.kminor_start[i], kd.gpoint_flavor[s][upper],
                         m.idx_minor[i], m.idx_minor_scaling[i], flags])
    assert rows == want and len(rows) == 3
    assert t["gflav"].tolist() == [list(f) for f in kd.gpoint_flavor]
    assert t["flavor"].dtype == torch.int32 and t["flavor"].tolist() == [list(f) for f in kd.flavor]
    assert all(v.is_contiguous() for v in t.values())
    assert torch.equal(t["vmr_ref"], kd.vmr_ref) and not kd.vmr_ref.is_contiguous()


@pytest.mark.parametrize("top_at_1", [True, False])
def test_k11_twin_is_the_solver(top_at_1):
    """K11's plain twin equals rte_sw's broadband two-stream solve on the
    CPU bit for bit, both orientations, with scattering and diffuse light
    at the top."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_2stream as k11
    from rte_rrtmgp_nn_tpu_torch.ops.sw_solver import sw_solver_2stream

    gen = torch.Generator().manual_seed(81)
    u = lambda *shape: torch.rand(*shape, generator=gen)
    n, nlay, ngpt = 5, 7, 9
    args = (2.0 * u(n, nlay, ngpt), u(n, nlay, ngpt), 0.9 * u(n, nlay, ngpt),
            0.1 + 0.9 * u(n), u(n, ngpt), u(n, ngpt), u(n, ngpt), u(n, ngpt))
    got = k11.sw_2stream_broadband_kernel(*args, top_at_1=top_at_1)
    want = sw_solver_2stream(*args, top_at_1=top_at_1, broadband=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
