"""The port's named spans (utils/timing.span) under a CPU-only
``torch.profiler``: the RFMIP drivers and the GCM all-sky sweep emit the
spans of their host stages, nested as the stages call each other, the
Planck table's and the solar source's only on a miss of their kept tables;
a kept weight split counts a miss only when it is cut anew; the outputs are
the same bits with the profiler on; and with no profiler a span makes no
profiler range at all."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked
from rte_rrtmgp_nn_tpu_torch.drivers.gcm import gcm_sweep_allsky, synthesize_gcm_columns
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import split_first_layer
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.utils import timing
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

CPU = torch.device("cpu")
SW_NET = "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc"
NCOL, NLAY, SEED = 30, 10, 11

# span -> the span it runs under (None: outermost), on the CPU's routes;
# the KEPT spans open only on a miss of their kept tables
KEPT = ("rte.planck", "rte.solar")
RFMIP_LW = {"rte.rfmip.lw": None, "rte.check": "rte.rfmip.lw", "rte.planck": "rte.rfmip.lw",
            "rte.h2d": "rte.rfmip.lw"}
RFMIP_SW = {"rte.rfmip.sw": None, "rte.check": "rte.rfmip.sw", "rte.solar": "rte.rfmip.sw",
            "rte.canon": "rte.rfmip.sw", "rte.h2d": "rte.rfmip.sw"}
SWEEP = {"rte.gcm.sweep": None, "rte.check": "rte.gcm.sweep", "rte.planck": "rte.gcm.sweep",
         "rte.solar": "rte.gcm.sweep", "rte.replicate": "rte.gcm.sweep",
         "rte.pack": "rte.gcm.sweep", "rte.stream": "rte.gcm.sweep",
         "rte.step": "rte.stream", "rte.gather": "rte.stream"}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    lw = load_model_netcdf(T.artifact_path(T.LW_NET_64), device=CPU)
    sw = load_model_netcdf(T.artifact_path(SW_NET), device=CPU)
    data = rfmip_data_from_arrays(T.synthesize_rfmip(NCOL, NLAY, SEED))
    directory = tmp_path_factory.mktemp("spans")
    co = {}
    for band, spec in (("lw", lw_spectral_g128()), ("sw", sw_spectral_g112())):
        path = str(directory / f"{band}-lut.nc")
        write_nc(path, *T.cloud_optics_nc_variables(
            T.synthesize_cloud_optics(spec, seed=SEED, flavour="lut")))
        co[band] = load_cloud_optics_checked(path, device=CPU)
    host = synthesize_gcm_columns(data, 3 * NCOL, seed=SEED)
    return {
        "lw": lambda **kw: rfmip_clear_sky_lw(data, [lw], device=CPU, **kw),
        "sw": lambda **kw: rfmip_clear_sky_sw(data, [sw, sw], device=CPU, **kw),
        "sweep": lambda: gcm_sweep_allsky(host, [lw], [sw, sw], co["lw"], co["sw"],
                                          block_size=32, device=CPU),
        "lw_model": lw,
    }


def _profiled(fn, tmp_path):
    """fn()'s result and its ``rte.*`` spans as (name, start, end), from the
    profiler's trace (its clock keeps nanoseconds)."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("rte.")]
    return out, spans


def _parents(spans) -> dict:
    """{span name: the set of names of the innermost spans around it}."""
    out, stack = {}, []
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and s >= stack[-1][2]:
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return out


def _leaves(out):
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items() if isinstance(v, np.ndarray)}
    return {k: v.numpy() for k, v in vars(out).items() if torch.is_tensor(v)}


def _assert_nesting(problem, tmp_path, path, nesting, warm: bool):
    """path's spans nest as ``nesting`` says, on a miss of the kept tables
    (cleared first) or, ``warm``, on a hit, where no KEPT span opens."""
    planck.PLANCK_TABLES.clear()
    rfmip.SOLAR_SOURCES.clear()
    if warm:
        with torch.no_grad():
            problem[path]()
        nesting = {k: v for k, v in nesting.items() if k not in KEPT}
    _, spans = _profiled(problem[path], tmp_path)
    parents = _parents(spans)
    if warm:
        assert not set(KEPT) & set(parents), parents
    for name, parent in nesting.items():
        assert parents.get(name) == {parent}, (name, parents.get(name))
    outermost = [n for n, p in parents.items() if None in p]
    assert outermost == [next(n for n, p in nesting.items() if p is None)]


NESTINGS = [("lw", RFMIP_LW), ("sw", RFMIP_SW), ("sweep", SWEEP)]


@pytest.mark.parametrize("path, nesting", NESTINGS)
def test_driver_spans_nest_as_the_stages_call(problem, tmp_path, path, nesting):
    _assert_nesting(problem, tmp_path, path, nesting, warm=False)


@pytest.mark.parametrize("path, nesting", NESTINGS)
def test_a_hit_of_the_kept_tables_opens_no_rebuild_span(problem, tmp_path, path, nesting):
    _assert_nesting(problem, tmp_path, path, nesting, warm=True)


@pytest.mark.parametrize("path", ["lw", "sw", "sweep"])
def test_outputs_are_the_same_bits_with_the_profiler_on(problem, tmp_path, path):
    with torch.no_grad():
        plain = _leaves(problem[path]())
    traced, spans = _profiled(problem[path], tmp_path)
    traced = _leaves(traced)
    assert spans and plain and set(plain) == set(traced)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)


def test_a_kept_weight_split_counts_a_miss_only_when_cut_anew(problem):
    m = problem["lw_model"]
    perm, n2d = list(range(m.dims[0]))[::-1], m.dims[0] - 2
    misses = lambda prof: sum(e.name == "rte.first_layer.miss" for e in prof.events())
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        a = split_first_layer(m, perm, n2d)
        b = split_first_layer(m, perm, n2d)
    assert misses(prof) == 1 and a is b
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        m.weights[0].mul_(1.0)
        c = split_first_layer(m, perm, n2d)
        split_first_layer(m, perm, n2d)
    assert misses(prof) == 1 and c is not a
    torch.testing.assert_close(c, a, rtol=0, atol=0)


def test_a_span_makes_no_range_while_no_profiler_records(monkeypatch):
    made = []
    real = timing.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(timing, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with timing.span("rte.probe") as s:
            assert s.name == "rte.probe"
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("rte.probe"):
            torch.ones(4).sum()
    assert made == ["rte.probe"]
    assert [e.name for e in prof.events()].count("rte.probe") == 1
    with pytest.raises(KeyError), timing.span("rte.probe"):
        raise KeyError("raised inside a span reaches the caller")
