"""The kept tables of the port's drivers (gasoptics.planck.KeptTables): the
Planck table (``PlanckTable.kept``) and the default solar source
(``drivers.rfmip.kept_solar_source``) are made once per key and are the
same bits as the tables made anew; the drivers give the same bits on a
miss, on a hit and with a table passed; no call writes into a kept table;
a k-distribution's solar terms are still read at every call. On the CPU,
with the fixtures of test_torch_spans, which also holds the rebuild spans
to a miss."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (
    KeptTables,
    PlanckTable,
    lw_spectral_g128,
    sw_spectral_g112,
)
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from test_torch_spans import _leaves, problem  # noqa: F401 (the fixture)

CPU = torch.device("cpu")
LW_LIMS = lw_spectral_g128().band_lims_wvn_array


def clear():
    planck.PLANCK_TABLES.clear()
    rfmip.SOLAR_SOURCES.clear()


def counts(fn, calls: int) -> dict:
    """The rebuild spans that ``calls`` calls of fn open, by name."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    names = [e.name for e in prof.events()]
    return {n: names.count(n) for n in ("rte.planck", "rte.solar")}


def kept_and_fresh(kind: str, dtype):
    if kind == "planck":
        return (PlanckTable.kept(LW_LIMS, device=CPU, dtype=dtype),
                PlanckTable.compute(LW_LIMS, device=CPU, dtype=dtype))
    spec = sw_spectral_g112()
    return (rfmip.kept_solar_source(spec, device=CPU, dtype=dtype),
            torch.as_tensor(rfmip.default_solar_source(spec), dtype=dtype, device=CPU))


def assert_same_bits(a, b):
    if isinstance(a, PlanckTable):
        assert (a.temp_ref_min, a.totplnk_delta) == (b.temp_ref_min, b.totplnk_delta)
        assert_same_bits(a.totplnk, b.totplnk)
        assert_same_bits(a.totplnk_diff, b.totplnk_diff)
        return
    assert a.dtype == b.dtype and a.device == b.device
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["planck", "solar"])
def test_a_kept_table_is_the_one_made_anew(kind, dtype):
    clear()
    kept, fresh = kept_and_fresh(kind, dtype)
    assert_same_bits(kept, fresh)
    again, _ = kept_and_fresh(kind, dtype)
    assert again is kept


@pytest.mark.parametrize("other", [
    dict(band_lims_wvn=planck.LW_BAND_LIMS_WVN[:8]), dict(dtype=torch.float64),
    dict(device=torch.device("meta")), dict(t_max=330.0)])
def test_one_key_one_table(other):
    clear()
    base = dict(band_lims_wvn=LW_LIMS, device=CPU, dtype=torch.float32)
    a = PlanckTable.kept(**base)
    # the limits as another array of the same values are the same key
    assert PlanckTable.kept(**dict(base, band_lims_wvn=LW_LIMS.tolist())) is a
    b = PlanckTable.kept(**dict(base, **other))
    assert b is not a and PlanckTable.kept(**dict(base, **other)) is b
    assert PlanckTable.kept(**base) is a


def test_past_its_size_the_oldest_key_is_dropped():
    made = []
    kept = KeptTables("rte.probe", size=2)
    get = lambda key: kept.get(key, lambda: made.append(key) or [key])
    first = get("a")
    get("b")
    assert get("a") is first and made == ["a", "b"]
    get("c")
    assert made == ["a", "b", "c"] and get("b") == ["b"] and get("c") == ["c"]
    assert get("a") is not first and made[-1] == "a"
    kept.clear()
    get("c")
    assert made[-1] == "c"


@pytest.mark.parametrize("path", ["lw", "sw", "sweep"])
def test_outputs_are_the_same_bits_on_a_miss_a_hit_and_a_table_passed(problem, path):
    clear()
    with torch.no_grad():
        runs = [_leaves(problem[path]()), _leaves(problem[path]())]
        if path == "lw":
            table = PlanckTable.compute(LW_LIMS, device=CPU)
            runs.append(_leaves(problem["lw"](planck_table=table)))
        elif path == "sw":
            source = rfmip.default_solar_source(sw_spectral_g112())
            runs.append(_leaves(problem["sw"](solar_source=source)))
    assert runs[0]
    for run in runs[1:]:
        assert set(run) == set(runs[0])
        for k in run:
            np.testing.assert_array_equal(run[k], runs[0][k], err_msg=k)


def test_driver_calls_leave_the_kept_tables_unchanged(problem):
    clear()
    with torch.no_grad():
        for path in ("lw", "sw", "sweep", "lw", "sw", "sweep"):
            problem[path]()
    for kind in ("planck", "solar"):
        kept, fresh = kept_and_fresh(kind, torch.float32)
        assert_same_bits(kept, fresh)


def test_a_kdist_with_solar_terms_is_read_at_every_call(problem, tmp_path):
    """The kdist's NRLSSI2 terms are resolved at every call, under rte.solar:
    a kdist with other terms gives other fluxes, each as its resolved
    source passed; a kdist without terms reads the kept default."""
    path = str(tmp_path / "sw.nc")
    generate_kdist_nc(path, kind="sw", gpts_per_band=4, nband=14)
    kd = load_kdist(path, ["h2o", "co2", "o3", "n2o", "ch4"], device=CPU)
    other = dataclasses.replace(kd, mg_default=kd.mg_default + 0.01)
    spec = sw_spectral_g112()
    call = lambda **kw: _leaves(problem["sw"](**kw))
    clear()
    with torch.no_grad():
        assert counts(lambda: problem["sw"](kdist=kd), 2) == {"rte.planck": 0,
                                                                  "rte.solar": 2}
        with_kd, with_other = call(kdist=kd), call(kdist=other)
        for kdist, out in ((kd, with_kd), (other, with_other)):
            passed = call(solar_source=rfmip.resolve_solar_source(spec, kdist))
            for k in out:
                np.testing.assert_array_equal(out[k], passed[k], err_msg=k)
        assert np.abs(with_kd["flux_dn"] - with_other["flux_dn"]).max() > 0
        no_terms = dataclasses.replace(kd, solar_quiet=None)
        assert counts(lambda: problem["sw"](kdist=no_terms), 2)["rte.solar"] == 1
