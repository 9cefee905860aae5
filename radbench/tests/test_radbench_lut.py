"""The ``lut-clearsky.c1800`` cell on the CPU at a tiny size (2 g-points a
band, 8 columns, 2 input states), past the look for a card: a sound run is
``correct``; with a part of the gas optics or of the answer broken
underneath, where the answer is produced, it is not; the control fails a
limit; and the cell's work counts match a count by hand."""
import pytest
import torch

from radbench import control, counts_lut, harness
from radbench.reference import lut as L

CPU = torch.device("cpu")
NAME = "lut-clearsky.c1800"
TINY = {"config": {"gpts_per_band": 2},
        "workload": {"experiments": 2, "sites": 4, "states": 2}}
SEED = 2**31 + 23


def run():
    return harness.run_cell(NAME, SEED, 0.2, False, CPU, 0.0, overrides=TINY)


def half_left_out(fn):
    """fn with the second half of the columns of the fluxes it returns set
    to 0."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name in ("flux_up", "flux_dn"):
            v = getattr(out, name)
            v[v.shape[0] // 2:] = 0.0
        return out
    return wrapped


def test_sound_run_is_correct():
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"columns_per_s", "call_ms_p95", "setup_s"}


def _minors_left_out(monkeypatch):
    """The minor absorbers left out of the program, on files whose minor
    coefficients are 1000 times the generator's: the generator's own move
    the LW fluxes by 1-2e-3 W/m2 at most, which no limit above the
    program's float32 reading can tell apart (PERF.md, Open questions)."""
    from scipy.io import netcdf_file

    from rte_rrtmgp_nn_tpu_torch.gasoptics import synthetic
    from rte_rrtmgp_nn_tpu_torch.ops import gas_optics_lut

    generate = synthetic.generate_kdist_nc

    def strong_minors(path, **kw):
        generate(path, **kw)
        with netcdf_file(path, "a", mmap=False) as f:
            for side in ("lower", "upper"):
                v = f.variables[f"kminor_{side}"]
                v[:] = v[:] * 1000.0

    monkeypatch.setattr(synthetic, "generate_kdist_nc", strong_minors)
    assert run()["correct"]  # the program with its minors holds them
    monkeypatch.setattr(gas_optics_lut, "tau_minor_one_atmos", lambda *a: a[-1])


def _rayleigh_left_out(monkeypatch):
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lut_gas_optics

    fn = lut_gas_optics.compute_tau_rayleigh
    monkeypatch.setattr(lut_gas_optics, "compute_tau_rayleigh",
                        lambda *a, **k: torch.zeros_like(fn(*a, **k)))


def _half_the_columns_left_out(monkeypatch):
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip

    monkeypatch.setattr(rfmip, "rfmip_clear_sky_sw", half_left_out(rfmip.rfmip_clear_sky_sw))


def _stale_answer(monkeypatch):
    """Each call answers with the call before it: the window's first call
    (state 0) gets the warm-up's last (state 1), however short the window."""
    from radbench.entries import lut as entry

    last = {}
    call = entry.Cell.call

    def previous(self, k):
        out = call(self, k)
        before = last.get("out", out)
        last["out"] = out
        return before

    monkeypatch.setattr(entry.Cell, "call", previous)


@pytest.mark.parametrize("fault,number", [
    (_minors_left_out, "lw_flux"), (_rayleigh_left_out, "sw_flux"),
    (_half_the_columns_left_out, "sw_flux"), (_stale_answer, "lw_flux")])
def test_fault_is_caught(monkeypatch, fault, number):
    fault(monkeypatch)
    r = run()
    assert not r["correct"]
    assert r["check"][number]["value"] > r["check"][number]["limit"]


def test_the_control_fails_a_limit():
    worst = control.readings(NAME, [], [SEED], CPU, overrides=TINY, out=lambda s: None)
    limits = harness.find_cell(NAME)[2]["limits"]
    assert any(worst["control"][c] > limits[c] for c in limits)


def test_counts_match_a_count_by_hand(tmp_path):
    """One column of two layers, one in each atmosphere, on the tiny LW
    file: 16 bands x 2 g-points, 5 gases (6 columns with dry air), 6
    flavors, minor intervals of 4 g-points below and 2 above."""
    from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc

    path = str(tmp_path / "lw.nc")
    generate_kdist_nc(path, kind="lw", gases=("h2o", "co2", "o3", "n2o", "ch4"),
                      gpts_per_band=2, seed=3)
    kd = L.read_kdist(path)
    assert (kd.ngpt, counts_lut.nflavors(kd)) == (32, 6)
    flops, nbytes = counts_lut.lw_gas_work(kd, 1, 2, upper_rows=1)
    # 2 rows x 32 g-points x (44 major + 36 fraction + 1 layer source)
    # + 3 levels x 32 level sources + 3 x 32 surface terms
    # + 10 x (4 + 2) minor elements + 2 rows x (13 + 14 x 6 flavors)
    assert flops == 2 * 32 * 81 + 3 * 32 + 3 * 32 + 10 * 6 + 2 * 97 == 5630
    # floats: play, tlay and 5 VMRs a row; plev, tlev; tsfc; kmajor and the
    # Planck fraction 14 x 60 x 9 x 32 each, vmr_ref 2 x 6 x 14, kminor
    # 14 x 9 x (4 + 2), totplnk 196 x 16; tau and the layer source 2 x 64,
    # the level source 96, the surface source and its derivative 64
    floats = 14 + 6 + 1 + 2 * 241920 + 168 + 756 + 3136 + 128 + 96 + 64
    assert nbytes == 4.0 * floats
    flops, _ = counts_lut.lw_rte_work(32, 16, 1, 2)
    assert flops == 40 * 2 * 32
