"""A run of each cell on the CPU at a tiny size, past the look for a card:
sound, ``correct`` is true; with the timed path broken underneath, where
the answer is produced, it is false."""
import pytest
import torch

from radbench import harness

CPU = torch.device("cpu")
TINY = {
    "rfmip-clearsky.c1800": {"workload": {"experiments": 2, "sites": 4, "states": 2}},
    "gcm-allsky-025deg.step": {"config": {"columns": 48},
                               "workload": {"block_columns": 32, "states": 2}},
}


def run(name):
    return harness.run_cell(name, 2**31 + 17, 0.2, False, CPU, 0.0, overrides=TINY[name])


def altered(fn, change):
    """fn with ``change`` applied to the broadband fluxes it returns (a
    named tuple or a dataclass of (ncol, nlay+1) tensors)."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        fields = out._asdict() if hasattr(out, "_asdict") else vars(out)
        return type(out)(**{k: change(v) if torch.is_tensor(v) and v.ndim == 2 else v
                            for k, v in fields.items()})
    return wrapped


def surface_altered(v):
    """1 W/m2 more at the lowest level of every column (night SW columns
    are masked after the solver, so not one column alone)."""
    v = v.clone()
    v[:, -1] += 1.0
    return v


def half_left_out(v):
    v = v.clone()
    v[v.shape[0] // 2:] = 0.0
    return v


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("change", [surface_altered, half_left_out])
def test_rfmip_fault_is_caught(monkeypatch, change):
    from rte_rrtmgp_nn_tpu_torch.drivers import rfmip

    monkeypatch.setattr(rfmip, "rte_lw", altered(rfmip.rte_lw, change))
    r = run("rfmip-clearsky.c1800")
    assert not r["correct"] and r["check"]["lw_flux"]["value"] > r["check"]["lw_flux"]["limit"]


def test_rfmip_stale_answer_is_caught(monkeypatch):
    from radbench.entries import rfmip as entry

    first = {}
    call = entry.Cell.call

    def stale(self, k):
        return first.setdefault("out", call(self, k))

    monkeypatch.setattr(entry.Cell, "call", stale)
    assert not run("rfmip-clearsky.c1800")["correct"]


@pytest.mark.parametrize("change", [surface_altered, half_left_out])
def test_gcm_fault_is_caught(monkeypatch, change):
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm

    monkeypatch.setattr(gcm, "_allsky_sw_core_lay_major",
                        altered(gcm._allsky_sw_core_lay_major, change))
    r = run("gcm-allsky-025deg.step")
    assert not r["correct"] and r["check"]["sw_sfc_dn"]["value"] > r["check"]["sw_sfc_dn"]["limit"]


def test_a_failing_call_is_counted(monkeypatch):
    from radbench.entries import rfmip as entry

    def broken(self, k):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(entry.Cell, "call", broken)
    r = run("rfmip-clearsky.c1800")
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1


def test_call_ms_p95_is_the_tail_of_every_call():
    """Two stalled calls in twenty, 230 ms against 30 ms, are the tail
    (a mean over groups of calls would read them as a few ms more)."""
    calls = [(0, {}, 0.0, 0.030)] * 18 + [(0, {}, 0.0, 0.230)] * 2
    assert harness.p95_ms(calls) == pytest.approx(230.0)
    assert harness.p95_ms(calls[:18]) == pytest.approx(30.0)
