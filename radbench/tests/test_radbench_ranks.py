"""The four-rank GCM cell (``entries/gcm_ranks.py``) on two CPU ranks at a
tiny size: a sound run is correct against the plain reference; a fault in
rank 1's output alone turns ``correct`` false, so the check covers every
rank's columns; ``barrier_wait_ms_per_call`` reads rank 0's barrier spans;
the device report counts every rank's card; the cell and its
configuration are found by name."""
import json
import os

import pytest
import torch

from radbench import harness
from radbench.entries import gcm_ranks
from radbench.trace import TraceWindow

CELL = "gcm-allsky-025deg-4rank.step"
STEP = gcm_ranks.rank_step
TINY = {"config": {"ranks": 2, "columns": 48}, "workload": {"block_columns": 32, "states": 2}}


def run():
    return harness.run_cell(CELL, 2**31 + 23, 0.2, False, torch.device("cpu"), 0.0,
                            overrides=TINY)


def rank_1_off(share, k):
    """A rank's step with 1 W/m2 more OLR in every column of rank 1."""
    out = STEP(share, k)
    if share.rank == 1:
        out[:, 0] += 1.0
    return out


def test_sound_run_is_correct_over_every_rank():
    before = harness.device_kind
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["check"]
    assert list(r)[-1] == "check"
    assert r["device"]["count"] == 0 and harness.device_kind is before


@pytest.mark.parametrize("cards,count", [((0, 1, 2, 3), 4), ((0, 0), 1), ((), 0)])
def test_the_device_report_counts_every_rank_s_card(cards, count):
    gpu = lambda d: {"platform": "gpu", "kind": "card", "count": 1}
    devices = [torch.device("cuda", i) for i in cards] + [torch.device("cpu")]
    assert gcm_ranks.counting_cards(gpu, devices)("cuda:0") == {
        "platform": "gpu", "kind": "card", "count": count}
    assert gcm_ranks.counting_cards(harness.device_kind, devices)("cpu") == \
        harness.device_kind("cpu")


def test_a_fault_in_rank_1_alone_is_caught(monkeypatch):
    monkeypatch.setattr(gcm_ranks, "rank_step", rank_1_off)
    r = run()
    assert not r["correct"] and r["check"]["olr"]["value"] > r["check"]["olr"]["limit"]
    assert r["check"]["lw_sfc_dn"]["value"] <= r["check"]["lw_sfc_dn"]["limit"]


def ev(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "pid": 1, "tid": 1}


def test_barrier_wait_reads_rank_0_s_barrier_spans():
    read = harness.metric_reader("barrier_wait_ms_per_call")
    calls = [ev("radbench.call", 0, 1000), ev("radbench.call", 1000, 2000)]
    spans = [ev("rte.rank.dispatch", 10, 20), ev("rte.rank.barrier", 900, 990),
             ev("rte.rank.dispatch", 1010, 1020), ev("rte.rank.barrier", 1700, 1990),
             ev("rte.wait", 100, 400)]
    assert read(TraceWindow(calls + spans, {})) == pytest.approx((90 + 290) * 1e-3 / 2)
    assert read(TraceWindow(calls + spans[:1] + spans[-1:], {})) is None


def test_the_cell_and_its_configuration_are_found_by_name():
    cell, config, workload, manifest = harness.find_cell(CELL)
    (entry,) = [c for c in manifest["configs"] if c["name"] == cell["config"]]
    assert entry["file"] == f"radbench/configs/{config['name']}.json"
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        assert json.load(f)["reduced"] == entry["reduced"] == ["hosts"]
    assert workload["name"] == CELL and workload["traffic"] == cell["traffic"]
    assert harness.entry_module(config) is gcm_ranks
    assert set(workload["limits"]) == set(gcm_ranks.Cell.CHECKS)
    assert cell["chips"] == config["ranks"] == config["cards_per_host"] == 4
    assert config["columns"] * config["cards"] == config["grid_columns"]
    (metric,) = [m for m in manifest["per_layer"] if m["name"] == "barrier_wait_ms_per_call"]
    assert metric["workloads"] == [CELL] and metric["layer"] == "ranks"
