"""On the card: a short run of each cell's timed path at reduced traffic
comes out correct, and the TF32 control of the output check does not.

    python -m pytest -m cuda radbench/tests
"""
import pytest

from radbench import harness
from radbench.reference import physics as P

SMALL = {
    "rfmip-clearsky.c1800": {"workload": {"states": 2}},
    "gcm-allsky-025deg.step": {"config": {"columns": 14_400},
                               "workload": {"block_columns": 4800, "states": 2}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_short_run_is_correct_and_the_control_is_not(cuda_device, name):
    r = harness.run_cell(name, 2**31 + 99, 1.0, False, cuda_device, 0.0, overrides=SMALL[name])
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]["columns_per_s"]["value"] > 0
    _, config, workload, _ = harness.find_cell(name)
    config = {**config, **SMALL[name].get("config", {})}
    workload = {**workload, **SMALL[name].get("workload", {})}
    cell = harness.entry_module(config).setup(config, workload, 5, cuda_device, harness.ROOT)
    cell.free_program()
    ctrl = harness.check(cell, [(k, cell.reference(k, P.CONTROL, cuda_device), 0, 0)
                                for k in range(cell.n_states)], workload["limits"], cuda_device)
    assert any(v["value"] > v["limit"] for v in ctrl.values()), ctrl
