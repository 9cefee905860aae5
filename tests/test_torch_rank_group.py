"""The port's persistent rank group (parallel.distributed.RankGroup) on two
gloo ranks on the CPU, the calling process being rank 0: each rank's GCM
all-sky sweep on its own columns equals the same sweep run in one process;
the set-up runs once a rank over many steps; every rank is bound to its own
equal share of the cores with rank 0's threads, as ``launch``'s ranks are;
a rank that raises or stalls ends the step, and the group, at once, and no
rank outlives ``close``; rank 0 opens one dispatch and one barrier span a
step. The ranks run ``tests/_torch_rank_workers.py``, which imports no
JAX."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_rank_workers as W
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128, sw_spectral_g112
from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist
from rte_rrtmgp_nn_tpu_torch.parallel.distributed import RankGroup
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

CPU = torch.device("cpu")
WIDTH = 5 + os.cpu_count()  # counting_step's row
NCOL, NLAY, BLOCK = 96, 10, 32


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def counted():
    """Three steps of a counting group: its rows, its counters, the
    caller's binding inside and after the group, the ranks' pids."""
    before = (os.sched_getaffinity(0), torch.get_num_threads())
    W.MADE.clear()
    with RankGroup(W.counting_make, W.counting_step, 2, (WIDTH,), device="cpu") as g:
        inside = (os.sched_getaffinity(0), torch.get_num_threads())
        rows = [g.step() for _ in range(3)]
        stats = g.stats()
        pids = [p.pid for p in g._procs]
    return {"rows": rows, "stats": stats, "before": before, "inside": inside,
            "after": (os.sched_getaffinity(0), torch.get_num_threads()), "pids": pids,
            "made_here": list(W.MADE)}


@pytest.fixture(scope="module")
def cloud_files(tmp_path_factory):
    directory = tmp_path_factory.mktemp("rank_group")
    paths = []
    for band, spec in (("lw", lw_spectral_g128()), ("sw", sw_spectral_g112())):
        path = str(directory / f"{band}-lut.nc")
        write_nc(path, *T.cloud_optics_nc_variables(
            T.synthesize_cloud_optics(spec, seed=5, flavour="lut")))
        paths.append(path)
    return paths


def test_each_rank_sweeps_its_own_columns_as_one_process_does(cloud_files):
    from functools import partial

    make = partial(W.gcm_make, cloud_files=cloud_files, ncol=NCOL, nlay=NLAY)
    with RankGroup(make, W.gcm_step, 2, (NCOL, 3), device="cpu") as g:
        got = [g.step(BLOCK) for _ in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    for r in range(2):
        want = W.gcm_step(make(r, CPU), BLOCK)
        assert want.shape == (NCOL, 3) and np.all(np.isfinite(want))
        np.testing.assert_array_equal(got[0][r], want)
    assert not np.array_equal(got[0][0], got[0][1])  # each rank its own columns


def test_the_set_up_runs_once_a_rank_over_many_steps(counted):
    for i, rows in enumerate(counted["rows"], 1):
        np.testing.assert_array_equal(rows[:, 0], [0, 1])  # rank order
        np.testing.assert_array_equal(rows[:, 1], [1, 1])  # one set-up a process
        np.testing.assert_array_equal(rows[:, 2], [i, i])  # the state lives on
    pids = {tuple(r[:, 3]) for r in counted["rows"]}
    assert pids == {(os.getpid(), counted["pids"][0])}  # rank 0 is the caller
    assert counted["made_here"] == [0]


def test_every_rank_takes_its_own_share_of_the_cores(counted):
    rows = counted["rows"][-1]
    threads = {int(t) for t in rows[:, 4]}
    cores = [{int(c) for c in r[5:] if c >= 0} for r in rows]
    shares = pdist.core_shares(2)
    assert [sorted(c) for c in cores] == shares
    assert threads == {min(counted["before"][1], len(shares[0]))}
    assert counted["inside"] == (set(shares[0]), threads.pop())
    assert counted["after"] == counted["before"]  # close gives the caller its binding back


def test_launch_binds_its_ranks_as_the_group_does(counted):
    got = pdist.launch(W.binding, 2, device="cpu")
    assert [c for _, c in got] == pdist.core_shares(2)
    assert {t for t, _ in got} == {int(counted["rows"][-1][0, 4])}


@pytest.mark.cuda
def test_launch_binds_its_cuda_ranks_as_the_group_does():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    got = pdist.launch(W.binding, 2)
    assert [c for _, c in got] == pdist.core_shares(2)
    assert {t for t, _ in got} == {min(torch.get_num_threads(), len(pdist.core_shares(2)[0]))}


def test_the_counters_give_each_rank_s_step_time_the_slowest_and_the_skew(counted):
    s = counted["stats"]
    ms = np.asarray(s["step_ms"])
    assert ms.shape == (3, 2) and np.all(ms > 0)
    np.testing.assert_array_equal(s["slowest_rank"], ms.argmax(axis=1))
    np.testing.assert_allclose(s["skew_ms"], ms.max(axis=1) - ms.min(axis=1))
    assert s["peak_bytes"] == [0, 0]  # no card


@pytest.mark.parametrize("case", ["raises", "stalls", "raises_in_set_up", "closes"])
def test_no_failure_hangs_the_caller_or_leaves_a_rank_behind(case):
    make = W.failing_make if case == "raises_in_set_up" else W.counting_make
    before = os.sched_getaffinity(0)
    if case == "raises_in_set_up":
        with pytest.raises(RuntimeError, match="(?s)rank 1:.*Traceback.*set-up fault planted"):
            RankGroup(make, W.counting_step, 2, (WIDTH,), device="cpu")
    else:
        g = RankGroup(make, W.counting_step, 2, (WIDTH,), device="cpu", step_timeout_s=2.0)
        g.step()
        if case == "raises":
            with pytest.raises(RuntimeError, match="(?s)rank 1:.*Traceback.*fault planted in"):
                g.step("raise")
        elif case == "stalls":
            with pytest.raises(TimeoutError, match="did not reach the barrier in 2.0 s"):
                g.step("stall")
        else:
            g.close()
        assert all(_gone(p.pid) for p in g._procs)
        with pytest.raises(RuntimeError, match="closed"):
            g.step()
    assert not torch.distributed.is_initialized()
    assert os.sched_getaffinity(0) == before


def test_rank_0_opens_one_dispatch_and_one_barrier_span_a_step(tmp_path):
    with RankGroup(W.counting_make, W.counting_step, 2, (WIDTH,), device="cpu") as g:
        g.step()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                g.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"].startswith("rte.rank.")]
    assert sorted(names) == ["rte.rank.barrier"] * 3 + ["rte.rank.dispatch"] * 3
