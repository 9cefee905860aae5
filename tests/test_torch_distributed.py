"""The port's parallel/distributed.py and the process-group form of the
mesh, on two gloo ranks on the CPU (parallel.distributed.launch), against
the JAX package's parallel/distributed.py and the one-process forms.

initialize is a no-op without a coordinator and refuses a world it cannot
make; local_column_slice splits as the JAX function; the all_reduce flux
statistics and eval metrics of two ranks equal the one-process mesh's over
two devices (the same float32 partial sums, added in the same order for two
parts); a g-point split of the broadband LW solve over 'gpt' with the sum
by all_reduce matches the unsplit solve (the port of test_sharding's
g-point-sharded test, rtol 2e-6).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_rank_workers as W
from rte_rrtmgp_nn_tpu.parallel import distributed as jdist
from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_solver_noscat
from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist
from rte_rrtmgp_nn_tpu_torch.parallel import shard_ops as pso
from rte_rrtmgp_nn_tpu_torch.parallel.sharding import make_mesh
from test_torch_shard_ops import _fields

MESH2 = make_mesh(devices=["cpu", "cpu"])


@pytest.fixture(scope="module")
def stats_inputs():
    r = np.random.default_rng(7)
    x = r.normal(100.0, 20.0, (33, 13)).astype(np.float32)
    y = x + r.normal(0.0, 0.5, x.shape).astype(np.float32)
    return x, y, _fields(11, nsites=17, top_at_1=True)


@pytest.fixture(scope="module")
def ranks(stats_inputs):
    x, y, fields = stats_inputs
    return pdist.launch(W.mesh_and_stats, 2, x, y, fields, True, device="cpu")


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    pdist.initialize()
    pdist.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert pdist.local_column_slice(11) == (0, 11)


@pytest.mark.parametrize("kw", [dict(num_processes=2),
                                dict(num_processes=2, coordinator_address="127.0.0.1:1"),
                                dict(coordinator_address="127.0.0.1:1")])
def test_initialize_refuses_a_half_made_world(monkeypatch, kw):
    """Asked for more than one process (or given a coordinator alone) and
    unable to make the world, it raises: one process would compute a
    fraction of the problem."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs"):
        pdist.initialize(**kw, device="cpu")
    assert not torch.distributed.is_initialized()


def test_rank_device_never_falls_back_to_the_cpu():
    assert pdist.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.rank_device()


def test_launch_leaves_no_process_behind():
    """The server the ranks fork from is stopped and reaped when the
    launching process exits: its pid is gone the moment that process is."""
    code = ("import os; from multiprocessing import forkserver; "
            "from rte_rrtmgp_nn_tpu_torch.parallel import distributed as d; "
            "print(d.launch(os.getpid, 2, device='cpu'), forkserver._forkserver._forkserver_pid)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=root, check=True)
    server = int(out.stdout.split()[-1])
    with pytest.raises(ProcessLookupError):
        os.kill(server, 0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="states what happens without a card")
def test_initialize_defaults_to_the_card():
    """Without ``device`` a rank goes to its card: on a host without one,
    initialize raises before it makes any process group."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.initialize(f"127.0.0.1:{pdist.free_port()}", 1, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("ncol", [11, 12, 1])
def test_local_column_slice_matches_jax(monkeypatch, ranks, ncol):
    """Each rank's slice as the JAX function gives it on that process (the
    last one takes the remainder)."""
    for p in range(2):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        ref = jdist.local_column_slice(ncol)
        if ncol == 11:
            assert ranks[p]["slice"] == ref
        assert ref[1] == (ncol // 2 if p == 0 else ncol - ncol // 2)


def test_global_mesh_and_the_split_over_ranks(ranks):
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["mesh"] == {"col": 2, "gpt": 1}
        assert out["gpt_shape"] == {"col": 1, "gpt": 2}
        assert "needs 3 ranks" in out["refused"]
    # ceil shares, as the one-process split and JAX's NamedSharding
    assert [o["split"] for o in ranks] == [(0, 17), (17, 16)]
    tau = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    np.testing.assert_array_equal(ranks[0]["tau_block"], tau[..., :3])
    np.testing.assert_array_equal(ranks[1]["tau_block"], tau[..., 3:])
    assert ranks[0]["s"] == ranks[1]["s"] == 2.0


@pytest.mark.parametrize("what", ["stats", "errs", "metrics"])
def test_all_reduce_stats_equal_the_one_process_mesh(ranks, stats_inputs, what):
    x, y, fields = stats_inputs
    ref = {"stats": lambda: [float(v) for v in pso.flux_stats(MESH2, torch.as_tensor(x))],
           "errs": lambda: [float(v) for v in pso.weighted_error_stats(
               MESH2, torch.as_tensor(y), torch.as_tensor(x))],
           "metrics": lambda: pso.rfmip_eval_metrics_sharded(
               MESH2, *map(torch.as_tensor, fields), top_at_1=True).numpy()}[what]()
    for out in ranks:
        np.testing.assert_allclose(out[what], ref, rtol=1e-6, atol=1e-7)


def test_gpt_axis_split_matches_unsplit():
    """The port of test_sharding's g-point-sharded test: the broadband solve
    on each rank's 32 of 64 g-points, summed by all_reduce over 'gpt'."""
    rng = np.random.default_rng(0)
    ncol, nlay, ngpt = 8, 10, 64
    u = lambda *s, lo=0.5: rng.uniform(lo, 1.0, s).astype(np.float32)
    args = (u(ncol, nlay, ngpt, lo=0.05), u(ncol, nlay, ngpt), u(ncol, nlay + 1, ngpt),
            np.ones((ncol, ngpt), np.float32), np.ones((ncol, ngpt), np.float32))
    ref = lw_solver_noscat(*map(torch.as_tensor, args), broadband=True)
    for up, dn in pdist.launch(W.gpt_split_solve, 2, *args, device="cpu"):
        np.testing.assert_allclose(up, ref.flux_up.numpy(), rtol=2e-6)
        np.testing.assert_allclose(dn, ref.flux_dn.numpy(), rtol=2e-6)
