"""The port's single-process parallel package against the JAX package:
block iteration, streaming and its reduction on the CPU, the order in which
blocks are staged and run, the staging slot's fill by the process's copy
threads (against the fill on one thread, in a forked process too), the column split
over a device mesh (its shares against the JAX sharding's on the suite's 8
virtual CPU devices), replication, padding; the GCM sweeps on a two-device
CPU mesh against no mesh; and the g-point split, which the port refuses in
words."""
import multiprocessing
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rte_rrtmgp_nn_tpu.parallel import sharding as jsh
from rte_rrtmgp_nn_tpu.parallel import streaming as jst
from rte_rrtmgp_nn_tpu_torch.drivers import gcm as pgcm
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.parallel import sharding as psh
from rte_rrtmgp_nn_tpu_torch.parallel import streaming as pst
from test_torch_core import CPU, LW_MODEL, SW_MODEL

CPU2 = ["cpu", "cpu"]
GPT_WORDS = "needs a collective for the broadband sum"


@pytest.mark.parametrize("ncol,block", [(10, 3), (9, 3), (5, 8), (0, 4)])
def test_iter_blocks_matches_jax(ncol, block):
    assert list(pst.iter_blocks(ncol, block)) == list(jst.iter_blocks(ncol, block))


def _host_arrays(ncol=23):
    rng = np.random.default_rng(7)
    return [rng.uniform(0, 1, (ncol, 4)).astype(np.float32),
            rng.uniform(0, 1, ncol).astype(np.float32)]


def _fn(a, b):
    return a[:, 1] * 2.0 + b, a[:, :2] - 1.0


@pytest.mark.parametrize("mesh", [None, 1, 2], ids=["device", "mesh1", "mesh2"])
def test_stream_blocks_matches_jax(mesh):
    """The same (start, size) triples and results; the port runs the last
    block at its own size, the JAX package pads it, so its results are cut
    to the block's columns."""
    arrays = _host_arrays()
    kw = (dict(device=CPU) if mesh is None
          else dict(sharding=psh.column_sharding(psh.make_mesh(devices=["cpu"] * mesh), 2)))
    got = list(pst.stream_blocks(_fn, arrays, 8, **kw))
    ref = list(jst.stream_blocks(jax.jit(_fn), arrays, 8))
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref] == [(0, 8), (8, 8), (16, 7)]
    for (_, n, g), (_, _, r) in zip(got, ref):
        for gi, ri in zip(g, r):
            assert gi.shape[0] == n
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri)[:n])


def test_stream_reduce_matches_jax():
    arrays = _host_arrays()
    builder = lambda n: [np.zeros(n, np.float32), np.zeros((n, 2), np.float32)]
    got = pst.stream_reduce(_fn, arrays, 5, builder, device=CPU)
    ref = jst.stream_reduce(jax.jit(_fn), arrays, 5, builder)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="needs a device or a sharding"):
        list(pst.stream_blocks(_fn, arrays, 5))


@pytest.mark.parametrize("n", [37, 64], ids=["ragged", "full"])
def test_slot_layout_holds_each_array_of_a_block_bit_for_bit(n):
    """A block of mixed column-leading arrays, written through _slot_layout's
    views into a flat byte buffer as the CUDA staging slot takes it, reads
    back bit for bit; every region starts on a multiple of 256 bytes, none
    overlaps the next, and none passes the end of a slot sized for a full
    block of 64 rows."""
    rng = np.random.default_rng(11)
    ncol, rows = 150, 64
    arrays = [rng.standard_normal((ncol, 60)).astype(np.float32),
              rng.standard_normal(ncol).astype(np.float32),
              rng.standard_normal((ncol, 61)).astype(np.float32),
              rng.integers(-2 ** 15, 2 ** 15, (ncol, 7)).astype(np.int16)]
    buf = np.zeros(pst._slot_bytes(pst._slot_layout(arrays, rows)), np.uint8)
    parts = [a[ncol - n:] for a in arrays]  # the sweep's last block
    layout = pst._slot_layout(parts, n)
    for region, a in zip(pst._slot_views(torch.from_numpy(buf), layout), parts):
        np.copyto(region.numpy(), a)
    ends = []
    for (offset, shape, dtype), a in zip(layout, parts):
        assert offset % 256 == 0 and shape == a.shape and dtype == a.dtype
        ends.append(offset + a.nbytes)
        got = buf[offset:ends[-1]].view(dtype).reshape(shape)
        np.testing.assert_array_equal(got.view(np.uint8), a.view(np.uint8))
    assert all(end <= offset for end, (offset, _, _) in zip(ends, layout[1:]))
    assert ends[-1] == pst._slot_bytes(layout) <= buf.size


@pytest.mark.parametrize("mesh", [None, 2], ids=["device", "mesh2"])
def test_stream_blocks_runs_each_block_as_soon_as_it_is_staged(monkeypatch, mesh):
    """Block 0 is staged and run at once; block k+1 is staged only after the
    caller has received block k's result, so no more than two blocks are
    held at a time: the one that ran and the one staged."""
    log = []

    class Recording(pst._HostStager):
        def stage(self, parts):
            log.append(("stage", int(parts[0][0, 0])))
            super().stage(parts)

        def run(self, fn):
            log.append(("run", int(self.staged[0][0][0, 0])))
            return super().run(fn)

    monkeypatch.setattr(pst, "_HostStager", Recording)
    arrays = _host_arrays()
    arrays[0][:, 0] = np.arange(arrays[0].shape[0])  # each row names its column
    kw = (dict(device=CPU) if mesh is None
          else dict(sharding=psh.column_sharding(psh.make_mesh(devices=["cpu"] * mesh), 2)))
    for start, size, _ in pst.stream_blocks(_fn, arrays, 8, **kw):
        log.append(("yield", start))
    want = []
    for start, size in pst.iter_blocks(23, 8):
        firsts = [start] if mesh is None else [start, start + -(-size // 2)]
        want += [("stage", f) for f in firsts] + [("run", f) for f in firsts] + [("yield", start)]
    assert log == want
    staged, handed = set(), 0
    for what, col in log:
        staged |= {col // 8} if what == "stage" else set()
        handed += what == "yield"
        assert len(staged) - handed <= 1  # beside the block whose result is out


def _fill_case(case):
    """(rows, host arrays) of one fill case: float32 profiles, per-column
    lanes, a strided per-column view, a float32 + int16 pair, fewer rows than
    threads, one row."""
    rng = np.random.default_rng(31)
    n = {"few_rows": 3, "one_row": 1}.get(case, 517)
    prof = lambda w: rng.standard_normal((n, w)).astype(np.float32)
    if case in ("profiles", "few_rows", "one_row"):
        return n, [prof(60), prof(61), prof(1)[:, 0]]
    if case == "lanes":
        return n, [prof(1)[:, 0] for _ in range(8)]
    if case == "strided":
        p = prof(61)
        return n, [p, p[:, 5], p[:, 60]]
    return n, [prof(25), rng.integers(-2 ** 15, 2 ** 15, (n, 40)).astype(np.int16)]


def _filled(parts, fill) -> np.ndarray:
    """A staging slot (a byte buffer laid out by _slot_layout, its padding
    preset) after ``fill(regions, parts)``."""
    layout = pst._slot_layout(parts, parts[0].shape[0])
    buf = np.full(pst._slot_bytes(layout), 0xA5, np.uint8)
    fill([v.numpy() for v in pst._slot_views(torch.from_numpy(buf), layout)], parts)
    return buf


def _fill_inline(regions, parts):
    for r, a in zip(regions, parts):
        np.copyto(r, a)


@pytest.mark.parametrize("case", ["profiles", "lanes", "strided", "mixed_pair", "few_rows",
                                  "one_row"])
def test_pooled_fill_of_a_slot_equals_the_fill_on_one_thread(case):
    """Four threads, each copying its share of every region's rows, leave
    the slot byte for byte as one thread copying each region whole."""
    n, parts = _fill_case(case)
    with ThreadPoolExecutor(4) as pool:
        got = _filled(parts, lambda r, p: pst._fill_pooled(r, p, pool, 4))
    np.testing.assert_array_equal(got, _filled(parts, _fill_inline))
    layout = pst._slot_layout(parts, n)
    for (offset, shape, dtype), a in zip(layout, parts):
        np.testing.assert_array_equal(got[offset:offset + a.nbytes].view(dtype).reshape(shape), a)


@pytest.mark.parametrize("rows,pooled", [(4096, False), (43200, True)], ids=["under", "over"])
def test_a_slot_of_8_mb_or_more_is_filled_by_the_pool(rows, pooled):
    """Under _POOL_MIN_BYTES a slot is filled on the calling thread and
    opens no ``rte.stage.pool``; a 43,200-row slot of a GCM block (~20 MB
    here) opens exactly one, when the process may run on more than one
    core; both fills are the one-thread fill byte for byte."""
    rng = np.random.default_rng(33)
    parts = [rng.standard_normal((rows, w)).astype(np.float32) for w in (60, 61)]
    assert (sum(a.nbytes for a in parts) >= pst._POOL_MIN_BYTES) == pooled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _filled(parts, pst._fill)
    threads = min(pst._POOL_MAX_THREADS, len(os.sched_getaffinity(0)))
    opened = sum(e.name == "rte.stage.pool" for e in prof.events())
    assert opened == (1 if pooled and threads > 1 else 0)
    np.testing.assert_array_equal(got, _filled(parts, _fill_inline))


def _fill_in_a_forked_child(inherited_pid):
    """In a forked child: the parent's pool is left alone, a pool of the
    child's own fills a slot as one thread does."""
    assert pst._POOL[0] == inherited_pid != os.getpid()
    parent_pool = pst._POOL[1]
    pool, threads = pst._copy_pool()
    assert pst._POOL[0] == os.getpid()
    assert pool is None if threads == 1 else pool is not parent_pool
    _, parts = _fill_case("strided")
    fill = ((lambda r, p: pst._fill_pooled(r, p, pool, threads)) if pool is not None
            else _fill_inline)
    np.testing.assert_array_equal(_filled(parts, fill), _filled(parts, _fill_inline))


def test_a_forked_process_fills_with_a_pool_of_its_own():
    pst._copy_pool()  # the parent's pool, made before the fork
    child = multiprocessing.get_context("fork").Process(
        target=_fill_in_a_forked_child, args=(os.getpid(),))
    child.start()
    child.join(timeout=60)
    assert not child.is_alive() and child.exitcode == 0


@pytest.mark.parametrize("ndev,ncol", [(2, 8), (4, 12), (8, 16)])
def test_column_sharding_splits_as_jax(ndev, ncol):
    """Each device's share of the columns is the one the JAX sharding gives
    the same device of its mesh."""
    jmesh = jsh.make_mesh(devices=jax.devices()[:ndev])
    jshard = jsh.column_sharding(jmesh, 2)
    idx = jshard.devices_indices_map((ncol, 3))
    want = [(idx[d][0].start or 0, (idx[d][0].stop or ncol) - (idx[d][0].start or 0))
            for d in jmesh.devices[:, 0]]
    mesh = psh.make_mesh(devices=["cpu"] * ndev)
    assert mesh.shape == {"col": ndev, "gpt": 1} and mesh.axis_names == jmesh.axis_names
    got = psh.column_sharding(mesh, 2).split(ncol)
    assert [(s, n) for _, s, n in got] == want
    x = np.arange(ncol * 3, dtype=np.float32).reshape(ncol, 3)
    shards = psh.shard_columns({"x": x, "s": np.float32(2.0)}, mesh)
    jshards = jsh.shard_columns({"x": x}, jmesh)["x"]
    assert [tuple(s.shape) for s in shards["x"]] == [s.data.shape for s in jshards.addressable_shards]
    np.testing.assert_array_equal(torch.cat(shards["x"]).numpy(), x)
    assert len(shards["s"]) == ndev and all(float(s) == 2.0 for s in shards["s"])


def test_make_mesh_checks_as_jax():
    with pytest.raises(ValueError, match=r"mesh 3x1 needs 3 devices, have 2"):
        psh.make_mesh(3, devices=CPU2)
    with pytest.raises(ValueError, match=r"mesh 3x1 needs 3 devices, have 2"):
        jsh.make_mesh(3, devices=jax.devices()[:2])
    assert psh.make_mesh(1, devices=CPU2).devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():  # the default is every CUDA device, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            psh.make_mesh()


def test_gpt_split_is_refused_in_words():
    mesh = psh.make_mesh(devices=CPU2)
    with pytest.raises(NotImplementedError, match=rf"make_mesh\(n_gpt=2\): .*{GPT_WORDS}"):
        psh.make_mesh(n_gpt=2, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match=GPT_WORDS):
        psh.column_sharding(mesh, 3, gpt_axis=2)
    with pytest.raises(NotImplementedError, match=GPT_WORDS):
        psh.shard_columns({"tau": np.zeros((4, 2, 3))}, mesh, gpt_minor=True)


def test_replicated_copies_never_moves():
    """A value already on a device is that device's copy; a model is copied
    to another device, and the caller's stays where it was."""
    model = load_model_netcdf(LW_MODEL, device=CPU)
    placed = psh.replicated(psh.Mesh((torch.device("cpu"), torch.device("meta")))).put(
        [model, torch.ones(3)])
    assert placed[torch.device("cpu")][0] is model
    on_meta = placed[torch.device("meta")]
    assert on_meta[0] is not model and on_meta[0].weights[0].device.type == "meta"
    assert on_meta[1].device.type == "meta" and model.weights[0].device == CPU


@pytest.mark.parametrize("multiple", [1, 4, 5])
def test_pad_to_multiple_matches_jax(multiple):
    tree = {"a": np.arange(6.0).reshape(3, 2), "b": np.arange(3.0), "c": np.float32(1.5)}
    got, n = psh.pad_to_multiple(tree, multiple)
    ref, m = jsh.pad_to_multiple({k: jnp.asarray(v) for k, v in tree.items()}, multiple)
    assert n == m == 3
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


@pytest.fixture(scope="module")
def gcm_case(tmp_path_factory):
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
    from test_torch_cloud_optics import cloud_optics_pair

    tmp = tmp_path_factory.mktemp("parallel-gcm")
    host = pgcm.synthesize_gcm_columns(rfmip_data_from_arrays(synthesize_rfmip(16, 8, 9)), 90)
    (_, co_lw), (_, co_sw) = cloud_optics_pair(tmp, "lw", 3, "lut"), cloud_optics_pair(tmp, "sw", 4, "lut")
    lw = [load_model_netcdf(LW_MODEL, device=CPU)]
    sw = [load_model_netcdf(SW_MODEL, device=CPU)] * 2
    return host, lw, sw, co_lw, co_sw


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_gcm_sweeps_on_a_two_device_mesh_match_no_mesh(gcm_case, precision):
    host, lw, sw, co_lw, co_sw = gcm_case
    mesh = psh.make_mesh(devices=CPU2)
    kw = dict(block_size=32, precision=precision, device=CPU)
    for fn, args in ((pgcm.gcm_sweep_lw, (lw,)), (pgcm.gcm_sweep_allsky, (lw, sw, co_lw, co_sw))):
        one = fn(host, *args, **kw)["diagnostics"]
        two = fn(host, *args, mesh=mesh, **kw)["diagnostics"]
        np.testing.assert_array_equal(one, two)


def test_gcm_resident_with_a_mesh_raises(gcm_case):
    host, lw, sw, co_lw, co_sw = gcm_case
    mesh = psh.make_mesh(devices=CPU2)
    words = r"resident=True ignores `mesh` \(blocks are staged on the default device\)"
    with pytest.raises(ValueError, match=words):
        pgcm.gcm_sweep_lw(host, lw, mesh=mesh, resident=True, device=CPU)
    with pytest.raises(ValueError, match=words):
        pgcm.gcm_sweep_allsky(host, lw, sw, co_lw, co_sw, mesh=mesh, resident=True, device=CPU)
    with pytest.raises(ValueError, match="not all of the sweep's device type"):
        pgcm.gcm_sweep_lw(host, lw, mesh=psh.Mesh((torch.device("meta"),)), device=CPU)
