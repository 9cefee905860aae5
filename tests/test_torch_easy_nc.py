"""The port's utils/easy_nc.py against the JAX package's, on files the test
writes: each scenario is written once by each package's EasyNC, and every
variable, dimension and attribute reads back the same through both
packages' readers (bit for bit: the same numpy arrays go in). Also the
netCDF-4 (HDF5) read path on a file h5py writes here, and the refusals."""
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.utils import easy_nc as jnc
from rte_rrtmgp_nn_tpu_torch.utils import easy_nc as pnc


def _roundtrip(m, path, rng):
    with m.EasyNC(path, "w") as f:
        f.define_dimension("col", 5)
        f.define_dimension("lay", 3)
        f.define_variable("temp", ("col", "lay"), units="K", long_name="temperature",
                          fill_value=-999.0)
        f.put("temp", np.arange(15, dtype=np.float64).reshape(5, 3))
        f.put("p0", 1013.25)
        f.put("levels", np.array([1.0, 2.0, 3.0]), dims=("lay",), units="Pa")
        f.put("counts", np.arange(5, dtype=np.int64), dims=("col",))
        f.put_attribute("temp", "comment", "made up")
        f.put_global_attribute("title", "roundtrip")


def _indexed(m, path, rng):
    slabs = rng.normal(size=(4, 3, 2))
    with m.EasyNC(path, "w") as f:
        f.define_dimension("rec", 4)
        f.define_dimension("a", 3)
        f.define_dimension("b", 2)
        f.define_variable("x", ("rec", "a", "b"))
        for i in range(4):
            f.put("x", slabs[i], index=i)


def _toggles(m, path, rng):
    a2, a3 = rng.normal(size=(3, 4)), rng.normal(size=(2, 3, 4))
    with m.EasyNC(path, "w") as f:
        f.transpose_matrices()
        f.permute_3d_arrays((2, 0, 1))
        f.double_precision()
        f.put("m", a2, dims=("d4", "d3"))
        f.put("t", a3, dims=("e4", "e2", "e3"))


def _copy(m, path, rng):
    src = path + ".src.nc"
    with m.EasyNC(src, "w") as f:
        f.put("v", rng.normal(size=(3, 2)), dims=("i", "j"), units="m", long_name="vee")
        f.put("w", np.arange(3.0), dims=("i",))
    with m.EasyNC(src) as s, m.EasyNC(path, "w") as f:
        f.copy_dimensions(s)
        f.copy_variable(s, "v")
        f.copy_variable_definition(s, "w")


def _append(m, path, rng):
    with m.EasyNC(path, "w") as f:
        f.put("a", np.arange(4.0), dims=("n",))
    with m.EasyNC(path, "a") as f:
        f.put("b", np.ones(4), dims=("n",))
        f.put_global_attribute("stage", "appended")


def _write_dict(m, path, rng):
    m.write_dict(path, {"x": np.arange(6.0).reshape(2, 3), "s": np.float32(2.5)},
                 source="test", version=3)


SCENARIOS = {"roundtrip": _roundtrip, "indexed": _indexed, "toggles": _toggles, "copy": _copy,
             "append": _append, "write_dict": _write_dict}


def _contents(m, path):
    out = {}
    with m.EasyNC(path) as f:
        names = f._r.variables()
        for n in sorted(names):
            out[n] = (f.get_rank(n), f.get_outer_dimension(n), np.asarray(f.get(n)))
            for a in ("units", "long_name", "comment"):
                if f.attribute_exists(n, a):
                    out[(n, a)] = f.get_attribute(n, a)
        for a in ("title", "stage", "source", "version"):
            if f.global_attribute_exists(a):
                out[a] = np.asarray(f.get_global_attribute(a)).tolist()
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_port_writes_what_jax_writes(tmp_path, scenario):
    p, j = str(tmp_path / "p.nc"), str(tmp_path / "j.nc")
    SCENARIOS[scenario](pnc, p, np.random.default_rng(7))
    SCENARIOS[scenario](jnc, j, np.random.default_rng(7))
    for reader in (pnc, jnc):
        got, want = _contents(reader, p), _contents(reader, j)
        assert got.keys() == want.keys() and got
        for k in got:
            if isinstance(got[k], tuple):
                assert got[k][:2] == want[k][:2], k
                np.testing.assert_array_equal(got[k][2], want[k][2], err_msg=str(k))
                assert got[k][2].dtype == want[k][2].dtype, k
            else:
                assert got[k] == want[k], k


def test_indexed_get_and_toggles_read_as_jax(tmp_path):
    p = str(tmp_path / "x.nc")
    _indexed(pnc, p, np.random.default_rng(1))
    with pnc.EasyNC(p) as f, jnc.EasyNC(p) as g:
        for i in range(4):
            np.testing.assert_array_equal(f.get("x", index=i), g.get("x", index=i))
        assert f.dim_size("a") == g.dim_size("a") == 3
    t = str(tmp_path / "t.nc")
    _toggles(pnc, t, np.random.default_rng(2))
    with pnc.EasyNC(t) as f, jnc.EasyNC(t) as g:
        f.transpose_matrices()
        g.transpose_matrices()
        np.testing.assert_array_equal(f.get("m"), g.get("m"))
        assert f.get("m").dtype == np.float64


def test_hdf5_read_matches_jax(tmp_path):
    """The netCDF-4 (HDF5) read path: variables, a variable attribute and
    a global attribute of a file h5py writes here."""
    h5py = pytest.importorskip("h5py")
    p = str(tmp_path / "h5.nc")
    with h5py.File(p, "w") as f:
        d = f.create_dataset("w", data=np.arange(12, dtype=np.float32).reshape(3, 4))
        d.attrs["units"] = b"1"
        f.attrs["comment"] = b"an HDF5 file"
    with pnc.EasyNC(p) as a, jnc.EasyNC(p) as b:
        np.testing.assert_array_equal(a.get("w"), b.get("w"))
        assert a.get_attribute("w", "units") == b.get_attribute("w", "units") == "1"
        assert a.get_global_attribute("comment") == b.get_global_attribute("comment")
        assert a.get_rank("w") == b.get_rank("w") == 2
        assert a.get_outer_dimension("w") == 3


def test_refusals_match_jax(tmp_path):
    p = str(tmp_path / "r.nc")
    _roundtrip(pnc, p, None)
    for m in (pnc, jnc):
        with pytest.raises(ValueError, match="mode must be"):
            m.EasyNC(p, "x")
        with m.EasyNC(p) as f:
            with pytest.raises(IOError, match="read-only"):
                f.put("q", 1.0)
            with pytest.raises(KeyError):
                f.get_attribute("temp", "absent")
        with m.EasyNC(str(tmp_path / f"u{m.__name__[-6:]}.nc"), "w") as f:
            with pytest.raises(ValueError, match="needs dims"):
                f.put("arr", np.ones(3))
