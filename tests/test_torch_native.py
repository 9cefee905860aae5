"""The port's utils/native.py (ctypes onto native/librrtio.so) against the
JAX package's bindings of the same library, on files and arrays made here:
the classic-netCDF reader on a synthetic k-distribution file and an
EasyNC file; col_dry_native against the port's torch get_col_dry; the
multithreaded feature packing against the port's NN-input packing
(compute_nn_inputs in float64, rounded to float32 as the library rounds).
Skipped when the library cannot be built."""
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.utils import native as jnative
from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import (
    _missing_gas_vmr, compute_nn_inputs, get_col_dry)
from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from rte_rrtmgp_nn_tpu_torch.utils import easy_nc
from rte_rrtmgp_nn_tpu_torch.utils import native as pnative
from test_torch_core import CPU, LW_MODEL, SW_MODEL

pytestmark = pytest.mark.skipif(not pnative.available(), reason="native lib not built")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    kd = str(d / "kd.nc")
    generate_kdist_nc(kd, kind="lw", gpts_per_band=4, nband=4)
    ez = str(d / "ez.nc")
    easy_nc.write_dict(ez, {"a": np.arange(24.0).reshape(2, 3, 4), "b": np.float32(1.5),
                            "c": np.arange(5, dtype=np.int32)})
    return {"kd": kd, "ez": ez}


@pytest.mark.parametrize("name,var", [("kd", "kmajor"), ("kd", "bnd_limits_wavenumber"),
                                      ("kd", "press_ref"), ("ez", "a"), ("ez", "b"),
                                      ("ez", "c")])
def test_reader_matches_jax(files, name, var):
    with pnative.NativeNCFile(files[name]) as p, jnative.NativeNCFile(files[name]) as j:
        a, b = p.read(var), j.read(var)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        with pytest.raises(KeyError):
            p.read("not_a_var")
    if name == "ez":
        with pnative.NativeNCFile(files[name]) as p, jnative.NativeNCFile(files[name]) as j:
            assert p.dim_size("a_dim2") == j.dim_size("a_dim2") == 4


def test_col_dry_matches_the_port_and_jax():
    d = synthesize_rfmip(40, 12, 3)
    q = np.asarray(d["gases"]["h2o"], np.float64)
    q = np.broadcast_to(q, d["play"].shape) if q.ndim < 2 else q
    plev = np.asarray(d["plev"], np.float64)
    got = pnative.col_dry_native(q, plev)
    np.testing.assert_array_equal(got, jnative.col_dry_native(q, plev))
    ref = get_col_dry(torch.as_tensor(q), torch.as_tensor(plev)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)


@pytest.mark.parametrize("path", [LW_MODEL, SW_MODEL])
def test_pack_features_matches_the_ports_nn_inputs(path):
    model = load_model_netcdf(path, device=CPU, dtype=torch.float64)
    d = synthesize_rfmip(30, 9, 4)
    ncol, nlay = d["play"].shape
    gases = GasConcs.create({k: np.asarray(v, np.float64) for k, v in d["gases"].items()})
    play, tlay = torch.as_tensor(d["play"], dtype=torch.float64), torch.as_tensor(
        d["tlay"], dtype=torch.float64)
    ref = compute_nn_inputs(play, tlay, gases, model).reshape(ncol * nlay, -1)
    raw = {"tlay": tlay, "play": play}

    def column(n):  # a gas missing from the atmosphere takes its stand-in VMR
        v = raw[n] if n in raw else gases.get_vmr(n, ncol, nlay) if n in gases else \
            torch.full((ncol, nlay), _missing_gas_vmr(n), dtype=torch.float64)
        return v.reshape(-1).numpy()

    cols = [column(n) for n in model.input_names]
    # the kinds of compute_nn_inputs: tlay raw, log(play), h2o and o3 to the 1/4, gases raw
    kinds = [pnative.KIND_RAW_T if n == "tlay" else pnative.KIND_LOG_P if n == "play"
             else pnative.KIND_QUARTER_ROOT if n in ("h2o", "o3") else pnative.KIND_RAW_VMR
             for n in model.input_names]
    fmin, fmax = model.input_min.numpy(), model.input_max.numpy()
    got = pnative.pack_features_native(cols, kinds, fmin, fmax)
    np.testing.assert_array_equal(got, jnative.pack_features_native(cols, kinds, fmin, fmax))
    assert got.dtype == np.float32 and got.shape == (ncol * nlay, len(model.input_names))
    np.testing.assert_allclose(got, ref.numpy().astype(np.float32), rtol=1e-6, atol=1e-7)
