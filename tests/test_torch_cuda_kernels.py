"""The port's CUDA kernels on the card: K1 (lw_clearsky_mega4) and K2
(sw_clearsky_megakernel) against their plain twins on the same CUDA
tensors (LW atol 2e-3, SW atol 2e-2 W/m2), and the CUDA drivers against
the staged plain path in float64 on the CPU.

Every test here needs an NVIDIA GPU and the CUDA toolkit; elsewhere they
skip. The file imports neither JAX nor the JAX package, so on a GPU host
without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip

pytestmark = pytest.mark.cuda

LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2: the JAX package's kernel-vs-staged bounds
ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
LW_MODEL = os.path.join(ART, "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc")
SW_MODEL = os.path.join(ART, "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc")


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _maxabs(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _lw_args(dev, ncol, nlay, seed):
    spec = planck.lw_spectral_g128()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    return rfmip.lw_mega_args([load_model_netcdf(LW_MODEL, device=dev)], table, spec,
                              *rfmip.lw_canonical_inputs(data, spec, dev))


def _sw_args(dev, ncol, nlay, seed):
    spec = planck.sw_spectral_g112()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
    model = load_model_netcdf(SW_MODEL, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32, device=dev)
    return rfmip.sw_mega_args([model, model], solar, *rfmip.sw_canonical_inputs(data, dev))


# nlay 13 is not a multiple of the rows the kernels' MLP takes per pass
@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 60)])
def test_kernels_match_twins(dev, ncol, nlay):
    args = _lw_args(dev, ncol, nlay, seed=31)
    n = k1.LAUNCHES
    got = k1.lw_clearsky_mega4(*args)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == n + 1
    for a, b in zip(got, k1.lw_clearsky_mega4_plain(*args)):
        assert a.is_cuda and tuple(a.shape) == (ncol, nlay + 1)
        assert _maxabs(a, b) <= LW_ATOL
    sargs = _sw_args(dev, ncol, nlay, seed=32)
    n = k2.LAUNCHES
    got = k2.sw_clearsky_megakernel(*sargs)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == n + 1
    for a, b in zip(got, k2.sw_clearsky_megakernel_plain(*sargs)):
        assert a.is_cuda and tuple(a.shape) == (ncol, nlay + 1)
        assert _maxabs(a, b) <= SW_ATOL


@pytest.mark.parametrize("top_at_1", [True, False])
def test_drivers_on_cuda_match_float64_cpu(dev, top_at_1):
    """Both drivers on CUDA launch their kernel and agree with the staged
    plain path run in float64 on the CPU; night SW columns are exactly 0."""
    d = synthesize_rfmip(29, 11, seed=33, top_at_1=top_at_1)
    data = rfmip_data_from_arrays(d)
    cpu, f64 = torch.device("cpu"), torch.float64
    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    ref_lw = rfmip.rfmip_clear_sky_lw(data, [lw64], device=cpu, dtype=f64)
    ref_sw = rfmip.rfmip_clear_sky_sw(data, [sw64, sw64], device=cpu, dtype=f64)
    lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    got_lw = rfmip.rfmip_clear_sky_lw(data, [lw], device=dev)
    got_sw = rfmip.rfmip_clear_sky_sw(data, [sw, sw], device=dev)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k2.LAUNCHES) == (n1 + 1, n2 + 1)
    for n in ("flux_up", "flux_dn", "flux_net"):
        assert getattr(got_lw, n).is_cuda
        assert _maxabs(getattr(got_lw, n), getattr(ref_lw, n)) <= LW_ATOL, n
    night = torch.as_tensor(d["sza"] >= 90.0)
    assert night.any()
    for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        assert _maxabs(getattr(got_sw, n), getattr(ref_sw, n)) <= SW_ATOL, n
        assert (getattr(got_sw, n).cpu()[night] == 0).all(), n


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    """A launch on CUDA checks dtype and contiguity and raises; it never
    falls back to the plain twin."""
    args = list(_lw_args(dev, 5, 8, seed=34))
    n = k1.LAUNCHES
    bad = list(args)
    bad[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)  # same shape, not contiguous
    with pytest.raises(ValueError, match="not contiguous"):
        k1.lw_clearsky_mega4(*bad)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(ValueError, match="dtype"):
        k1.lw_clearsky_mega4(*bad)
    sargs = list(_sw_args(dev, 5, 8, seed=35))
    sargs[6] = sargs[6].cpu()
    with pytest.raises(ValueError, match="mu0: on cpu"):
        k2.sw_clearsky_megakernel(*sargs)
    assert k1.LAUNCHES == n
    assert np.isfinite(float(k1.lw_clearsky_mega4(*args)[0].sum()))
