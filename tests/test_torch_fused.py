"""The fused kernels' front (drivers/fused.py): a cloud mode of K1 or K2
is its clear mode's positional arguments, bit for bit, plus the cloud
keywords of its flavour, and the clear mode has none; the host and the
device layout helpers lay out the same bits."""
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.allsky import cloud_fields_lay_major
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.extensions.cloud_optics import cloud_optics_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_cloud_optics, synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL

NCOL, NLAY, SEED = 13, 8, 13
CLOUD_KEYWORDS = {("lw", "lut"): {"cld_fields", "cld_lut"}, ("lw", "pade"): {"cld_tau_band"},
                  ("sw", "lut"): {"gpt2band", "cld_fields", "cld_lut"},
                  ("sw", "pade"): {"gpt2band", "cld_bands"}}


@pytest.fixture(scope="module")
def problem():
    arrays = synthesize_rfmip(NCOL, NLAY, SEED)
    data = rfmip_data_from_arrays(arrays)
    lw_spec, sw_spec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    table = planck.PlanckTable.compute(lw_spec.band_lims_wvn_array, device=CPU)
    sw = load_model_netcdf(SW_MODEL, device=CPU)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32)
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = rfmip.sw_canonical_inputs(data, CPU)
    mu0 = torch.full((NCOL,), 0.86)
    alb = torch.full((NCOL, sw_spec.nband), 0.06)
    return {
        "lw": (fused.lw_args, ([load_model_netcdf(LW_MODEL, device=CPU)], table, lw_spec,
                               *rfmip.lw_canonical_inputs(data, lw_spec, CPU)), lw_spec),
        "sw": (fused.sw_args, ([sw, sw], sw_spec, play_t, plev_t, tlay_t, mu0,
                               *fused.sw_boundary(sw_spec, solar, alb, alb), concs_t), sw_spec),
        "arrays": arrays,
    }


@pytest.mark.parametrize("flavour", ["lut", "pade"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_a_cloud_mode_is_the_clear_arguments_and_its_keywords(problem, band, flavour):
    build, inputs, spec = problem[band]
    co = cloud_optics_from_arrays(synthesize_cloud_optics(spec, SEED, flavour),
                                  SpectralMapping.bands_only(spec.band_lims_wvn_array), CPU,
                                  torch.float32)
    arrays = problem["arrays"]
    fields = cloud_fields_lay_major(arrays["play"], arrays["tlay"], co, True, CPU)
    assert bool((fields[0] > 0).any() and (fields[1] > 0).any())
    clear, clear_kw = build(*inputs)
    args, kw = build(*inputs, (co, fields))
    assert clear_kw == {}
    assert set(kw) == CLOUD_KEYWORDS[band, flavour]
    assert len(args) == len(clear)
    for i, (a, b) in enumerate(zip(args, clear)):
        if torch.is_tensor(a):
            assert torch.equal(a, b), i
        else:
            assert a is b or a == b, i


@pytest.mark.parametrize("top_at_1", [True, False], ids=["top_at_1", "bottom_first"])
def test_host_and_device_layouts_are_the_same_bits(top_at_1):
    a = np.random.default_rng(SEED).random((NCOL, NLAY + 1))
    host = fused.lay_major_host(a, top_at_1)
    dev = fused.lay_major(torch.as_tensor(a, dtype=torch.float32), top_at_1)
    assert host.flags.c_contiguous and dev.is_contiguous() and host.shape == (NLAY + 1, NCOL)
    np.testing.assert_array_equal(host, dev.numpy())
    top = a[:, 0] if top_at_1 else a[:, -1]
    np.testing.assert_array_equal(host[0], top.astype(np.float32))
