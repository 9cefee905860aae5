"""The fused kernels' front (drivers/fused.py): a cloud mode of K1 or K2
is its clear mode's positional arguments, bit for bit, plus the cloud
keywords of its flavour, and the clear mode has none; the host and the
device layout helpers lay out the same bits, and so do the RFMIP fused
route's inputs laid out on the device and the host canonicalization, to
the drivers' fluxes."""
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.config import config_override, driver_route
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


def _rfmip_data(top_at_1, host_dtype):
    """synthesize_rfmip's problem (2-D, per-layer and scalar gases) with
    its host arrays in ``host_dtype``: in float64 moved off the float32
    grid, so that the cast to float32 rounds."""
    arrays = synthesize_rfmip(NCOL, NLAY, SEED, top_at_1=top_at_1)
    if host_dtype == np.float64:
        rng = np.random.default_rng(SEED)
        off = lambda v: np.asarray(v, np.float64) * (1.0 + rng.uniform(-2.0 ** -23, 2.0 ** -23,
                                                                         np.shape(v)))
        arrays = {k: off(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
        arrays["gases"] = {k: off(v) for k, v in arrays["gases"].items()}
    return rfmip_data_from_arrays(arrays)


def _host_laid_out(data):
    """canonicalize_rfmip_inputs' arrays as tensors: (the four fields, the
    gas dict)."""
    *fields, concs_t = rfmip.canonicalize_rfmip_inputs(data)
    return [torch.as_tensor(a) for a in fields], {k: torch.as_tensor(v) for k, v in concs_t.items()}


@pytest.mark.parametrize("host_dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("top_at_1", [True, False], ids=["top_at_1", "bottom_first"])
def test_canonical_inputs_are_the_host_layout_bit_for_bit(top_at_1, host_dtype):
    data = _rfmip_data(top_at_1, host_dtype)
    assert {v.ndim for v in data.gas_concs.concs.values()} == {0, 1, 2}
    assert data.play.dtype == host_dtype
    fields, concs = _host_laid_out(data)
    lw = rfmip.lw_canonical_inputs(data, planck.lw_spectral_g128(), CPU)
    sw = rfmip.sw_canonical_inputs(data, CPU)
    for got_fields, got_concs in ((lw[:4], lw[6]), (sw[:3], sw[7])):
        assert list(got_concs) == list(concs)
        got = [*got_fields, *got_concs.values()]
        want = [*fields[:len(got_fields)], *concs.values()]
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g.dtype, g.shape, g.is_contiguous()) == (w.dtype, w.shape, w.is_contiguous()), i
            assert torch.equal(g, w), i


@pytest.fixture(scope="module")
def nets():
    return load_model_netcdf(LW_MODEL, device=CPU), load_model_netcdf(SW_MODEL, device=CPU)


@pytest.mark.parametrize("top_at_1", [True, False], ids=["top_at_1", "bottom_first"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_fused_routes_equal_the_cores_on_host_laid_out_inputs(nets, band, top_at_1):
    """The drivers' fused route (taken on the CPU when asked for: the
    kernels' plain twins) against its core on the host layout."""
    data = _rfmip_data(top_at_1, np.float32)
    lw, sw = nets
    f32 = torch.float32
    t = lambda a: torch.as_tensor(a, dtype=f32)
    (play_t, plev_t, tlay_t, tlev_t), concs_t = _host_laid_out(data)
    if band == "lw":
        spec = planck.lw_spectral_g128()
        table = planck.PlanckTable.kept(spec.band_lims_wvn_array, device=CPU, dtype=f32)
        emis = t(data.sfc_emis)[:, None].expand(NCOL, spec.nband)
        want = fused.lw_core([lw], table, spec, play_t, plev_t, tlay_t, tlev_t, t(data.tsfc),
                             emis, concs_t, top_at_1=top_at_1)
        with config_override(use_megakernel=True):
            assert driver_route("lw", lw=True, models=[lw], device=CPU) == "megakernel"
            got = rfmip.rfmip_clear_sky_lw(data, [lw], device=CPU)
        names = ("flux_up", "flux_dn", "flux_net")
    else:
        spec = planck.sw_spectral_g112()
        solar = rfmip.kept_solar_source(spec, device=CPU, dtype=f32)
        mu0, usecol = rfmip._sun(data, CPU, f32)
        want = rfmip._sw_core_mega_canon([sw, sw], solar, play_t, plev_t, tlay_t,
                                         t(data.sfc_alb), mu0, usecol, t(data.tsi), concs_t,
                                         top_at_1=top_at_1)
        with config_override(use_megakernel=True):
            assert driver_route("sw", models=[sw, sw], device=CPU) == "megakernel"
            got = rfmip.rfmip_clear_sky_sw(data, [sw, sw], device=CPU)
        names = ("flux_up", "flux_dn", "flux_net", "flux_dn_dir")
    for n in names:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
