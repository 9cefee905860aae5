"""The benchmark's pieces against the port on the CPU: the input generators
against the port's originals, and the plain reference against the port's
float64 CPU run on the same generated inputs and nets."""
import os
import tempfile

import numpy as np
import pytest
import torch

from radbench import harness, inputs
from radbench.entries import gcm as G
from radbench.entries import rfmip as R
from radbench.reference import physics as P

CPU = torch.device("cpu")


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def configs():
    _, rf, _, _ = harness.find_cell("rfmip-clearsky.c1800")
    _, gc, _, _ = harness.find_cell("gcm-allsky-025deg.step")
    return rf, gc


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_generators_equal_the_ports(seed):
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky_io import GARAND_GASES
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import lw_spectral_g128

    _same(inputs.synthesize_rfmip_experiments(18, 5, 7, seed),
          testing.synthesize_rfmip_experiments(18, 5, 7, seed))
    base = testing.synthesize_rfmip(40, 7, seed)
    base["gases"] = {g: v for g, v in base["gases"].items() if g in GARAND_GASES}
    _same(inputs.synthesize_gcm_columns(inputs.synthesize_rfmip(40, 7, seed), 100, seed),
          gcm.synthesize_gcm_columns(rfmip_data_from_arrays(base), 100, seed))
    theirs = testing.synthesize_cloud_optics(lw_spectral_g128(), seed, "lut")
    _same(inputs.synthesize_cloud_lut(P.LW_BAND_LIMS, seed), theirs)
    assert tuple(GARAND_GASES) == inputs.GARAND_GASES


def test_constants_equal_the_ports():
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import default_solar_source
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import (PlanckTable, lw_spectral_g128,
                                                          sw_spectral_g112)

    np.testing.assert_allclose(P.solar_source(), default_solar_source(sw_spectral_g112()),
                               rtol=1e-15)
    table, _ = P.planck_table(P.LW_BAND_LIMS, torch.float64, CPU)
    theirs = PlanckTable.compute(lw_spectral_g128().band_lims_wvn_array, device="cpu",
                                 dtype=torch.float64)
    np.testing.assert_allclose(table.numpy(), theirs.totplnk.numpy(), rtol=1e-14)


def test_rfmip_reference_against_the_ports_float64_run(configs):
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    rf, _ = configs
    cell = R.setup(rf, {"experiments": 3, "sites": 4, "states": 1}, 5, CPU, harness.ROOT)
    lw = load_model_netcdf(os.path.join(harness.ROOT, rf["lw_net"]), device="cpu", dtype=torch.float64)
    sw = load_model_netcdf(os.path.join(harness.ROOT, rf["sw_net"]), device="cpu", dtype=torch.float64)
    fl = rfmip_clear_sky_lw(cell.data[0], [lw], dtype=torch.float64, device="cpu")
    fs = rfmip_clear_sky_sw(cell.data[0], [sw, sw], dtype=torch.float64, device="cpu")
    ref = cell.reference(0, P.REFERENCE, CPU)
    # LW: float64 rounding; SW: the port takes cos(sza) in float32 on the host
    for key, got, tol in (("lw_up", fl.flux_up, 1e-8), ("lw_dn", fl.flux_dn, 1e-8),
                          ("sw_up", fs.flux_up, 2e-4), ("sw_dn", fs.flux_dn, 2e-4)):
        assert np.abs(got.numpy() - ref[key]).max() < tol, key
    night = cell.arrays[0]["sza"] >= 90
    assert night.any() and not ref["sw_dn"][night].any()


def test_gcm_reference_against_the_ports_float64_sweep(configs):
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    _, gc = configs
    cell = G.setup({**gc, "columns": 60}, {"block_columns": 32, "states": 1}, 9, CPU,
                   harness.ROOT)
    lw = load_model_netcdf(os.path.join(harness.ROOT, gc["lw_net"]), device="cpu",
                           dtype=torch.float64)
    sw = load_model_netcdf(os.path.join(harness.ROOT, gc["sw_net"]), device="cpu",
                           dtype=torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        co = []
        for band in ("lw", "sw"):
            path = os.path.join(tmp, f"{band}.nc")
            inputs.write_cloud_file(path, cell.luts[band])
            co.append(load_cloud_optics_checked(path, device="cpu", dtype=torch.float64))
    r = gcm.gcm_sweep_allsky(cell.hosts[0], [lw], [sw, sw], *co, block_size=32,
                             dtype=torch.float64, device="cpu")
    ref = cell.reference(0, P.REFERENCE, CPU)
    assert cell.cloud_cells(0)[2] > 0
    # the sweep hands its diagnostics back in float32
    for i, key in enumerate(G.Cell.CHECKS):
        assert np.abs(r["diagnostics"][:, i] - ref[key]).max() < 2e-4, key


def test_float32_run_is_close_and_the_control_is_not(configs):
    """The staged float32 CPU path sits well inside the cells' limits; the
    TF32 control well outside one of them."""
    rf, _ = configs
    cell = R.setup(rf, {"experiments": 2, "sites": 10, "states": 1}, 3, CPU, harness.ROOT)
    _, _, w, _ = harness.find_cell("rfmip-clearsky.c1800")
    prog = harness.check(cell, [(0, cell.call(0), 0, 0)], w["limits"], CPU)
    ctrl = harness.check(cell, [(0, cell.reference(0, P.CONTROL, CPU), 0, 0)], w["limits"], CPU)
    assert all(v["value"] < 0.1 * v["limit"] for v in prog.values())
    assert any(v["value"] > v["limit"] for v in ctrl.values())


def test_tf32_round():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12, 3.0])
    assert P.tf32_round(x).tolist() == [1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]
