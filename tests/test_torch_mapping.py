"""The port's check of NN nets against the spectral mapping an entry point
or sweep fixes (gasoptics/planck.spectral_for) on the CPU, in seconds.

- Every entry that picks a mapping on the caller's behalf refuses nets of
  another one in words: the benchmark entries (bench_torch.py,
  scripts/torch_bench_allsky.py, torch_bench_gcm.py,
  torch_bench_multichip.py: g-128 LW, g-112 SW), the GCM sweeps
  (gcm_sweep_lw: g-128; gcm_sweep_allsky: g-128 LW, g-112 or g-224 SW) and
  the drivers' defaults (rfmip_clear_sky_lw / _sw, allsky_lw / _sw). Each
  is handed the in-repo 56-g-point SW pair (sw-synth56-lut 128_128) and the
  one-net 64-g-point LW net (lw-synth64-lut 128_128): the ValueError names
  the entry, the nets' outputs, the mapping expected and how to run such
  nets, and it comes before anything past the check runs (every later step
  armed to fail the test: the kernels' build, input synthesis, file
  writes, the ranks' spawn, a net's move, the route, file reads, the
  sweeps' f32 fields and mixed packing).
- A mapping the caller passes is checked the same way.
- The shapes the mappings take still pass: one LW net of 2*ngpt outputs
  or two of ngpt each, and the g-224 SW pair in gcm_sweep_allsky (the
  sweep on a two-net g-128 LW pair split from the demo net against the
  one-net sweep, to LW 2e-3 W/m2).
- Each mapping the check returns equals the JAX package's counterpart.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.drivers import allsky as pallsky
from rte_rrtmgp_nn_tpu_torch.drivers import gcm as pgcm
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.models.network import NNModel, load_model_netcdf, nn_model_from_arrays
from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
from rte_rrtmgp_nn_tpu_torch.parallel import distributed
from rte_rrtmgp_nn_tpu_torch.utils import bench, ncio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SW56 = T.sw_pair_paths("128_128")
LW64 = T.artifact_path("lw-synth64-lut_both_128_128_HR_2.31e-01_FRC_2.39e-01.nc")
LW_ATOL = 2e-3  # W/m2: two-net LW against the one-net sweep

# everything an entry does after its check: each armed to fail the test
TRIPWIRES = ((bench, "build_seconds"), (build, "library"), (T, "synthesize_rfmip"),
             (T, "synthesize_garand"), (T, "synthesize_cloud_optics"), (ncio, "write_nc"),
             (distributed, "launch"), (NNModel, "to"), (prfmip, "driver_route"),
             (pallsky, "driver_route"), (pallsky, "read_garand"),
             (pgcm, "driver_route"), (pgcm, "_f32_job"), (pgcm, "_pack_columns_mixed"))

SCRIPTS = {"bench_torch": ("bench_torch.py", ["--ncol", "16"]),
           "torch_bench_allsky": ("scripts/torch_bench_allsky.py", ["--ncol", "16"]),
           "torch_bench_gcm": ("scripts/torch_bench_gcm.py", ["--ncol", "64", "--block", "32"]),
           "torch_bench_multichip": ("scripts/torch_bench_multichip.py",
                                     ["--device-counts", "1", "--cols-per-device", "64"])}
# the words of each misfit: its band, the outputs the refusal names, its flag
MISFITS = {"sw56": ("SW", "not 56 outputs in each of two nets", ["--sw-models", *SW56]),
           "lw64": ("LW", "not 128 outputs in one net", ["--lw-model", LW64])}
MAPPING = {"LW": "g-128", "SW": "g-112"}


def _load_script(path):
    name = "mapping_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets(misfit=None):
    """(LW nets, SW nets) on the CPU: the demo nets, with ``misfit``'s
    band taking the misfit nets."""
    lw = [load_model_netcdf(LW64 if misfit == "lw64" else bench.LW_MODEL, device=CPU)]
    sw = [load_model_netcdf(p, device=CPU)
          for p in (SW56 if misfit == "sw56" else (bench.SW_MODEL, bench.SW_MODEL))]
    return lw, sw


@pytest.fixture
def arm(monkeypatch):
    """arm(): every step past the check raises AssertionError (not a
    ValueError: pytest.raises lets it through)."""
    def tripwire(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"{name} ran before the nets were refused")
        return fail

    def arm():
        for owner, name in TRIPWIRES:
            monkeypatch.setattr(owner, name, tripwire(name))
    return arm


@pytest.fixture(scope="module")
def host():
    return pgcm.synthesize_gcm_columns(rfmip_data_from_arrays(T.synthesize_rfmip(8, 12, 0)), 8)


def _driver_call(entry, misfit, host):
    """The call of a driver or sweep on ``misfit``'s nets, its band's and
    the mapping its refusal names."""
    lw, sw = _nets(misfit)
    data = rfmip_data_from_arrays(T.synthesize_rfmip(4, 8, 0))
    missing = os.path.join(ROOT, "no-such-file.nc")  # the check reads no file
    calls = {
        "rfmip_clear_sky_lw": lambda: prfmip.rfmip_clear_sky_lw(data, lw, device=CPU),
        "rfmip_clear_sky_sw": lambda: prfmip.rfmip_clear_sky_sw(data, sw, device=CPU),
        "allsky_lw": lambda: pallsky.allsky_lw(missing, missing, lw, ncol=4, device=CPU),
        "allsky_sw": lambda: pallsky.allsky_sw(missing, missing, sw, ncol=4, device=CPU),
        "gcm_sweep_lw": lambda: pgcm.gcm_sweep_lw(host, lw, block_size=8, device=CPU),
        "gcm_sweep_allsky": lambda: pgcm.gcm_sweep_allsky(host, lw, sw, None, None,
                                                          block_size=8, device=CPU),
    }
    return calls[entry]


CASES = ([(name, m) for name in SCRIPTS for m in MISFITS]
         + [("rfmip_clear_sky_lw", "lw64"), ("rfmip_clear_sky_sw", "sw56"),
            ("allsky_lw", "lw64"), ("allsky_sw", "sw56"), ("gcm_sweep_lw", "lw64"),
            ("gcm_sweep_allsky", "lw64"), ("gcm_sweep_allsky", "sw56")])


@pytest.mark.parametrize("entry, misfit", CASES)
def test_entry_refuses_a_misfit_net_in_words_before_any_work(entry, misfit, host, arm):
    band, got, flag = MISFITS[misfit]
    if entry in SCRIPTS:
        path, size = SCRIPTS[entry]
        name = os.path.basename(path)
        args = ["--device", "cpu", *size, *flag]
        arm()
        call = lambda: _load_script(path).main(args)
    else:
        name = entry
        call = _driver_call(entry, misfit, host)
        arm()
    mapping = ("g-112 or g-224" if (entry, band) == ("gcm_sweep_allsky", "SW")
               else MAPPING[band])
    with pytest.raises(ValueError) as e:
        call()
    msg = str(e.value)
    assert msg.startswith(f"{name} takes the {mapping} {band} nets (")
    assert f"), {got}: " in msg and msg.endswith(pplanck.RUN_OTHER_NETS)
    assert "spectral=" in msg and "testing.sw_pair_setup" in msg


PASSED = {"rfmip_clear_sky_sw": ("sw56", pplanck.sw_spectral_g112, "56 outputs in each of two"),
          "allsky_sw": (None, pplanck.sw_spectral_g224, "112 outputs in each of two"),
          "rfmip_clear_sky_lw": ("lw64", pplanck.lw_spectral_g128, "128 outputs in one net"),
          "allsky_lw": (None, pplanck.lw_spectral_g256, "256 outputs in one net")}


@pytest.mark.parametrize("entry", sorted(PASSED))
def test_driver_refuses_nets_that_do_not_fit_the_mapping_passed(entry, arm):
    misfit, make, got = PASSED[entry]
    spec = make()
    lw, sw = _nets(misfit)
    models = lw if entry.endswith("_lw") else sw
    data = rfmip_data_from_arrays(T.synthesize_rfmip(4, 8, 0))
    arm()
    with pytest.raises(ValueError) as e:
        if entry.startswith("rfmip"):
            getattr(prfmip, entry)(data, models, spectral=spec, device=CPU)
        else:
            getattr(pallsky, entry)("no-such.nc", "no-such.nc", models, ncol=4, spectral=spec,
                                    device=CPU)
    msg = str(e.value)
    assert msg.startswith(f"{entry}: the ") and got in msg
    assert f"do not fit the spectral mapping passed ({spec.ngpt} g-points" in msg
    assert msg.endswith(pplanck.RUN_OTHER_NETS)


def _net(n_outputs, device=CPU):
    ws, bs, acts, names, mn, mx, om, os_ = T.random_gas_optics_net_arrays(
        [7, 8, n_outputs], ("softsign", "linear"), 0)
    return nn_model_from_arrays(ws, bs, acts, names, mn, mx, om, os_, device=device)


@pytest.mark.parametrize("band, outputs, ngpt", [
    ("lw", (256,), 128), ("lw", (128, 128), 128), ("lw", (128,), 64), ("lw", (255,), None),
    ("lw", (128, 64), None), ("lw", (256, 256, 256), None), ("sw", (112, 112), 112),
    ("sw", (224, 224), 224), ("sw", (56, 56), 56), ("sw", (112,), None),
    ("sw", (112, 224), None)])
def test_net_gpoints_splits_outputs_as_the_gas_optics_does(band, outputs, ngpt):
    """On meta tensors: the check reads the nets' shapes and no data."""
    meta = [_net(n, torch.device("meta")) for n in outputs]
    assert pplanck.net_gpoints(band, meta) == ngpt


def test_accepted_shapes_pass(host):
    """One LW net of 256 outputs or two of 128 take the g-128 mapping; a
    g-224 SW pair takes g-224 in gcm_sweep_allsky, whose sweep on the two-net
    LW pair split from the demo net gives the one-net sweep's LW fluxes."""
    g128 = pplanck.lw_spectral_g128()
    lw, sw = _nets()
    split = [nn_model_from_arrays(*a, device=CPU)
             for a in T.split_lw_both_arrays(*T.model_arrays(lw[0]))]
    assert [m.n_outputs for m in split] == [128, 128]
    for nets in (lw, split):
        assert pplanck.spectral_for("lw", nets, entry="t", accepts=(pplanck.lw_spectral_g128,)) \
            == g128
    sw224 = nn_model_from_arrays(*T.sw_g224_net_arrays(sw[0], 0), device=CPU)
    accepts = (pplanck.sw_spectral_g112, pplanck.sw_spectral_g224)
    assert pplanck.spectral_for("sw", [sw224, sw224], entry="t", accepts=accepts) \
        == pplanck.sw_spectral_g224()
    assert pplanck.spectral_for("sw", sw, entry="t", accepts=accepts) \
        == pplanck.sw_spectral_g112()

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        co = {}
        for band, spec in (("lw", g128), ("sw", pplanck.sw_spectral_g224())):
            path = os.path.join(tmp, f"{band}.nc")
            ncio.write_nc(path, *T.cloud_optics_nc_variables(
                T.synthesize_cloud_optics(spec, 0, "lut")))
            co[band] = pallsky.load_cloud_optics_checked(path, device=CPU)
    runs = [pgcm.gcm_sweep_allsky(host, nets, [sw224, sw224], co["lw"], co["sw"],
                                  block_size=8, device=CPU) for nets in (lw, split)]
    for r in runs:
        assert np.isfinite(r["diagnostics"]).all() and r["diagnostics"].shape == (8, 3)
    d = np.abs(runs[0]["diagnostics"] - runs[1]["diagnostics"])
    assert d[:, :2].max() <= LW_ATOL and d[:, 2].max() == 0.0


@pytest.mark.parametrize("band, outputs, name", [
    ("lw", (256,), "lw_spectral_g128"), ("lw", (128, 128), "lw_spectral_g128"),
    ("sw", (112, 112), "sw_spectral_g112"), ("sw", (224, 224), "sw_spectral_g224")])
def test_mapping_returned_equals_the_jax_package(band, outputs, name):
    accepts = ((pplanck.lw_spectral_g128,) if band == "lw"
               else (pplanck.sw_spectral_g112, pplanck.sw_spectral_g224))
    got = pplanck.spectral_for(band, [_net(n) for n in outputs], entry="t", accepts=accepts)
    ref = getattr(jplanck, name)()
    np.testing.assert_array_equal(np.asarray(got.band_lims_gpt), np.asarray(ref.band_lims_gpt))
    np.testing.assert_array_equal(np.asarray(got.band_lims_wvn), np.asarray(ref.band_lims_wvn))
