"""The port's CUDA kernels on the card against their plain twins on the
same CUDA tensors: K1 (lw_clearsky_mega4) and K2 (sw_clearsky_megakernel)
to LW atol 2e-3 and SW atol 2e-2 W/m2, clear-sky, in both cloud modes
(lookup tables in the kernel; band lanes) and in their lane input modes
(K8 lw_clearsky_mega5 on raw lanes; K9 input_mode="lanes"); the MLP
kernel's three epilogues K3/K4/K5 (fused_predict_lw_both, _tau, _sw) to
the JAX package's rtol 2e-5; K7 (lw_noscat_broadband) to 2e-3 W/m2; K6
(lw_prep) elementwise by the MLP kernel's rule and through the sweeps. And
the CUDA drivers, RFMIP and all-sky, fused and general (multi-angle LW,
staged SW, parallel scans), the prep LW core and the lookup-table gas
optics with the solvers behind it (alone and as the RFMIP drivers' route
for a k-distribution), against the same paths in float64 on the CPU. The sharded fused cores (drivers.rfmip lw_mega_core_sharded /
sw_mega_core_sharded) at world size 1 on NCCL and on two gloo ranks
sharing the card, against the unsharded cores bit for bit. The RFMIP fused
route's inputs laid out on the card, against the host canonicalization
bit for bit, to the drivers' fluxes.

Every test here needs an NVIDIA GPU and the CUDA toolkit; elsewhere they
skip. The file imports neither JAX nor the JAX package, so on a GPU host
without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
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
# a matched absorption / Rayleigh pair of 48-wide nets (a real Rayleigh net)
SW_PAIR = [os.path.join(ART, f"sw-synth56-lut_{k}_48_48_HR_3.61e-01_FRC_2.75e+00.nc")
           for k in ("absorption", "rayleigh")]


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
    return fused.lw_args([load_model_netcdf(LW_MODEL, device=dev)], table, spec,
                         *rfmip.lw_canonical_inputs(data, spec, dev))[0]


def _sw_args(dev, ncol, nlay, seed):
    spec = planck.sw_spectral_g112()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
    model = load_model_netcdf(SW_MODEL, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32, device=dev)
    return fused.sw_args([model, model], None,
                         *rfmip.sw_fused_inputs(solar, *rfmip.sw_canonical_inputs(data, dev)))[0]


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


@pytest.mark.parametrize("top_at_1", [True, False])
def test_fused_route_lays_out_on_the_card_as_the_host_does(dev, top_at_1):
    """The RFMIP fused route's inputs, copied as they are and laid out on
    the card, equal the host canonicalization's arrays copied to the card,
    bit for bit, every gas included; the drivers' LW and SW fluxes equal
    the fused cores' on the host layout, bit for bit."""
    data = rfmip_data_from_arrays(synthesize_rfmip(1800, 60, seed=35, top_at_1=top_at_1))
    f32 = torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=dev)
    *fields, concs = rfmip.canonicalize_rfmip_inputs(data)
    fields, concs = [t(a) for a in fields], {k: t(v) for k, v in concs.items()}
    spec, sspec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    li = rfmip.lw_canonical_inputs(data, spec, dev)
    si = rfmip.sw_canonical_inputs(data, dev)
    for got_fields, got_concs in ((li[:4], li[6]), (si[:3], si[7])):
        assert list(got_concs) == list(concs)
        got = [*got_fields, *got_concs.values()]
        for i, (g, w) in enumerate(zip(got, [*fields[:len(got_fields)], *concs.values()])):
            assert g.is_cuda and (g.dtype, g.shape, g.is_contiguous()) == (
                w.dtype, w.shape, w.is_contiguous()), i
            assert torch.equal(g, w), i
    lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
    table = planck.PlanckTable.kept(spec.band_lims_wvn_array, device=dev, dtype=f32)
    want_lw = fused.lw_core([lw], table, spec, *fields, li[4], li[5], concs, top_at_1=top_at_1)
    want_sw = rfmip._sw_core_mega_canon(
        [sw, sw], rfmip.kept_solar_source(sspec, device=dev, dtype=f32), *fields[:3], *si[3:7],
        concs, top_at_1=top_at_1)
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    got_lw = rfmip.rfmip_clear_sky_lw(data, [lw], device=dev)
    got_sw = rfmip.rfmip_clear_sky_sw(data, [sw, sw], device=dev)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k2.LAUNCHES) == (n1 + 1, n2 + 1)
    for n in ("flux_up", "flux_dn", "flux_net"):
        assert torch.equal(getattr(got_lw, n), getattr(want_lw, n)), n
    for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        assert torch.equal(getattr(got_sw, n), getattr(want_sw, n)), n


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


# -- the general RTE path: K3/K4/K5 (csrc/mlp.cu) and K7 (csrc/lw_noscat.cu) ---

def _close(got, ref, rtol, atol, what, ref64=None):
    """Kernel output ``got`` within rtol/atol of its twin's ``ref``; beyond
    that, float64 (``ref64``) decides (testing.hold_kernel)."""
    from rte_rrtmgp_nn_tpu_torch.testing import hold_kernel

    if ref64 is None:
        ref64 = ref
    r = hold_kernel(got, ref, ref64, rtol, atol)
    assert r["ok"], f"{what}: {r} (rtol {rtol}, atol {atol})"


def _mlp_inputs(dev, rows, nin, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (rows, nin)), dtype=torch.float32, device=dev)
    cd = torch.as_tensor(rng.uniform(1e20, 5e21, rows), dtype=torch.float32, device=dev)
    return x, cd


# 1 and 31 rows: one ragged block; 481: 7 blocks of 64 or 3 of 128 and a
# ragged one; 108,000: the RFMIP size
@pytest.mark.parametrize("rows", [1, 31, 481, 6000, 108000])
def test_mlp_kernels_match_twins(dev, rows):
    """K3 with the LW demo net, a net with a 512-wide hidden layer, a seeded
    8-layer net using all seven activations and a net of 126 outputs (not
    a multiple of the last layer's 4-column tiles); K4 with the demo net's
    tau half and with 63 outputs; K5 with the SW demo net as both nets and
    with the real-Rayleigh synthetic pair: the JAX package's bounds (rtol
    2e-5; ssa atol 2e-5), beyond which float64 decides
    (testing.hold_kernel). A second launch gives the same bits."""
    from rte_rrtmgp_nn_tpu_torch.models.network import nn_model_from_arrays
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp
    from rte_rrtmgp_nn_tpu_torch.testing import (
        ALL_ACTIVATIONS, float64_copy, model_arrays, random_gas_optics_net_arrays,
        split_lw_both_arrays)

    net = lambda dims, acts, seed: nn_model_from_arrays(
        *random_gas_optics_net_arrays(dims, acts, seed=seed), device=dev)
    lw = load_model_netcdf(LW_MODEL, device=dev)
    both = [lw, net((18, 512, 128, 256), ("softsign",) * 2 + ("linear",), 43),
            net((18,) + (40,) * 7 + (96,), ALL_ACTIVATIONS + ("linear",), 41),
            net((18, 64, 64, 126), ("tanh", "relu", "linear"), 44)]
    tau_nets = [nn_model_from_arrays(*split_lw_both_arrays(*model_arrays(m))[0], device=dev)
                for m in (lw, both[-1])]
    x, cd = _mlp_inputs(dev, rows, 18, seed=42)
    x64, cd64 = x.double(), cd.double()
    n = dict(mlp.LAUNCHES)

    def same_again(fn, got):
        for a, b in zip(got, fn()):
            assert torch.equal(a, b)

    for m in both:
        got = mlp.fused_predict_lw_both(m, x, cd)
        ref = mlp.fused_predict_lw_both_plain(m, x, cd)
        ref64 = mlp.fused_predict_lw_both_plain(float64_copy(m), x64, cd64)
        _close(got[0], ref[0], 2e-5, 1e-8, f"K3 tau {m.dims}", ref64[0])
        _close(got[1], ref[1], 2e-5, 1e-9, f"K3 pfrac {m.dims}", ref64[1])
        same_again(lambda: mlp.fused_predict_lw_both(m, x, cd), got)
    for m in tau_nets:
        got = mlp.fused_predict_tau(m, x, cd)
        _close(got, mlp.fused_predict_tau_plain(m, x, cd), 2e-5, 1e-8, f"K4 tau {m.dims}",
               mlp.fused_predict_tau_plain(float64_copy(m), x64, cd64))
        same_again(lambda: (mlp.fused_predict_tau(m, x, cd),), (got,))
    sw = load_model_netcdf(SW_MODEL, device=dev)
    pair = [load_model_netcdf(p, device=dev) for p in SW_PAIR]
    x7 = x[:, :7].contiguous()
    for ma, mr in ((sw, sw), pair):
        tau, ssa = mlp.fused_predict_sw(ma, mr, x7, cd)
        rtau, rssa = mlp.fused_predict_sw_plain(ma, mr, x7, cd)
        tau64, ssa64 = mlp.fused_predict_sw_plain(float64_copy(ma), float64_copy(mr), x7.double(),
                                                  cd64)
        _close(tau, rtau, 2e-5, 1e-8, "K5 tau", tau64)
        big = rtau > 1e-12  # ssa where tau is not an underflow residue
        _close(ssa[big], rssa[big], 0.0, 2e-5, "K5 ssa", ssa64[big])
        same_again(lambda: mlp.fused_predict_sw(ma, mr, x7, cd), (tau, ssa))
    torch.cuda.synchronize()
    assert mlp.LAUNCHES == {"fused_predict_lw_both": n["fused_predict_lw_both"] + 8,
                            "fused_predict_tau": n["fused_predict_tau"] + 4,
                            "fused_predict_sw": n["fused_predict_sw"] + 4}


def test_mlp_kernel_gives_the_same_bits_at_any_block_geometry(dev):
    """Every output's sum runs over k ascending in one accumulator whatever
    the rows and threads of a block, so the plans the tuning script tries
    (512 threads; 32, 64 or 128 rows) give the shipped plan's bits: K3 with
    the LW demo net, K5 with the SW demo net as both nets, 6,000 rows."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    lw = load_model_netcdf(LW_MODEL, device=dev)
    sw = load_model_netcdf(SW_MODEL, device=dev)
    x, cd = _mlp_inputs(dev, 6000, 18, seed=42)
    x7 = x[:, :7].contiguous()
    calls = (lambda: mlp.fused_predict_lw_both(lw, x, cd),
             lambda: mlp.fused_predict_sw(sw, sw, x7, cd))
    shipped = [fn() for fn in calls]
    kept = mlp.THREAD_CHOICES, mlp.ROW_CHOICES
    try:
        for threads, rows in ((512, kept[1]), (512, (32,)), (256, (64,))):
            mlp.THREAD_CHOICES, mlp.ROW_CHOICES = (threads,), rows
            mlp.mlp_launch_plan.cache_clear()
            for fn, want in zip(calls, shipped):
                for a, b in zip(fn(), want):
                    assert torch.equal(a, b), (threads, rows)
    finally:
        mlp.THREAD_CHOICES, mlp.ROW_CHOICES = kept
        mlp.mlp_launch_plan.cache_clear()


@pytest.mark.parametrize("ncol,nlay,ngpt", [(37, 13, 128), (50, 60, 100)])
def test_lw_noscat_kernel_matches_twin(dev, ncol, nlay, ngpt):
    """K7 with per-(column, g-point) secants and an incident radiance, a
    g-point count that is not a warp multiple in the second case: LW
    atol 2e-3 W/m2 and rtol 2e-6 (the JAX interpret-mode bound)."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    rng = np.random.default_rng(43)
    t = lambda *shape, lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                                               device=dev)
    args = (t(ncol, nlay, ngpt, lo=1e-6, hi=3.0), t(ncol, nlay, ngpt, lo=0.1, hi=1.0),
            t(ncol, nlay + 1, ngpt, lo=0.1, hi=1.0), t(ncol, ngpt, lo=0.8, hi=1.0),
            t(ncol, ngpt, lo=0.1, hi=1.0), t(ncol, ngpt, lo=1.2, hi=2.8), 0.25,
            t(ncol, ngpt, lo=0.0, hi=0.5))
    n = k7.LAUNCHES
    got = k7.lw_noscat_broadband(*args)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == n + 1
    for g, r in zip(got, k7.lw_noscat_broadband_plain(*args)):
        assert tuple(g.shape) == (ncol, nlay + 1)
        _close(g, r, 2e-6, LW_ATOL, "K7")


def _noscat_fields(dev, ncol, nlay, ngpt, seed):
    """Seeded tau, layer and level sources, emissivity and surface source
    on the card, as test_lw_noscat_kernel_matches_twin makes them."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, lo, hi: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                                               device=dev)
    return (t(ncol, nlay, ngpt, lo=1e-6, hi=3.0), t(ncol, nlay, ngpt, lo=0.1, hi=1.0),
            t(ncol, nlay + 1, ngpt, lo=0.1, hi=1.0), t(ncol, ngpt, lo=0.8, hi=1.0),
            t(ncol, ngpt, lo=0.1, hi=1.0))


# 13 g-points: one ragged warp; 256: the LUT width, eight warps. 37 x 13 and
# 37 x 61: no segment of layers is full; 300 layers at 128 and 256 g-points
# do not fit the shared memory: tiers whose rows are formed again in the up
# sweep (as at 61 layers, 256 g-points and 3-4 angles)
@pytest.mark.parametrize("nang", [1, 2, 3, 4])
@pytest.mark.parametrize("ngpt", [13, 128, 256])
@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 61), (4, 300)])
def test_lw_noscat_angles_match_twin(dev, nang, ngpt, ncol, nlay):
    """K7's angles mode against its twin for 1-4 Gauss angles with an
    incident flux, within LW atol 2e-3 W/m2 and rtol 2e-6; one launch for
    all the angles; a second launch gives the same bits."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import GAUSS_DS, GAUSS_WTS

    args = _noscat_fields(dev, ncol, nlay, ngpt, seed=45 + nang)
    plan = k7.lw_noscat_plan(nlay, ngpt, nang)
    n_tiers = k7.tiers(nlay, plan.seg_layers * plan.segments)
    assert nlay < 300 or ngpt == 13 or plan.kept_tiers < n_tiers
    inc = torch.rand((ncol, ngpt), generator=torch.Generator().manual_seed(nang)).to(dev)
    secants, weights = list(GAUSS_DS[nang - 1, :nang]), list(GAUSS_WTS[nang - 1, :nang])
    n = k7.MODE_LAUNCHES["angles"]
    got = k7.lw_noscat_broadband_angles(*args, secants, weights, inc)
    torch.cuda.synchronize()
    assert k7.MODE_LAUNCHES["angles"] == n + 1
    for a, b in zip(got, k7.lw_noscat_broadband_angles(*args, secants, weights, inc)):
        assert torch.equal(a, b)
    for g, r in zip(got, k7.lw_noscat_broadband_angles_plain(*args, secants, weights, inc)):
        assert tuple(g.shape) == (ncol, nlay + 1) and bool(torch.isfinite(g).all())
        _close(g, r, 2e-6, LW_ATOL, f"K7 {nang} angles, {plan}")


@pytest.mark.parametrize("ngpt", [13, 128, 256])
def test_lw_noscat_per_gpoint_secants_and_strided_fields(dev, ngpt):
    """K7's angles mode with per-(column, g-point) secants and an incident
    flux, on fields read through a transposed view (layer-major storage),
    against its twin on contiguous copies."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    ncol, nlay = 37, 61
    args = _noscat_fields(dev, ncol, nlay, ngpt, seed=50)
    strided = [a.transpose(0, 1).contiguous().transpose(0, 1) for a in args[:3]] + list(args[3:])
    assert not strided[0].is_contiguous()
    rng = np.random.default_rng(51)
    ds = torch.as_tensor(rng.uniform(1.2, 2.8, (ncol, ngpt)), dtype=torch.float32, device=dev)
    inc = torch.as_tensor(rng.uniform(0.0, 2.0, (ncol, ngpt)), dtype=torch.float32, device=dev)
    got = k7.lw_noscat_broadband_angles(*strided, ds, [0.5], inc)
    for g, r in zip(got, k7.lw_noscat_broadband_angles_plain(*args, ds, [0.5], inc)):
        _close(g, r, 2e-6, LW_ATOL, "K7 per-g secants")


@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 61), (1800, 60)])
def test_lw_noscat_fields_mode_on_k6_fields(dev, ncol, nlay):
    """K7's fields mode on K6's layer-major output against the twin
    (ops/lw_solver.lw_broadband_sweeps) on the same fields, LW atol 2e-3
    W/m2; a second launch gives the same bits."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_broadband_sweeps

    args, emis = _prep_args(dev, ncol, nlay, seed=66)
    trans, src_dn, src_up, sfc = k6.lw_prep(*args)
    n = k7.MODE_LAUNCHES["fields"]
    got = k7.lw_broadband_sweeps_kernel(trans, src_dn, src_up, emis, sfc)
    torch.cuda.synchronize()
    assert k7.MODE_LAUNCHES["fields"] == n + 1
    again = k7.lw_broadband_sweeps_kernel(trans, src_dn, src_up, emis, sfc)
    assert torch.equal(got.flux_up, again.flux_up) and torch.equal(got.flux_dn, again.flux_dn)
    ref = lw_broadband_sweeps(trans, src_dn, src_up, emis, sfc)
    for g, r in ((got.flux_up, ref.flux_up), (got.flux_dn, ref.flux_dn)):
        assert tuple(g.shape) == (ncol, nlay + 1) and bool(torch.isfinite(g).all())
        _close(g, r, 2e-6, LW_ATOL, "K7 fields")


def test_lw_noscat_refuses_what_the_kernel_does_not_take(dev):
    """A CUDA tensor that is not float32, fields without contiguous
    g-points and more than four angles raise before any launch."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    args = list(_noscat_fields(dev, 5, 7, 32, seed=52))
    n = k7.LAUNCHES
    with pytest.raises(ValueError, match="float32"):
        k7.lw_noscat_broadband_angles(args[0].double(), *args[1:], [1.66], [0.5])
    with pytest.raises(ValueError, match="contiguous"):
        k7.lw_noscat_broadband_angles(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                                      *args[1:], [1.66], [0.5])
    with pytest.raises(ValueError, match="angles"):
        k7.lw_noscat_broadband_angles(*args, [1.66] * 5, [0.1] * 5)
    fields = [a.transpose(0, 1).contiguous() for a in args[:2]] + [args[2][:, :-1].transpose(0, 1)]
    with pytest.raises(ValueError, match="float32"):
        k7.lw_broadband_sweeps_kernel(*(f.double() for f in fields), *args[3:])
    assert k7.LAUNCHES == n


@pytest.mark.parametrize("top_at_1", [True, False])
def test_general_drivers_on_cuda_match_float64_cpu(dev, top_at_1):
    """Multi-angle LW (K3 once, K7 once for all angles) and the staged SW driver (K5)
    on CUDA against the same paths in float64 on the CPU."""
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    data = rfmip_data_from_arrays(synthesize_rfmip(29, 11, seed=44, top_at_1=top_at_1))
    cpu, f64 = torch.device("cpu"), torch.float64
    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    ref_lw = rfmip.rfmip_clear_sky_lw(data, [lw64], n_gauss_angles=3, device=cpu, dtype=f64)
    with config_override(use_megakernel=False):
        ref_sw = rfmip.rfmip_clear_sky_sw(data, [sw64, sw64], device=cpu, dtype=f64)
        lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
        n3, n5, n7 = (mlp.LAUNCHES["fused_predict_lw_both"], mlp.LAUNCHES["fused_predict_sw"],
                      k7.LAUNCHES)
        got_lw = rfmip.rfmip_clear_sky_lw(data, [lw], n_gauss_angles=3, device=dev)
        got_sw = rfmip.rfmip_clear_sky_sw(data, [sw, sw], device=dev)
        torch.cuda.synchronize()
    assert (mlp.LAUNCHES["fused_predict_lw_both"], mlp.LAUNCHES["fused_predict_sw"],
            k7.LAUNCHES) == (n3 + 1, n5 + 1, n7 + 1)
    for n in ("flux_up", "flux_dn", "flux_net"):
        assert getattr(got_lw, n).is_cuda
        assert _maxabs(getattr(got_lw, n), getattr(ref_lw, n)) <= LW_ATOL, n
    for n in ("flux_up", "flux_dn", "flux_dn_dir"):
        assert _maxabs(getattr(got_sw, n), getattr(ref_sw, n)) <= SW_ATOL, n


def test_sw_routes_on_the_real_pair_match_twin_and_float64(dev, tmp_path):
    """The SW main path on a real absorption + Rayleigh pair (the 48_48
    sw-synth56-lut nets on the synthetic 56-g-point k-distribution they
    were trained on; ssa spans [0, 1]): the fused route, K2 at ngpt = 56
    once a call, against its twin on the same CUDA tensors and against the
    port's float64 CPU run; the staged route, K5 once a call, within 2e-2
    W/m2 of float64 in every column with no resonance column excepted."""
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    cpu, f64 = torch.device("cpu"), torch.float64
    pair = testing.sw_pair_setup(str(tmp_path), "48_48", device=dev)
    pair64 = testing.sw_pair_setup(str(tmp_path), "48_48", device=cpu, dtype=f64)
    data = rfmip_data_from_arrays(synthesize_rfmip(300, 60, seed=0))
    kw = dict(spectral=pair["spectral"], solar_source=pair["solar"])
    ref = rfmip.rfmip_clear_sky_sw(data, pair64["models"], dtype=f64, device=cpu, **kw)
    solar = torch.as_tensor(pair["solar"], dtype=torch.float32, device=dev)
    args, _ = fused.sw_args(pair["models"], None,
                            *rfmip.sw_fused_inputs(solar, *rfmip.sw_canonical_inputs(data, dev)))
    n2, n5 = k2.LAUNCHES, mlp.LAUNCHES["fused_predict_sw"]
    got = k2.sw_clearsky_megakernel(*args)
    fb_fused = rfmip.rfmip_clear_sky_sw(data, pair["models"], device=dev, **kw)
    with config_override(use_megakernel=False):
        staged = rfmip.rfmip_clear_sky_sw(data, pair["models"], device=dev, **kw)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES - n2, mlp.LAUNCHES["fused_predict_sw"] - n5) == (2, 1)
    for a, b in zip(got, k2.sw_clearsky_megakernel_plain(*args)):
        assert _maxabs(a, b) <= SW_ATOL
    for fb in (fb_fused, staged):
        for n in ("flux_up", "flux_dn", "flux_dn_dir"):
            err = (getattr(fb, n).double().cpu() - getattr(ref, n)).abs().amax(1)
            assert float(err.max()) <= SW_ATOL, (n, int(err.argmax()), float(err.max()))


@pytest.mark.parametrize("flavour", ["lut", "pade"])
@pytest.mark.parametrize("width", ["128_128", "48_48"])
def test_cloud_modes_at_real_net_shapes_match_twins_and_float64(dev, tmp_path, width, flavour):
    """The cloud modes at the net shapes users run, on columns that all
    differ (testing.allsky_pair_setup, 300 x 60): K2 in the flavour's cloud
    mode at 56 g-points on the ``width`` pair (128_128: 256 threads in 2
    layer groups; 48_48: 512 in 4) and K1 in it on the 18 -> 64 -> 64 ->
    256 net, each against its twin on the same CUDA tensors, and
    launched once by the fused all-sky core, and without clouds equal to
    its clear mode within 1e-3 W/m2; the fused and staged all-sky
    cores within LW 2e-3 / SW 2e-2 W/m2 of the port's float64 CPU run in
    every column."""
    from rte_rrtmgp_nn_tpu_torch import testing

    cpu, f64 = torch.device("cpu"), torch.float64
    mode = {"lut": "cld_lut", "pade": "cld_bands"}[flavour]
    p = testing.allsky_pair_setup(str(tmp_path), width, 300, 60, 0, dev)
    p64 = testing.allsky_pair_setup(str(tmp_path), width, 300, 60, 0, cpu, f64)
    sargs, skw = fused.sw_args(*testing.allsky_pair_fused(p, "sw", flavour))
    largs, lkw = fused.lw_args(*testing.allsky_pair_fused(p, "lw", flavour))
    for kernel, plain, args, kw, tol in (
            (k2.sw_clearsky_megakernel, k2.sw_clearsky_megakernel_plain, sargs, skw, SW_ATOL),
            (k1.lw_clearsky_mega4, k1.lw_clearsky_mega4_plain, largs, lkw, LW_ATOL)):
        got = kernel(*args, **kw)
        for a, b in zip(got, plain(*args, **kw)):
            assert a.is_cuda and _maxabs(a, b) <= tol, kernel.__name__
        # the cloud combine's float32 guard: no cloud gives the clear mode's fluxes
        for a, b in zip(kernel(*args, **testing.without_clouds(kw)), kernel(*args)):
            assert _maxabs(a, b) <= 1e-3, kernel.__name__
    cores, refs = testing.allsky_pair_cores(p, flavour), testing.allsky_pair_cores(p64, flavour)
    ref = {"lw": refs["lw_lay_major"](), "sw": refs["sw_staged"]()}
    n1, n2 = k1.MODE_LAUNCHES[mode], k2.MODE_LAUNCHES[mode]
    out = {name: cores[name]() for name in ("lw_fused", "sw_fused", "lw_staged", "sw_staged")}
    torch.cuda.synchronize()
    assert (k1.MODE_LAUNCHES[mode] - n1, k2.MODE_LAUNCHES[mode] - n2) == (1, 1)
    for name, fb in out.items():
        lw = name.startswith("lw")
        for n in ("flux_up", "flux_dn", "flux_net") if lw else ("flux_up", "flux_dn",
                                                                "flux_dn_dir"):
            err = (getattr(fb, n).double().cpu() - getattr(ref["lw" if lw else "sw"], n)).abs()
            err = err.amax(1)
            assert float(err.max()) <= (LW_ATOL if lw else SW_ATOL), (
                name, n, int(err.argmax()), float(err.max()))


def _cloud_optics(spec, flavour, dev, seed=51, dtype=torch.float32):
    from rte_rrtmgp_nn_tpu_torch.extensions.cloud_optics import cloud_optics_from_arrays
    from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_cloud_optics

    return cloud_optics_from_arrays(
        synthesize_cloud_optics(spec, seed, flavour),
        SpectralMapping.bands_only(spec.band_lims_wvn_array), dev, dtype)


def _allsky_args(dev, ncol, nlay, seed, flavour):
    """((LW args, LW cloud keywords), (SW args, SW cloud keywords)) of the
    fused kernels on a synthesized atmosphere with the all-sky driver's
    clouds; the cloudy share of the cells."""
    from rte_rrtmgp_nn_tpu_torch.drivers import allsky

    d = synthesize_rfmip(ncol, nlay, seed)
    data = rfmip_data_from_arrays(d)
    lw_spec, sw_spec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    lw_co, sw_co = _cloud_optics(lw_spec, flavour, dev), _cloud_optics(sw_spec, flavour, dev)
    cld = allsky.cloud_fields_lay_major(d["play"], d["tlay"], lw_co, True, dev)
    table = planck.PlanckTable.compute(lw_spec.band_lims_wvn_array, device=dev)
    lw_in = rfmip.lw_canonical_inputs(data, lw_spec, dev)
    lw = fused.lw_args([load_model_netcdf(LW_MODEL, device=dev)], table, lw_spec, *lw_in,
                       (lw_co, cld))
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = rfmip.sw_canonical_inputs(data, dev)
    sw_model = load_model_netcdf(SW_MODEL, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spec), dtype=torch.float32, device=dev)
    mu0 = torch.full((ncol,), 0.86, device=dev)
    alb = torch.full((ncol, sw_spec.nband), 0.06, device=dev)
    sw = fused.sw_args([sw_model, sw_model], sw_spec, play_t, plev_t, tlay_t, mu0,
                       *fused.sw_boundary(sw_spec, solar, alb, alb), concs_t, (sw_co, cld))
    return lw, sw, float(((cld[0] > 0) | (cld[1] > 0)).float().mean())


@pytest.mark.parametrize("flavour,mode", [("lut", "cld_lut"), ("pade", "cld_bands")])
@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 60)])
def test_cloud_modes_match_twins(dev, ncol, nlay, flavour, mode):
    """K1 and K2 in each cloud mode against their twins: lookup-table cloud
    optics goes into the kernel as the four cloud fields, Pade cloud optics
    as band lanes; clouds are present and move the fluxes."""
    (lw, lw_kw), (sw, sw_kw), cloudy = _allsky_args(dev, ncol, nlay, 52, flavour)
    assert cloudy > 0.05
    n, nm = k1.LAUNCHES, k1.MODE_LAUNCHES[mode]
    got = k1.lw_clearsky_mega4(*lw, **lw_kw)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.MODE_LAUNCHES[mode]) == (n + 1, nm + 1)
    for a, b in zip(got, k1.lw_clearsky_mega4_plain(*lw, **lw_kw)):
        assert a.is_cuda and tuple(a.shape) == (ncol, nlay + 1)
        assert _maxabs(a, b) <= LW_ATOL
    clear = k1.lw_clearsky_mega4(*lw)
    assert _maxabs(got[1], clear[1]) > 1.0  # W/m2: the clouds are in the kernel's answer
    n, nm = k2.LAUNCHES, k2.MODE_LAUNCHES[mode]
    got = k2.sw_clearsky_megakernel(*sw, **sw_kw)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.MODE_LAUNCHES[mode]) == (n + 1, nm + 1)
    for a, b in zip(got, k2.sw_clearsky_megakernel_plain(*sw, **sw_kw)):
        assert a.is_cuda and tuple(a.shape) == (ncol, nlay + 1)
        assert _maxabs(a, b) <= SW_ATOL
    clear = k2.sw_clearsky_megakernel(*sw)
    assert _maxabs(got[2], clear[2]) > 1.0


def _mode_calls(dev, ncol, nlay, mode, seed):
    """[(kernel wrapper, plain twin, args, keywords, tolerance)] of K1 and K2
    in one mode of the four on one synthesized atmosphere."""
    lw, lwp = k1.lw_clearsky_mega4, k1.lw_clearsky_mega4_plain
    sw, swp = k2.sw_clearsky_megakernel, k2.sw_clearsky_megakernel_plain
    if mode in ("cld_lut", "cld_bands"):
        (la, lkw), (sa, skw), cloudy = _allsky_args(dev, ncol, nlay, seed,
                                                    "lut" if mode == "cld_lut" else "pade")
        assert cloudy > 0.02
        return [(lw, lwp, la, lkw, LW_ATOL), (sw, swp, sa, skw, SW_ATOL)]
    if mode == "clear":
        return [(lw, lwp, _lw_args(dev, ncol, nlay, seed), {}, LW_ATOL),
                (sw, swp, _sw_args(dev, ncol, nlay, seed + 1), {}, SW_ATOL)]
    spec = planck.lw_spectral_g128()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    args5 = rfmip.lw_mega5_args([load_model_netcdf(LW_MODEL, device=dev)], table, spec,
                                *rfmip.lw_canonical_inputs(data, spec, dev))
    sargs = list(_sw_args(dev, ncol, nlay, seed + 1))
    sargs[2] = [l.contiguous() for l in sargs[2].unbind(-1)]
    return [(k1.lw_clearsky_mega5, k1.lw_clearsky_mega5_plain, args5, {}, LW_ATOL),
            (sw, swp, sargs, dict(input_mode="lanes"), SW_ATOL)]


# neither 13 nor 61 layers divide into the kernels' four layer groups or
# their 16 layers per MLP pass: 4 + 4 + 4 + 1 and 16 + 16 + 16 + 13
@pytest.mark.parametrize("mode", ["clear", "cld_lut", "cld_bands", "lanes"])
@pytest.mark.parametrize("ncol,nlay", [(37, 13), (50, 61)])
def test_fused_kernels_every_mode_at_ragged_sizes(dev, ncol, nlay, mode):
    """K1 and K2 in each of their four modes against their twins where no
    layer group and no pass is full, and bit for bit the same from two
    launches on the same input (every sum has a fixed order)."""
    for fn, twin, args, kw, tol in _mode_calls(dev, ncol, nlay, mode, seed=61):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        again = fn(*args, **kw)
        for a, b, c in zip(got, twin(*args, **kw), again):
            assert a.is_cuda and tuple(a.shape) == (ncol, nlay + 1)
            assert bool(torch.isfinite(a).all())
            assert _maxabs(a, b) <= tol
            assert torch.equal(a, c)


def test_fused_kernels_take_their_launch_plan(dev):
    """The plan the wrappers hand to the launch entries is accepted at the
    sizes whose groups and slabs differ (the entry recomputes the shared
    memory and refuses a plan that disagrees), down to one layer."""
    for ncol, nlay in ((3, 1), (5, 2), (4, 5), (2, 33)):
        for fn, twin, args, kw, tol in _mode_calls(dev, ncol, nlay, "clear", seed=62):
            for a, b in zip(fn(*args, **kw), twin(*args, **kw)):
                assert _maxabs(a, b) <= tol


@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 60)])
def test_lane_modes_match_twins(dev, ncol, nlay):
    """K8 (the LW kernel on raw lanes, transform and scaling in the kernel)
    and K9 (the SW kernel with one array per feature) against their twins
    and against the stacked-input mode of the same kernel."""
    spec = planck.lw_spectral_g128()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed=53))
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    model = load_model_netcdf(LW_MODEL, device=dev)
    lw_in = rfmip.lw_canonical_inputs(data, spec, dev)
    args5 = rfmip.lw_mega5_args([model], table, spec, *lw_in)
    n, nm = k1.LAUNCHES, k1.MODE_LAUNCHES["lanes"]
    got = k1.lw_clearsky_mega5(*args5)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES, k1.MODE_LAUNCHES["lanes"]) == (n + 1, nm + 1)
    stacked = k1.lw_clearsky_mega4(*fused.lw_args([model], table, spec, *lw_in)[0])
    for a, b, c in zip(got, k1.lw_clearsky_mega5_plain(*args5), stacked):
        assert tuple(a.shape) == (ncol, nlay + 1)
        assert _maxabs(a, b) <= LW_ATOL and _maxabs(a, c) <= LW_ATOL
    sargs = list(_sw_args(dev, ncol, nlay, seed=54))
    stacked = k2.sw_clearsky_megakernel(*sargs)
    sargs[2] = [l.contiguous() for l in sargs[2].unbind(-1)]
    n, nm = k2.LAUNCHES, k2.MODE_LAUNCHES["lanes"]
    got = k2.sw_clearsky_megakernel(*sargs, input_mode="lanes")
    torch.cuda.synchronize()
    assert (k2.LAUNCHES, k2.MODE_LAUNCHES["lanes"]) == (n + 1, nm + 1)
    for a, b, c in zip(got, k2.sw_clearsky_megakernel_plain(*sargs, input_mode="lanes"), stacked):
        assert _maxabs(a, b) <= SW_ATOL
        assert _maxabs(a, c) == 0.0  # the same arithmetic on the same numbers


def _write_allsky_files(tmp_path, nlay, flavour, top_at_1=True):
    from rte_rrtmgp_nn_tpu_torch.testing import (
        cloud_optics_nc_variables, garand_nc_variables, synthesize_cloud_optics,
        synthesize_garand)
    from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc

    paths = {k: str(tmp_path / f"{k}-{flavour}.nc") for k in ("garand", "lw", "sw")}
    write_nc(paths["garand"], *garand_nc_variables(synthesize_garand(nlay, 55, top_at_1)))
    for k, spec in (("lw", planck.lw_spectral_g128()), ("sw", planck.sw_spectral_g112())):
        write_nc(paths[k], *cloud_optics_nc_variables(synthesize_cloud_optics(spec, 56, flavour)))
    return paths


@pytest.mark.parametrize("flavour,mode", [("lut", "cld_lut"), ("pade", "cld_bands")])
@pytest.mark.parametrize("top_at_1", [True, False])
def test_allsky_drivers_on_cuda_match_float64_cpu(dev, tmp_path, top_at_1, flavour, mode):
    """allsky_lw / allsky_sw on CUDA, on the fused route (one launch of K1
    or K2 in the cloud mode of the coefficient file's flavour) and on the
    staged routes (K3 then K7 once for all angles; K5), against the same request in
    float64 on the CPU."""
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import allsky_lw, allsky_sw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    paths = _write_allsky_files(tmp_path, 12, flavour, top_at_1)
    cpu, f64, ncol = torch.device("cpu"), torch.float64, 9
    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
    ref_lw = {n: allsky_lw(paths["garand"], paths["lw"], [lw64], ncol=ncol, n_gauss_angles=n,
                           device=cpu, dtype=f64) for n in (1, 3)}
    ref_sw = allsky_sw(paths["garand"], paths["sw"], [sw64, sw64], ncol=ncol, device=cpu,
                       dtype=f64)
    n1, n2 = k1.MODE_LAUNCHES[mode], k2.MODE_LAUNCHES[mode]
    got_lw = allsky_lw(paths["garand"], paths["lw"], [lw], ncol=ncol, device=dev)
    got_sw = allsky_sw(paths["garand"], paths["sw"], [sw, sw], ncol=ncol, device=dev)
    torch.cuda.synchronize()
    assert (k1.MODE_LAUNCHES[mode], k2.MODE_LAUNCHES[mode]) == (n1 + 1, n2 + 1)
    n3, n5, n7 = (mlp.LAUNCHES["fused_predict_lw_both"], mlp.LAUNCHES["fused_predict_sw"],
                  k7.LAUNCHES)
    got_lw3 = allsky_lw(paths["garand"], paths["lw"], [lw], ncol=ncol, n_gauss_angles=3,
                        device=dev)
    with config_override(use_megakernel=False):
        got_sw_staged = allsky_sw(paths["garand"], paths["sw"], [sw, sw], ncol=ncol, device=dev)
    torch.cuda.synchronize()
    assert (mlp.LAUNCHES["fused_predict_lw_both"], mlp.LAUNCHES["fused_predict_sw"],
            k7.LAUNCHES) == (n3 + 1, n5 + 1, n7 + 1)
    for got, ref in ((got_lw, ref_lw[1]), (got_lw3, ref_lw[3])):
        for n in ("flux_up", "flux_dn", "flux_net"):
            assert getattr(got, n).is_cuda
            assert _maxabs(getattr(got, n), getattr(ref, n)) <= LW_ATOL, n
    for got in (got_sw, got_sw_staged):
        for n in ("flux_up", "flux_dn", "flux_dn_dir"):
            assert _maxabs(getattr(got, n), getattr(ref_sw, n)) <= SW_ATOL, n


# -- K6, the parallel-scan routes, the lookup-table gas optics -------------------------

def _prep_args(dev, ncol, nlay, seed):
    from rte_rrtmgp_nn_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as go

    spec = planck.lw_spectral_g128()
    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, seed))
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    model = load_model_netcdf(LW_MODEL, device=dev)
    play_t, plev_t, tlay_t, tlev_t, tsfc, emis, concs_t = rfmip.lw_canonical_inputs(data, spec, dev)
    gases = GasConcs(concs_t)
    col_dry = go.get_col_dry_lay_major(gases.get_vmr("h2o", nlay, ncol), plev_t).contiguous()
    x = go.compute_nn_inputs(play_t, tlay_t, gases, model).contiguous()
    return (model, x, col_dry, table.interpolate(tlay_t), table.interpolate(tlev_t),
            table.interpolate(tsfc), spec.gpt2band_tensor(dev)), spec.expand(emis)


# no layer group and no MLP pass is full at 13 or 61 layers; one layer takes
# one group; 1800 x 60 is the RFMIP size
@pytest.mark.parametrize("ncol,nlay", [(37, 13), (37, 60), (37, 61), (5, 1), (1800, 60)])
def test_lw_prep_kernel_matches_twin(dev, ncol, nlay):
    """K6 against its twin: the transmittance to rtol 2e-5 (+1e-7 for opaque
    cells), the sources to 2e-5 of the largest g-point Planck source, beyond
    either float64 decides; the sweeps on its fields to 2e-3 W/m2; a second
    launch gives the same bits."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.lw_solver import lw_broadband_sweeps
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy, hold_kernel

    args, emis = _prep_args(dev, ncol, nlay, seed=61)
    n = k6.LAUNCHES
    got = k6.lw_prep(*args)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == n + 1
    for a, b in zip(got, k6.lw_prep(*args)):
        assert torch.equal(a, b)
    ref = k6.lw_prep_plain(*args)
    a64 = [float64_copy(args[0])] + [a.double() for a in args[1:6]] + [args[6]]
    ref64 = k6.lw_prep_plain(*a64)
    src_atol = 2e-5 * max(float(r.abs().max()) for r in ref[1:])
    for name, g, r, r64, rtol, atol in zip(("trans", "src_dn", "src_up", "sfc_src"), got, ref,
                                           ref64, (2e-5, 0, 0, 0), (1e-7,) + (src_atol,) * 3):
        assert g.is_cuda and g.shape == r.shape and bool(torch.isfinite(g).all()), name
        assert hold_kernel(g, r, r64, rtol, atol)["ok"], name
    fk, fp = lw_broadband_sweeps(*got[:3], emis, got[3]), lw_broadband_sweeps(*ref[:3], emis, ref[3])
    assert _maxabs(fk.flux_up, fp.flux_up) <= LW_ATOL and _maxabs(fk.flux_dn, fp.flux_dn) <= LW_ATOL


@pytest.mark.parametrize("top_at_1", [True, False])
def test_prep_core_on_cuda_matches_float64_cpu(dev, top_at_1):
    """_lw_core_prep on CUDA launches K6 once and K7's fields mode once and
    no other kernel, and agrees with itself in float64 on the CPU and with
    the fused driver."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_prep as k6
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    data = rfmip_data_from_arrays(synthesize_rfmip(29, 11, seed=62, top_at_1=top_at_1))
    spec = planck.lw_spectral_g128()
    cpu, f64 = torch.device("cpu"), torch.float64
    lw64, lw = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64), load_model_netcdf(LW_MODEL, device=dev)
    t64 = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=cpu, dtype=f64)
    ref = rfmip._lw_core_prep([lw64], t64, spec, *rfmip.lw_staged_inputs(data, spec, cpu, f64),
                              top_at_1=top_at_1)
    counts = lambda: (k6.LAUNCHES, k7.MODE_LAUNCHES["fields"], k7.LAUNCHES, k1.LAUNCHES,
                      sum(mlp.LAUNCHES.values()))
    before = counts()
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    got = rfmip._lw_core_prep([lw], table, spec, *rfmip.lw_staged_inputs(data, spec, dev),
                              top_at_1=top_at_1)
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before[:3]) + before[3:]
    fused = rfmip.rfmip_clear_sky_lw(data, [lw], device=dev)
    for n in ("flux_up", "flux_dn", "flux_net"):
        assert getattr(got, n).is_cuda
        assert _maxabs(getattr(got, n), getattr(ref, n)) <= LW_ATOL, n
        assert _maxabs(getattr(got, n), getattr(fused, n)) <= LW_ATOL, n


@pytest.mark.parametrize("band", ["lw", "sw", "allsky_lw", "allsky_sw"])
def test_parallel_scan_requests_on_cuda(dev, tmp_path, band):
    """scan_mode="parallel" on CUDA: the RFMIP and all-sky drivers take the
    general cores (K3 / K5 for the NN step; K7 only where the solve is
    broadband) and agree with the sequential request."""
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import allsky_lw, allsky_sw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
    data = rfmip_data_from_arrays(synthesize_rfmip(29, 11, seed=63))
    if band.startswith("allsky"):
        paths = _write_allsky_files(tmp_path, 12, "lut", True)
    calls = {
        "lw": lambda **kw: rfmip.rfmip_clear_sky_lw(data, [lw], device=dev, **kw),
        "sw": lambda **kw: rfmip.rfmip_clear_sky_sw(data, [sw, sw], device=dev, **kw),
        "allsky_lw": lambda **kw: allsky_lw(paths["garand"], paths["lw"], [lw], ncol=9, device=dev, **kw),
        "allsky_sw": lambda **kw: allsky_sw(paths["garand"], paths["sw"], [sw, sw], ncol=9, device=dev, **kw),
    }
    seq = calls[band]()
    before = (k1.LAUNCHES, k2.LAUNCHES, mlp.LAUNCHES["fused_predict_lw_both"],
              mlp.LAUNCHES["fused_predict_sw"], k7.LAUNCHES)
    par = calls[band](scan_mode="parallel")
    torch.cuda.synchronize()
    after = (k1.LAUNCHES, k2.LAUNCHES, mlp.LAUNCHES["fused_predict_lw_both"],
             mlp.LAUNCHES["fused_predict_sw"], k7.LAUNCHES)
    added = tuple(a - b for a, b in zip(after, before))
    assert added == {"lw": (0, 0, 1, 0, 1), "sw": (0, 0, 0, 1, 0), "allsky_lw": (0, 0, 1, 0, 0),
                     "allsky_sw": (0, 0, 0, 1, 0)}[band]
    atol = LW_ATOL if band.endswith("lw") else SW_ATOL
    for n in ("flux_up", "flux_dn"):
        assert _maxabs(getattr(par, n), getattr(seq, n)) <= atol, n


@pytest.mark.parametrize("top_at_1", [True, False])
def test_lut_gas_optics_on_cuda_matches_float64_cpu(dev, tmp_path, top_at_1):
    """The lookup-table gas optics on CUDA with rte_lw (K7 once a call,
    optimal angles, the two-stream solver after a cloud increment) and
    rte_sw behind it, against the same calls in float64 on the CPU, at 60
    layers: on coarser grids the float32 no-scattering solve itself (the
    source factor (1 - T)/tau - T near its series threshold) is about as
    far from float64 as the 2e-3 W/m2 bound, on the CPU too."""
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    cpu = torch.device("cpu")
    ref = testing.lut_reference_fluxes(str(tmp_path), 9, 60, seed=64, top_at_1=top_at_1,
                                       device=cpu, dtype=torch.float64)
    cpu32 = testing.lut_reference_fluxes(str(tmp_path), 9, 60, seed=64, top_at_1=top_at_1,
                                         device=cpu, dtype=torch.float32)
    n7 = k7.LAUNCHES
    got = testing.lut_reference_fluxes(str(tmp_path), 9, 60, seed=64, top_at_1=top_at_1,
                                       device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == n7 + 3  # 1 angle, 3 angles, the optimal-angle solve
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g.is_cuda and bool(torch.isfinite(g).all()), name
        err = (g.double().cpu() - ref[name]).abs()
        if name == "hr_lw":  # K/day: 2e-3 W/m2 across the thinnest layer is ~1 K/day
            assert float(err.max()) <= 1.0, name
        elif name.startswith("sw_"):
            # the two-stream coefficients are float64 (pifm_coefficients):
            # no column near the resonance k*mu0 = 1 is excepted
            assert float(err.max()) <= SW_ATOL, name
        else:
            # the two-stream LW source divides by tau and is ill-conditioned in
            # float32 for thin layers, on any device: where the CPU's float32
            # run is itself beyond the bound, twice its distance from float64
            # is the yardstick (testing.FLOAT32_SPREAD)
            own = float((cpu32[name].double() - ref[name]).abs().max())
            assert float(err.max()) <= max(LW_ATOL, testing.FLOAT32_SPREAD * own), name


@pytest.mark.parametrize("top_at_1", [True, False])
def test_lut_route_of_the_rfmip_drivers_on_cuda_matches_float64_cpu(dev, tmp_path, top_at_1):
    """rfmip_clear_sky_lw / _sw handed the synthetic 256 / 224 g-point
    k-distributions: on CUDA one K7 launch for LW, night SW exactly 0,
    against the same drivers in float64 on the CPU (the two-stream floor at
    config.dtype float64) to LW 2e-3 and SW 2e-2 W/m2, at 60 layers."""
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.config import config_override
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7

    paths = testing.write_lut_files(str(tmp_path), gpts_per_band=16, seed=65)
    a = testing.synthesize_rfmip_experiments(3, 4, 60, 66)
    a["sza"][::5] = 100.0  # night columns
    if not top_at_1:
        for f in ("play", "plev", "tlay", "tlev"):
            a[f] = np.ascontiguousarray(a[f][:, ::-1])
        a["gases"] = {g: np.ascontiguousarray(v[..., ::-1]) if v.ndim else v
                      for g, v in a["gases"].items()}
        a["top_at_1"] = False
    data = rfmip_data_from_arrays(a)

    def run(device, dtype):
        kd = {b: load_kdist(p, testing.LUT_GASES, dtype, device=device) for b, p in paths.items()}
        with config_override(dtype=dtype):
            return (rfmip.rfmip_clear_sky_lw(data, kd["lw"], dtype=dtype, device=device),
                    rfmip.rfmip_clear_sky_sw(data, kd["sw"], dtype=dtype, device=device))

    ref = run(torch.device("cpu"), torch.float64)
    n7 = k7.LAUNCHES
    got = run(dev, torch.float32)
    torch.cuda.synchronize()
    assert k7.LAUNCHES == n7 + 1
    night = torch.as_tensor(a["sza"] >= 90.0)
    assert float(got[1].flux_dn[night.to(dev)].abs().max()) == 0.0
    for g, r, atol in ((got[0], ref[0], LW_ATOL), (got[1], ref[1], SW_ATOL)):
        for n in ("flux_up", "flux_dn"):
            assert getattr(g, n).is_cuda and _maxabs(getattr(g, n), getattr(r, n)) <= atol, n


def _lut_setup(tmp_path, dev, ncol, nlay, seed):
    """The synthetic 256 / 224 g-point k-distributions on ``dev`` (float32)
    and on the CPU (float64), and RFMIP columns' lookup-table inputs."""
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist

    paths = testing.write_lut_files(str(tmp_path), gpts_per_band=16, seed=seed)
    data = synthesize_rfmip(ncol, nlay, seed + 1)
    out = {}
    for where, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        kd = {b: load_kdist(p, testing.LUT_GASES, dtype, device=where) for b, p in paths.items()}
        out[where.type] = (kd, testing.lut_inputs(data, where, dtype))
    return out


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_lut_optics_kernel_matches_twins(dev, tmp_path, band):
    """K10 (the lookup-table gas optics in one launch) against its twin on
    the same CUDA tensors and in float64 on the CPU, element by element, on
    the synthetic 256 / 224 g-point k-distributions at 60 layers: tau, and
    the Planck fraction (LW) or the single-scattering albedo (SW). Bound:
    2e-5 of each value plus 1e-6 of the field's largest (float32's rounding
    of ~40 operations; an index that two codes round apart at a grid edge
    moves a value continuously, by its weight's rounding)."""
    from rte_rrtmgp_nn_tpu_torch.gasoptics.lut_gas_optics import _col_gas
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lut_gas_optics as k10

    setup = _lut_setup(tmp_path, dev, 37, 60, seed=71)
    outs = {}
    for where in ("cuda", "cpu"):
        kd, (play, plev, tlay, _, _, _, gases) = setup[where]
        col_gas = _col_gas(kd[band], play, plev, gases, None)
        fn = {"lw": k10.lut_optics_lw, "sw": k10.lut_optics_sw}[band]
        twin = {"lw": k10.lut_optics_lw_plain, "sw": k10.lut_optics_sw_plain}[band]
        if where == "cuda":
            n = k10.LAUNCHES[band]
            outs["kernel"] = fn(kd[band], play, tlay, col_gas)
            torch.cuda.synchronize()
            assert k10.LAUNCHES[band] == n + 1
            outs["twin32"] = twin(kd[band], play, tlay, col_gas)
        else:
            outs["twin64"] = twin(kd[band], play, tlay, col_gas)
    for got, ref in zip(outs["kernel"], outs["twin64"]):
        assert got.is_cuda and bool(torch.isfinite(got).all())
        ref = ref.to(torch.float64)
        bound = 2e-5 * ref.abs() + 1e-6 * float(ref.abs().max())
        assert bool(((got.double().cpu() - ref).abs() <= bound).all())
    for got, twin in zip(outs["kernel"], outs["twin32"]):
        ref = twin.double().cpu()
        bound = 2e-5 * ref.abs() + 1e-6 * float(ref.abs().max())
        assert bool(((got.double().cpu() - ref).abs() <= bound).all())


@pytest.mark.parametrize("top_at_1", [True, False])
def test_sw_2stream_kernel_matches_twins(dev, top_at_1):
    """K11 (the broadband SW two-stream + adding solve) against its twin,
    ops/sw_solver.sw_2stream_broadband, on the same CUDA tensors and in
    float64 on the CPU, to the suite's SW bound 2e-2 W/m2: scattering layers
    (g up to 0.9), diffuse light at the top, both orientations, 224
    g-points, 60 layers, and columns at the k * mu0 = 1 resonance's side."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_2stream as k11

    gen = torch.Generator().manual_seed(72)
    ncol, nlay, ngpt = 41, 60, 224
    u = lambda *shape: torch.rand(*shape, generator=gen, dtype=torch.float64)
    tau = u(ncol, nlay, ngpt) ** 3 * 2.0
    ssa, g = u(ncol, nlay, ngpt), 0.9 * u(ncol, nlay, ngpt)
    mu0 = 0.05 + 0.95 * u(ncol)
    inc, alb_dir, alb_dif, inc_dif = 5.0 * u(ncol, ngpt), u(ncol, ngpt), u(ncol, ngpt), u(ncol, ngpt)
    args = (tau, ssa, g, mu0, inc, alb_dir, alb_dif, inc_dif)
    ref = k11.sw_2stream_broadband_kernel(*args, top_at_1=top_at_1)
    on_dev = [a.float().to(dev) for a in args]
    n = k11.LAUNCHES
    got = k11.sw_2stream_broadband_kernel(*on_dev, top_at_1=top_at_1)
    torch.cuda.synchronize()
    assert k11.LAUNCHES == n + 1
    twin32 = k11.sw_2stream_broadband_kernel(*[a.float() for a in args], top_at_1=top_at_1)
    for name, gt, r, t in zip(("up", "dn", "dir"), got, ref, twin32):
        assert gt.is_cuda and gt.shape == (ncol, nlay + 1), name
        assert _maxabs(gt, r) <= SW_ATOL, name
        assert _maxabs(gt, t) <= SW_ATOL, name


_LUT_LAUNCH_PROBE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from rte_rrtmgp_nn_tpu_torch import testing
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lut_gas_optics as k10
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_2stream as k11

dev = torch.device("cuda", 0)
paths = testing.write_lut_files(sys.argv[1], gpts_per_band=16, seed=73)
kd = {b: load_kdist(p, testing.LUT_GASES, torch.float32, device=dev) for b, p in paths.items()}
data = rfmip_data_from_arrays(testing.synthesize_rfmip_experiments(18, 5, 60, 74))

def call():
    lw = rfmip.rfmip_clear_sky_lw(data, kd["lw"], device=dev)
    sw = rfmip.rfmip_clear_sky_sw(data, kd["sw"], device=dev)
    return lw.flux_up.cpu(), sw.flux_up.cpu()

call()
torch.cuda.synchronize()
before = (dict(k10.LAUNCHES), k11.LAUNCHES, k7.LAUNCHES)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
print(json.dumps({
    "launches": [k10.LAUNCHES["lw"] - before[0]["lw"], k10.LAUNCHES["sw"] - before[0]["sw"],
                 k11.LAUNCHES - before[1], k7.LAUNCHES - before[2]],
    "device_ops": sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())}))
"""


def test_lut_route_of_the_rfmip_drivers_launches_few_device_operations(dev, tmp_path):
    """One rfmip_clear_sky_lw then _sw call on the lookup-table route, at
    the benchmark's 60 layers and 256 / 224 g-points: K10 twice, K11 once,
    K7 once, and fewer than 300 device operations (kernels, copies and
    memsets) in all, so that a profiled window of such calls stays
    readable; the per-layer tensor ops took some 2,800. Profiled in a
    process of its own: a profiler session here keeps a later test's
    session in this process from seeing the card's copies."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _LUT_LAUNCH_PROBE, str(tmp_path)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["launches"] == [1, 1, 1, 1]
    assert 4 <= got["device_ops"] < 300, got


# -- the GCM sweep ------------------------------------------------------------------------

@pytest.mark.parametrize("nlay", [20, 60])  # 60: the GCM cell's layers
@pytest.mark.parametrize("top_at_1", [True, False])
def test_gcm_sweeps_on_cuda_match_float64_cpu(dev, tmp_path, top_at_1, nlay):
    """gcm_sweep_allsky / gcm_sweep_lw on CUDA with a ragged last block: on
    the fused route one launch of K1 and one of K2 a block (lookup-table
    clouds), streamed equal to resident and to one block, mixed within 0.05
    W/m2 of f32, night SW exactly 0; against the same sweeps in float64 on
    the CPU to LW 2e-3 and SW 2e-2 W/m2 (at 20 layers too: ROADMAP Queue 3
    F7)."""
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked

    paths = _write_allsky_files(tmp_path, nlay, "lut", True)
    cpu, f64, block = torch.device("cpu"), torch.float64, 1024
    base = rfmip_data_from_arrays(synthesize_rfmip(64, nlay, 57))
    host = gcm.synthesize_gcm_columns(base, 3000, seed=58)  # blocks of 1024, 1024, 952
    if not top_at_1:
        host = {k: (v[:, ::-1].copy() if v.ndim == 2 else v) for k, v in host.items()}
    lw, sw = load_model_netcdf(LW_MODEL, device=dev), load_model_netcdf(SW_MODEL, device=dev)
    co = [load_cloud_optics_checked(paths[k], device=dev) for k in ("lw", "sw")]
    kw = dict(block_size=block, top_at_1=top_at_1, device=dev)
    n1, n2 = k1.MODE_LAUNCHES["cld_lut"], k2.MODE_LAUNCHES["cld_lut"]
    got = gcm.gcm_sweep_allsky(host, [lw], [sw, sw], *co, **kw)
    torch.cuda.synchronize()
    assert (k1.MODE_LAUNCHES["cld_lut"] - n1, k2.MODE_LAUNCHES["cld_lut"] - n2) == (3, 3)
    diag = got["diagnostics"]
    for other in (gcm.gcm_sweep_allsky(host, [lw], [sw, sw], *co, resident=True, **kw),
                  gcm.gcm_sweep_allsky(host, [lw], [sw, sw], *co, **dict(kw, block_size=3000))):
        np.testing.assert_array_equal(other["diagnostics"], diag)
    mixed = gcm.gcm_sweep_allsky(host, [lw], [sw, sw], *co, precision="mixed", **kw)
    assert np.abs(mixed["diagnostics"] - diag).max() <= 0.05
    night = np.cos(np.deg2rad(host["sza"])) <= 0.0
    assert night.any() and np.all(diag[night, 2] == 0.0)
    assert np.all(mixed["diagnostics"][night, 2] == 0.0)

    lw64 = load_model_netcdf(LW_MODEL, device=cpu, dtype=f64)
    sw64 = load_model_netcdf(SW_MODEL, device=cpu, dtype=f64)
    co64 = [load_cloud_optics_checked(paths[k], device=cpu, dtype=f64) for k in ("lw", "sw")]
    kw64 = dict(block_size=block, top_at_1=top_at_1, dtype=f64, device=cpu)
    ref = gcm.gcm_sweep_allsky(host, [lw64], [sw64, sw64], *co64, **kw64)["diagnostics"]
    assert np.abs(diag[:, :2] - ref[:, :2]).max() <= LW_ATOL
    assert np.abs(diag[:, 2] - ref[:, 2]).max() <= SW_ATOL
    n1 = k1.MODE_LAUNCHES["clear"]
    got = gcm.gcm_sweep_lw(host, [lw], **kw)["diagnostics"]
    torch.cuda.synchronize()
    assert k1.MODE_LAUNCHES["clear"] - n1 == 3
    ref = gcm.gcm_sweep_lw(host, [lw64], **kw64)["diagnostics"]
    assert np.abs(got - ref).max() <= LW_ATOL


@pytest.mark.parametrize("nlay", [20, 60])
def test_k1_on_gcm_columns_within_lw_atol_of_float64(dev, nlay):
    """ROADMAP Queue 3 F7: CUDA's float32 expf is high by 0.095 ulp on
    average (scripts/probe_lw_float32_ops.py); with it as the transmittance
    K1 and its twin on the card were 2.6-2.8e-3 W/m2 from float64 at 20
    layers. Both now take the transmittance in double, rounded once, and are
    held to float64 at LW_ATOL on 3000 GCM columns at 20 and 60 layers."""
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm

    ncol = 3000
    host = gcm.synthesize_gcm_columns(rfmip_data_from_arrays(synthesize_rfmip(64, nlay, 57)),
                                      ncol, seed=58)
    arrays = {k: host[k] for k in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis",
                                   "sfc_alb", "sza", "tsi")}
    arrays["gases"] = {k[4:]: v if v.ndim == 2 else np.repeat(v[:, None], nlay, axis=1)
                       for k, v in host.items() if k.startswith("gas:")}
    arrays["top_at_1"] = True
    data = rfmip_data_from_arrays(arrays)
    spec = planck.lw_spectral_g128()
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    model = load_model_netcdf(LW_MODEL, device=dev)
    args, _ = fused.lw_args([model], table, spec, *rfmip.lw_canonical_inputs(data, spec, dev))
    got = k1.lw_clearsky_mega4(*args)
    torch.cuda.synchronize()
    twin = k1.lw_clearsky_mega4_plain(*args)
    a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    a64[0] = testing.float64_copy(model)
    a64[9] = planck.PlanckTable(table.totplnk.double(), table.totplnk_diff.double(),
                                table.temp_ref_min, table.totplnk_delta)
    ref = k1.lw_clearsky_mega4_plain(*a64)
    for g, t, r in zip(got, twin, ref):
        assert _maxabs(g, r) <= LW_ATOL
        assert _maxabs(t, r) <= LW_ATOL


def _cuda_meshes():
    meshes = [("cuda:0", "cuda:0")]  # one card listed twice: two shares a block on one stager
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        meshes.append(tuple(f"cuda:{i}" for i in range(torch.cuda.device_count())))
    return meshes


@pytest.mark.parametrize("devices", _cuda_meshes(), ids=lambda d: "x".join(d))
def test_cuda_mesh_streams_as_no_mesh(dev, devices):
    """stream_reduce and gcm_sweep_lw over a CUDA mesh (a card listed twice
    takes 2 x 2 staging slots on one stager; several cards, one
    stager each, the shares joined on the first) give the result with no
    mesh: an elementwise step exactly, on ragged blocks, and the LW sweep's
    diagnostics within float32 noise."""
    from rte_rrtmgp_nn_tpu_torch.drivers import gcm
    from rte_rrtmgp_nn_tpu_torch.parallel.sharding import column_sharding, make_mesh
    from rte_rrtmgp_nn_tpu_torch.parallel.streaming import stream_reduce

    mesh = make_mesh(devices=list(devices))
    rng = np.random.default_rng(5)
    a = rng.standard_normal((1000, 7)).astype(np.float32)
    b = rng.standard_normal((1000,)).astype(np.float32)
    step = lambda x, y: (x * 2.0 + y[:, None], (x * y[:, None]).sum(1))
    builder = lambda n: [np.zeros((n, 7), np.float32), np.zeros((n,), np.float32)]
    want = stream_reduce(step, [a, b], 96, builder, device=dev)
    got = stream_reduce(step, [a, b], 96, builder, sharding=column_sharding(mesh, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(want[0], a * 2.0 + b[:, None])

    host = gcm.synthesize_gcm_columns(rfmip_data_from_arrays(synthesize_rfmip(64, 60, 57)),
                                      3000, seed=58)
    models = [load_model_netcdf(LW_MODEL, device=dev)]
    one = gcm.gcm_sweep_lw(host, models, block_size=1024, device=dev)["diagnostics"]
    split = gcm.gcm_sweep_lw(host, models, block_size=1024, mesh=mesh, device=dev)["diagnostics"]
    np.testing.assert_allclose(split, one, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtypes", [("float32",) * 4, ("float32", "int16")],
                         ids=["f32_fields", "mixed_pair"])
def test_stream_reduce_stages_each_block_in_one_copy(dev, dtypes):
    """stream_reduce over three blocks, the last ragged, through the
    field-major staging slot gives the CPU loop's result bit for bit: an
    f32 field set (two profiles, two per-column fields, one a strided view)
    and a mixed [float32, int16] pair, each field handed back whole beside
    an elementwise mix of two. A profiler window over a second sweep shows
    exactly one host-to-device copy a block."""
    from torch.profiler import ProfilerActivity, profile

    from rte_rrtmgp_nn_tpu_torch.parallel.streaming import stream_reduce

    rng = np.random.default_rng(21)
    ncol, block = 2600, 1000  # blocks of 1000, 1000 and 600
    widths = (60, None, 61, None) if len(dtypes) == 4 else (25, 40)
    arrays = []
    for w, dt in zip(widths, dtypes):
        shape = (ncol,) if w is None else (ncol, w)
        if dt == "int16":
            arrays.append(rng.integers(-2 ** 15, 2 ** 15, shape).astype(np.int16))
        else:
            arrays.append(rng.standard_normal(shape).astype(np.float32))
    if len(arrays) == 4:
        arrays[3] = arrays[2][:, 5]  # a per-column field as a strided view

    def step(*fields):
        first = fields[0][:, 0]
        return (*fields, first + fields[1].to(torch.float32).reshape(first.shape[0], -1)[:, 0])

    def builder(n):
        return [np.zeros((n,) + a.shape[1:], a.dtype) for a in arrays] + [np.zeros(n, np.float32)]

    want = stream_reduce(step, arrays, block, builder, device="cpu")
    got = stream_reduce(step, arrays, block, builder, device=dev)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, a)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stream_reduce(step, arrays, block, builder, device=dev)
        torch.cuda.synchronize(dev)
    assert sum("Memcpy HtoD" in e.name for e in prof.events()) == 3


def test_stream_reduce_never_overwrites_a_slot_still_read(dev):
    """stream_reduce over five blocks, the last ragged, with a step that
    first holds the card (``torch.cuda._sleep``) and then hands back views
    of its inputs: a slot refilled while its step or its results' copies
    still read it would show in the results, so they must equal the CPU
    loop's bit for bit. The four full blocks (~20 MB slots) are filled by
    the process's copy threads, one ``rte.stage.pool`` each where the
    process may run on more than one core; the ragged one (~6 MB) inline."""
    from torch.profiler import ProfilerActivity, profile

    from rte_rrtmgp_nn_tpu_torch.parallel import streaming

    rng = np.random.default_rng(23)
    block = 40_000
    ncol = 4 * block + 13_000
    arrays = [rng.standard_normal((ncol, 60)).astype(np.float32),
              rng.standard_normal((ncol, 61)).astype(np.float32),
              rng.standard_normal(ncol).astype(np.float32)]
    arrays.append(arrays[1][:, 7])  # a per-column field as a strided view

    def step(*fields):
        if fields[0].is_cuda:
            torch.cuda._sleep(20_000_000)  # ~10 ms: the next block's copy is queued meanwhile
        return (*fields, fields[0][:, 0] + fields[2])

    def builder(n):
        return [np.zeros((n,) + a.shape[1:], a.dtype) for a in arrays] + [np.zeros(n, np.float32)]

    want = streaming.stream_reduce(step, arrays, block, builder, device="cpu")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = streaming.stream_reduce(step, arrays, block, builder, device=dev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, a)
    threads = min(streaming._POOL_MAX_THREADS, len(os.sched_getaffinity(0)))
    assert sum(e.name == "rte.stage.pool" for e in prof.events()) == (4 if threads > 1 else 0)
    assert sum("Memcpy HtoD" in e.name for e in prof.events()) == 5


def _routes(dev):
    """The card's routes that keep a copy or a pointer of the weights:
    K1 (split), K2 (split), K3 (kernel net), as callables of the nets."""
    from rte_rrtmgp_nn_tpu_torch.config import config_override

    data = rfmip_data_from_arrays(synthesize_rfmip(37, 13, 4))

    def general(m):
        with config_override(use_megakernel=False):
            return rfmip.rfmip_clear_sky_lw(data, [m], device=dev)

    return {
        "k1": (LW_MODEL, lambda m: rfmip.rfmip_clear_sky_lw(data, [m], device=dev)),
        "k2": (SW_MODEL, lambda m: rfmip.rfmip_clear_sky_sw(data, [m, m], device=dev)),
        "k3": (LW_MODEL, general),
    }


@pytest.mark.parametrize("route", ["k1", "k2", "k3"])
@pytest.mark.parametrize("change", ["in_place", "load_state_dict", "swap"])
def test_kernel_routes_follow_changed_weights(dev, route, change):
    """ROADMAP Queue 3 F8 on the card: after the weights change in place,
    by load_state_dict or by a swapped tensor, a route's fluxes equal those
    of the same weights loaded fresh, bit for bit, and differ from the first
    call's."""
    path, run = _routes(dev)[route]
    m = load_model_netcdf(path, device=dev)
    first = run(m)
    other = load_model_netcdf(path, device=dev)
    with torch.no_grad():
        other.weights[0].mul_(1.05)
        other.biases[1].add_(0.01)
    if change == "in_place":
        with torch.no_grad():
            m.weights[0].mul_(1.05)
            m.biases[1].add_(0.01)
    elif change == "load_state_dict":
        m.load_state_dict(other.state_dict())
    else:
        m.weights[0].data = other.weights[0].detach().clone()
        m.biases[1].data = other.biases[1].detach().clone()
    got, fresh = run(m), run(other)
    for name in ("flux_up", "flux_dn"):
        assert torch.equal(getattr(got, name), getattr(fresh, name)), name
    assert _maxabs(got.flux_dn, first.flux_dn) > 1e-3


def test_kernels_refuse_weights_that_require_grad(dev):
    """No kernel has a backward: with grad enabled and trainable weights the
    card's routes refuse in words; under torch.no_grad() they run."""
    for route, (path, run) in _routes(dev).items():
        m = load_model_netcdf(path, device=dev)
        for p in m.parameters():
            p.requires_grad_(True)
        with pytest.raises(ValueError, match="has no backward"):
            run(m)
        with torch.no_grad():
            assert torch.isfinite(run(m).flux_dn).all(), route


@pytest.mark.parametrize("ncol,nlay", [(37, 13), (1800, 60)])
def test_sharded_cores_at_world_size_one_are_the_unsharded_cores(dev, ncol, nlay):
    """lw_mega_core_sharded / sw_mega_core_sharded on a process group of one
    (NCCL, in this process): bit for bit the unsharded fused cores, one K1
    and one K2 launch a call (the launch plan does not depend on the
    columns)."""
    import torch.distributed as dist

    from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist

    data = rfmip_data_from_arrays(synthesize_rfmip(ncol, nlay, 9))
    spec, sspec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    lw = load_model_netcdf(LW_MODEL, device=dev)
    sw = load_model_netcdf(SW_MODEL, device=dev)
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32, device=dev)
    li, si = rfmip.lw_canonical_inputs(data, spec, dev), rfmip.sw_canonical_inputs(data, dev)
    fl = fused.lw_core([lw], table, spec, *li, top_at_1=True)
    fs = rfmip._sw_core_mega_canon([sw, sw], solar, *si, top_at_1=True)
    pdist.initialize(f"127.0.0.1:{pdist.free_port()}", 1, 0, device=dev)
    try:
        mesh = pdist.global_mesh()
        assert mesh.ranks is not None and mesh.shape == {"col": 1, "gpt": 1}
        k1.LAUNCHES = k2.LAUNCHES = 0
        up, dn = rfmip.lw_mega_core_sharded(mesh, [lw], table, spec, True)(*li, gather=True)
        s = rfmip.sw_mega_core_sharded(mesh, [sw, sw], sspec, solar, True)(*si)
        torch.cuda.synchronize()
        assert (k1.LAUNCHES, k2.LAUNCHES) == (1, 1)
    finally:
        dist.destroy_process_group()
    assert torch.equal(up, fl.flux_up) and torch.equal(dn, fl.flux_dn)
    for got, want in zip(s, (fs.flux_up, fs.flux_dn, fs.flux_dn_dir)):
        assert torch.equal(got, want)


def test_sharded_cores_on_two_gloo_ranks_sharing_the_card(dev):
    """Two ranks on the one card (gloo; NCCL takes one rank a card): each
    rank's K1 and K2 launched once a call on its columns, the gathered
    fluxes bit for bit the unsharded cores'."""
    import _torch_rank_workers as W

    from rte_rrtmgp_nn_tpu_torch.parallel import distributed as pdist

    arrays = synthesize_rfmip(100, 60, 10)
    ranks = pdist.launch(W.sharded_cores, 2, arrays, LW_MODEL, SW_MODEL)
    data = rfmip_data_from_arrays(arrays)
    spec, sspec = planck.lw_spectral_g128(), planck.sw_spectral_g112()
    lw = load_model_netcdf(LW_MODEL, device=dev)
    sw = load_model_netcdf(SW_MODEL, device=dev)
    table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sspec), dtype=torch.float32, device=dev)
    fl = fused.lw_core([lw], table, spec,
                                    *rfmip.lw_canonical_inputs(data, spec, dev), top_at_1=True)
    fs = rfmip._sw_core_mega_canon([sw, sw], solar, *rfmip.sw_canonical_inputs(data, dev),
                                   top_at_1=True)
    want = {"lw": (fl.flux_up, fl.flux_dn), "sw": (fs.flux_up, fs.flux_dn, fs.flux_dn_dir)}
    for r, out in enumerate(ranks):
        assert out["device"] == "cuda:0" and (out["k1"], out["k2"]) == (2, 2)
        for k, ref in want.items():
            for block, whole, w in zip(out[k], out[k + "_all"], ref):
                w = w.cpu().numpy()
                np.testing.assert_array_equal(whole, w)
                np.testing.assert_array_equal(block, w[50 * r:50 * (r + 1)])
