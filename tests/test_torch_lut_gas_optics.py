"""The port's lookup-table gas optics against the JAX package's, on
synthetic k-distributions (the real files are not in the repository): the
loader with gas pruning and minor-gas reduction, the carry-over from arrays,
every kernel of ops/gas_optics_lut.py, both front ends with the fluxes
behind them, the optimal angles, the solar source and its wiring into the
SW driver, the solar-variability table, the boundary condition from a cap
layer and the heating rates.

Each comparison runs in float32 to rtol 1e-5 (the two frameworks round log,
exp and divides differently) and in float64 to rtol 1e-12 (the JAX package
runs x64 in its tests; the arithmetic is written in the same order, so only
the last bits of log and exp differ). Where an output sits behind the
interpolation fractions, which are differences of nearly equal numbers,
the bound is 5 times that (the kernels, the front ends) or 20 times (the
cap layer of compute_bc, one thin layer at the table's edge), with a
matching absolute floor scaled by the output's largest value. Fluxes: LW
2e-3, SW 2e-2 W/m2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu import gas_concs as jgc
from rte_rrtmgp_nn_tpu.gasoptics import kdist as jkdist
from rte_rrtmgp_nn_tpu.gasoptics import lut_gas_optics as jlut
from rte_rrtmgp_nn_tpu.gasoptics import synthetic as jsyn
from rte_rrtmgp_nn_tpu.ops import gas_optics_lut as jops
from rte_rrtmgp_nn_tpu_torch import gas_concs as pgc
from rte_rrtmgp_nn_tpu_torch.gasoptics import kdist as pkdist
from rte_rrtmgp_nn_tpu_torch.gasoptics import lut_gas_optics as plut
from rte_rrtmgp_nn_tpu_torch.gasoptics import synthetic as psyn
from rte_rrtmgp_nn_tpu_torch.ops import gas_optics_lut as pops
from rte_rrtmgp_nn_tpu_torch.utils.ncio import NCFile, write_nc
from test_torch_core import CPU

GASES = ["h2o", "co2", "o3", "n2o", "ch4"]
LW_ATOL, SW_ATOL = 2e-3, 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "float64": (jnp.float64, torch.float64, 1e-12)}
MINOR_META = ("limits_gpt", "scales_with_density", "scale_by_complement", "idx_minor",
              "idx_minor_scaling", "kminor_start")
META = ("gas_names", "press_ref_log", "temp_ref", "press_ref_trop_log", "flavor",
        "gpoint_flavor", "optimal_angle_fit", "tsi_default", "mg_default", "sb_default")
TABLES = ("vmr_ref", "kmajor", "krayl", "pfracin", "solar_quiet", "solar_facular",
          "solar_sunspot")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One LW and one SW synthetic k-distribution file, written by the
    port's generator."""
    d = tmp_path_factory.mktemp("kdist")
    out = {}
    for kind, nband in (("lw", 16), ("sw", 14)):
        out[kind] = str(d / f"synthetic-{kind}.nc")
        psyn.generate_kdist_nc(out[kind], kind=kind, gpts_per_band=4, nband=nband)
    return out


def kdist_arrays_from_jax(jkd) -> dict:
    """The arrays of a JAX KDist in the layout kdist_from_arrays takes."""
    a = lambda x: None if x is None else np.asarray(x)
    out = {n: getattr(jkd, n) for n in META}
    out.update({n: a(getattr(jkd, n)) for n in TABLES})
    out["spectral"] = port_spectral(jkd.spectral)
    for side in ("minor_lower", "minor_upper"):
        m = getattr(jkd, side)
        out[side] = dict(kminor=a(m.kminor), **{k: getattr(m, k) for k in MINOR_META})
    if jkd.planck is not None:
        out["totplnk"] = a(jkd.planck.totplnk)
    return out


def port_spectral(jspec):
    from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping

    return SpectralMapping.create(np.asarray(jspec.band_lims_gpt), jspec.band_lims_wvn_array)


def kdist_pair(path, dtype_name, gases=GASES):
    jdt, pdt, _ = DTYPES[dtype_name]
    return (jkdist.load_kdist(path, gases, dtype=jdt),
            pkdist.load_kdist(path, gases, dtype=pdt, device=CPU))


def atmosphere(dtype_name, ncol=4, nlay=20, seed=1, top_at_1=True):
    """(JAX arrays, port tensors) of one atmosphere: play, plev, tlay, tlev,
    tsfc and the gas concentrations."""
    jdt, pdt, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    plev = np.exp(np.linspace(np.log(40.0), np.log(101325.0), nlay + 1))
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).copy()
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    tlay = 220 + 70 * (play / play.max()) ** 0.3 + rng.uniform(-5, 5, (ncol, nlay))
    tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]), tlay[:, -1:]], 1)
    tsfc = tlev[:, -1] + rng.uniform(0, 5, ncol)
    h2o = 3e-3 * (play / play.max()) ** 1.5 + 1e-6
    arrs = [play, plev, tlay, tlev]
    if not top_at_1:
        arrs = [a[:, ::-1].copy() for a in arrs]
        h2o = h2o[:, ::-1].copy()
    np_dt = np.float32 if dtype_name == "float32" else np.float64
    arrs = [a.astype(np_dt) for a in arrs + [tsfc]]
    gases = {"h2o": h2o.astype(np_dt), "co2": np_dt(4e-4), "o3": np_dt(5e-7),
             "n2o": np_dt(3.2e-7), "ch4": np_dt(1.8e-6)}
    j = tuple(jnp.asarray(a, jdt) for a in arrs) + (jgc.GasConcs.create(
        {k: jnp.asarray(v, jdt) for k, v in gases.items()}),)
    p = tuple(torch.as_tensor(a, dtype=pdt) for a in arrs) + (pgc.GasConcs.create(
        {k: torch.as_tensor(v, dtype=pdt) for k, v in gases.items()}),)
    return j, p


def close(port, ref, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=name)


def assert_kdists_equal(pkd, jkd):
    for n in META:
        assert getattr(pkd, n) == getattr(jkd, n), n
    assert pkd.spectral.band_lims_gpt == jkd.spectral.band_lims_gpt
    assert pkd.spectral.band_lims_wvn == jkd.spectral.band_lims_wvn
    for n in TABLES:
        a, b = getattr(pkd, n), getattr(jkd, n)
        assert (a is None) == (b is None), n
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)
    for side in ("minor_lower", "minor_upper"):
        pm, jm = getattr(pkd, side), getattr(jkd, side)
        for k in MINOR_META:
            assert getattr(pm, k) == getattr(jm, k), (side, k)
        np.testing.assert_array_equal(pm.kminor.numpy(), np.asarray(jm.kminor))
    assert (pkd.planck is None) == (jkd.planck is None)
    if pkd.planck is not None:
        np.testing.assert_array_equal(pkd.planck.totplnk.numpy(), np.asarray(jkd.planck.totplnk))
        assert pkd.planck.temp_ref_min == jkd.planck.temp_ref_min
        assert pkd.planck.totplnk_delta == jkd.planck.totplnk_delta
    for n in ("ngas", "nflav", "neta", "npres", "ntemp", "ngpt", "nband", "is_internal_source",
              "press_ref_min", "press_ref_max", "temp_ref_min", "temp_ref_max",
              "press_ref_log_delta", "temp_ref_delta"):
        assert getattr(pkd, n) == getattr(jkd, n), n


# -- the generator and the loader ----------------------------------------------------

@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_generators_write_the_same_file(tmp_path, files, kind):
    """The port's copy of the synthetic generator writes what the JAX
    package's writes, variable by variable."""
    ref = str(tmp_path / "jax.nc")
    jsyn.generate_kdist_nc(ref, kind=kind, gpts_per_band=4, nband=16 if kind == "lw" else 14)
    with NCFile(ref) as a, NCFile(files[kind]) as b:
        names = sorted(a._nc3.variables)
        assert names == sorted(b._nc3.variables)
        for n in names:
            np.testing.assert_array_equal(a.read(n), b.read(n), err_msg=n)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_load_kdist_matches_jax(files, kind, dtype_name):
    jkd, pkd = kdist_pair(files[kind], dtype_name)
    assert pkd.kmajor.dtype == DTYPES[dtype_name][1]
    assert_kdists_equal(pkd, jkd)
    assert pkd.ngpt == (64 if kind == "lw" else 56)
    assert pkd.minor_lower.n_minor == 2 and pkd.minor_upper.n_minor == 1
    assert tuple(pkd.gpoint_flavor_index.shape) == (pkd.ngpt, 2)
    assert tuple(pkd.flavor_index.shape) == (pkd.nflav, 2)


def test_gas_pruning_and_minor_reduction(files):
    """Without n2o and ch4 the lower atmosphere loses both minor intervals
    and their kminor columns; a GasConcs names the gases as well."""
    jkd, pkd = kdist_pair(files["lw"], "float32", gases=["h2o", "co2", "o3"])
    assert_kdists_equal(pkd, jkd)
    assert pkd.gas_names == ("h2o", "co2", "o3")
    assert pkd.minor_lower.n_minor == 0 and pkd.minor_lower.kminor.shape[-1] == 0
    assert pkd.minor_upper.n_minor == 1 and tuple(pkd.vmr_ref.shape) == (2, 4, 14)
    gc = pgc.GasConcs.create({"h2o": 1e-3, "carbon_dioxide": 4e-4, "ozone": 1e-6, "n2o": 3e-7})
    assert pkdist.load_kdist(files["lw"], gc, device=CPU).gas_names == ("h2o", "co2", "o3", "n2o")


def test_missing_key_gas_raises(files):
    with pytest.raises(ValueError, match="key species"):
        pkdist.load_kdist(files["lw"], ["h2o", "co2"], device=CPU)
    with pytest.raises(ValueError, match="key species"):
        jkdist.load_kdist(files["lw"], ["h2o", "co2"])


def test_zero_key_band_resolves_in_reduced_space(tmp_path):
    """A band without key species takes the second gas of the REDUCED
    list, as in the JAX loader."""
    p = str(tmp_path / "zero.nc")
    gases = ("n2o", "h2o", "co2", "o3", "ch4")
    psyn.generate_kdist_nc(p, kind="lw", gases=gases, gpts_per_band=2, nband=4,
                           key_pairs=[(2, 3), (0, 0), (3, 4), (2, 2)])
    keep = ["h2o", "co2", "o3"]
    jkd, pkd = jkdist.load_kdist(p, keep), pkdist.load_kdist(p, keep, device=CPU)
    assert_kdists_equal(pkd, jkd)
    assert (2, 2) in pkd.flavor


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_kdist_from_arrays_carries_a_jax_kdist_over(files, kind):
    """kdist_from_arrays on the arrays of a JAX KDist gives the KDist the
    port loads from the file, and ``to`` moves every table."""
    jkd, pkd = kdist_pair(files[kind], "float32")
    carried = pkdist.kdist_from_arrays(kdist_arrays_from_jax(jkd), CPU)
    assert_kdists_equal(carried, jkd)
    assert carried.spectral == pkd.spectral
    moved = pkd.to("meta")
    for n in TABLES:
        assert getattr(moved, n) is None or getattr(moved, n).device.type == "meta", n
    assert moved.minor_lower.kminor.device.type == "meta"
    assert moved.gpoint_flavor_index.device.type == "meta"
    if kind == "lw":
        assert moved.planck.totplnk.device.type == "meta"


# -- the kernels of ops/gas_optics_lut.py ---------------------------------------------

def _state(files, kind, dtype_name, **kw):
    """Both packages' (kdist, atmosphere, col_dry, col_gas, interpolation)."""
    from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry as jcd
    from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import get_col_dry as pcd

    jkd, pkd = kdist_pair(files[kind], dtype_name)
    ja, pa = atmosphere(dtype_name, **kw)
    out = []
    for kd, a, cd, ops in ((jkd, ja, jcd, jops), (pkd, pa, pcd, pops)):
        play, plev, tlay, tlev, tsfc, gc = a
        col_dry = cd(gc.get_vmr("h2o", *play.shape), plev)
        col_gas = ops.compute_col_gas(kd, gc, col_dry)
        out.append((kd, a, col_dry, col_gas, ops.interpolation(kd, play, tlay, col_gas)))
    return out


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_interpolation_matches_jax(files, dtype_name):
    rtol = DTYPES[dtype_name][2]
    (jkd, ja, _, jcg, jic), (pkd, pa, _, pcg, pic) = _state(files, "lw", dtype_name)
    close(pcg, jcg, rtol, name="col_gas")
    for n in ("jtemp", "jpress", "tropo", "jeta"):
        np.testing.assert_array_equal(getattr(pic, n).numpy(), np.asarray(getattr(jic, n)), n)
    # the fractions are differences of nearly equal numbers: absolute bounds
    for n in ("ftemp", "fpress", "feta"):
        close(getattr(pic, n), getattr(jic, n), 0.0, 100 * rtol, n)
    close(pic.col_mix, jic.col_mix, rtol, name="col_mix")
    assert tuple(pic.jeta.shape) == (4, 20, pkd.nflav, 2)
    assert bool(pic.tropo.any()) and not bool(pic.tropo.all())


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("kernel", ["tau_major", "tau_minor_lower", "tau_minor_upper",
                                    "tau_absorption", "tau_rayleigh", "planck_source"])
def test_lut_kernels_match_jax(files, kernel, dtype_name):
    rtol = DTYPES[dtype_name][2]
    # interpolation fractions differ by rounding between the frameworks;
    # the tables vary slowly, so outputs agree to a few times rtol
    rtol = 5 * rtol
    kind = "sw" if kernel == "tau_rayleigh" else "lw"
    outs = []
    for ops, (kd, a, col_dry, col_gas, ic) in zip((jops, pops), _state(files, kind, dtype_name)):
        play, plev, tlay, tlev, tsfc, gc = a
        idx_h2o = 1 + kd.gas_names.index("h2o")
        zeros = 0.0 * ops.tau_major(kd, ic)
        if kernel == "tau_major":
            o = [ops.tau_major(kd, ic)]
        elif kernel == "tau_minor_lower":
            o = [ops.tau_minor_one_atmos(kd, kd.minor_lower, True, ic, play, tlay, col_gas,
                                         idx_h2o, zeros)]
        elif kernel == "tau_minor_upper":
            o = [ops.tau_minor_one_atmos(kd, kd.minor_upper, False, ic, play, tlay, col_gas,
                                         idx_h2o, zeros)]
        elif kernel == "tau_absorption":
            o = [ops.compute_tau_absorption(kd, ic, play, tlay, col_gas)]
        elif kernel == "tau_rayleigh":
            o = [ops.compute_tau_rayleigh(kd, ic, col_gas, col_dry)]
        else:
            o = list(ops.compute_planck_source(kd, ic, tlay, tlev, tsfc, True, save_pfrac=True))
        outs.append(o)
    for i, (r, g) in enumerate(zip(*outs)):
        assert float(g.abs().max()) > 0.0
        close(g, r, rtol, atol=rtol * float(g.abs().max()) * 1e-3, name=f"{kernel}[{i}]")
    if kernel.startswith("tau_minor"):
        # each atmosphere's minors touch only its own layers and g-points
        g, (_, _, _, _, ic) = outs[1][0], _state(files, kind, dtype_name)[1]
        lower = kernel.endswith("lower")
        assert float(g[~ic.tropo if lower else ic.tropo].abs().max()) == 0.0
        assert float(g[..., 8 if lower else 4:].abs().max()) == 0.0


def test_tau_minor_does_not_modify_its_input(files):
    (_, (kd, a, _, col_gas, ic)) = _state(files, "lw", "float32")
    tau = torch.ones((4, 20, kd.ngpt))
    out = pops.tau_minor_one_atmos(kd, kd.minor_lower, True, ic, a[0], a[2], col_gas, 1, tau)
    assert float(out.max()) > 1.0 and bool((tau == 1.0).all())


# -- the front ends, with the fluxes behind them ---------------------------------------

@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("top_at_1", [True, False])
def test_gas_optics_lw_lut_and_fluxes_match_jax(files, top_at_1, dtype_name):
    from rte_rrtmgp_nn_tpu.rte import rte_lw as jrte_lw
    from rte_rrtmgp_nn_tpu_torch.rte import rte_lw as prte_lw

    jdt, pdt, rtol = DTYPES[dtype_name]
    rtol = 5 * rtol
    jkd, pkd = kdist_pair(files["lw"], dtype_name)
    ja, pa = atmosphere(dtype_name, top_at_1=top_at_1)
    sols = []
    for lut, rte, kd, (play, plev, tlay, tlev, tsfc, gc), ones in (
            (jlut, jrte_lw, jkd, ja, lambda s: jnp.full(s, 0.97, jdt)),
            (plut, prte_lw, pkd, pa, lambda s: torch.full(s, 0.97, dtype=pdt))):
        props, src = lut.gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev,
                                           top_at_1=top_at_1, save_pfrac=True)
        interp, _ = lut.gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, top_at_1=top_at_1)
        ds = lut.compute_optimal_angles(kd, props.tau)
        emis = ones((play.shape[0], kd.nband))
        sols.append((props, src, interp, ds,
                     rte(props, top_at_1, src, emis, broadband=True),
                     rte(props, top_at_1, src, emis, n_gauss_angles=3, broadband=True),
                     rte(props, top_at_1, src, emis, lw_ds=ds, broadband=True)))
    (jp, js, ji, jds, *jsol), (pp, ps, pi, pds, *psol) = sols
    scale = float(pp.tau.max())
    close(pp.tau, jp.tau, rtol, atol=rtol * scale * 1e-3, name="tau")
    close(pi.tau, ji.tau, rtol, atol=rtol * scale * 1e-3, name="tau, tlev interpolated")
    for n in ("lay_source", "lev_source", "sfc_source", "sfc_source_jac", "planck_frac"):
        g = getattr(ps, n)
        close(g, getattr(js, n), rtol, atol=rtol * float(g.abs().max()) * 1e-3, name=n)
    np.testing.assert_allclose(ps.planck_frac.sum(-1).numpy(), pkd.nband, rtol=1e-5)
    close(pds, jds, rtol, name="optimal angles")
    assert 1.0 <= float(pds.min()) and float(pds.max()) <= 1.77 + 1e-6
    for g, r in zip(psol, jsol):
        close(g.flux_up, r.flux_up, 0.0, LW_ATOL, "flux_up")
        close(g.flux_dn, r.flux_dn, 0.0, LW_ATOL, "flux_dn")
    assert tuple(psol[0].flux_up.shape) == (4, 21)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("top_at_1", [True, False])
def test_gas_optics_sw_lut_and_fluxes_match_jax(files, top_at_1, dtype_name):
    from rte_rrtmgp_nn_tpu.rte import rte_sw as jrte_sw
    from rte_rrtmgp_nn_tpu_torch.rte import rte_sw as prte_sw

    jdt, pdt, rtol = DTYPES[dtype_name]
    rtol = 5 * rtol
    jkd, pkd = kdist_pair(files["sw"], dtype_name)
    ja, pa = atmosphere(dtype_name, top_at_1=top_at_1)
    sols = []
    for lut, rte, kd, (play, plev, tlay, tlev, tsfc, gc), full in (
            (jlut, jrte_sw, jkd, ja, lambda s, v: jnp.full(s, v, jdt)),
            (plut, prte_sw, pkd, pa, lambda s, v: torch.full(s, v, dtype=pdt))):
        props, src = lut.gas_optics_sw_lut(kd, play, plev, tlay, gc, tsi=1361.0)
        ncol = play.shape[0]
        alb = full((ncol, kd.ngpt), 0.2)
        sols.append((props, src, rte(props, top_at_1, full((ncol,), 0.6), src.toa_source, alb,
                                     alb, broadband=True)))
    (jp, jsrc, jsol), (pp, psrc, psol) = sols
    close(pp.tau, jp.tau, rtol, atol=rtol * float(pp.tau.max()) * 1e-3, name="tau")
    close(pp.ssa, jp.ssa, rtol, atol=rtol, name="ssa")
    assert float(pp.g.abs().max()) == 0.0
    close(psrc.toa_source, jsrc.toa_source, rtol, name="toa_source")
    np.testing.assert_allclose(psrc.toa_source.sum(-1).numpy(), 1361.0, rtol=1e-6)
    for n in ("flux_up", "flux_dn", "flux_dn_dir"):
        close(getattr(psol, n), getattr(jsol, n), 0.0, SW_ATOL, n)
    toa = 0 if top_at_1 else -1
    np.testing.assert_allclose(psol.flux_dn[:, toa].numpy(), 0.6 * 1361.0, rtol=1e-5)


def test_col_dry_override(files):
    _, pkd = kdist_pair(files["lw"], "float32")
    _, (play, plev, tlay, tlev, tsfc, gc) = atmosphere("float32")
    base, _ = plut.gas_optics_lw_lut(pkd, play, plev, tlay, tsfc, gc)
    from rte_rrtmgp_nn_tpu_torch.gasoptics.nn_gas_optics import get_col_dry

    col_dry = get_col_dry(gc.get_vmr("h2o", *play.shape), plev)
    twice, _ = plut.gas_optics_lw_lut(pkd, play, plev, tlay, tsfc, gc, col_dry=2.0 * col_dry)
    np.testing.assert_allclose(twice.tau.numpy(), 2.0 * base.tau.numpy(), rtol=1e-5)


# -- the solar source --------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_solar_source_matches_jax(files, dtype_name):
    rtol = DTYPES[dtype_name][2]
    jkd, pkd = kdist_pair(files["sw"], dtype_name)
    for kw in ({}, dict(tsi=1361.5), dict(mg_index=0.16, sb_index=500.0),
               dict(mg_index=0.15, sb_index=1200.0, tsi=1359.0)):
        close(pkd.solar_source(**kw), jkd.solar_source(**kw), rtol, name=str(kw))
    assert not np.allclose(pkd.solar_source().numpy(), pkd.solar_quiet.numpy())


def test_resolve_solar_source_tiers(files):
    """The three tiers of resolve_solar_source against the JAX function:
    matching g-points, the band remap (per-band totals kept), no kdist; a
    band mismatch raises."""
    from rte_rrtmgp_nn_tpu.drivers.rfmip import resolve_solar_source as jres
    from rte_rrtmgp_nn_tpu.gasoptics.planck import _mapping_from_counts as jmap
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import default_solar_source
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import resolve_solar_source as pres
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import _mapping_from_counts as pmap
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112

    jkd, pkd = kdist_pair(files["sw"], "float64")
    src = pres(pkd.spectral, pkd)
    np.testing.assert_allclose(src, pkd.solar_source().numpy(), rtol=1e-12)
    np.testing.assert_allclose(src, jres(jkd.spectral, jkd), rtol=1e-12)
    np.testing.assert_allclose(pres(pkd.spectral, pkd, tsi=1350.0, mg_index=0.16, sb_index=700.0),
                               jres(jkd.spectral, jkd, tsi=1350.0, mg_index=0.16, sb_index=700.0),
                               rtol=1e-12)
    lims = pkd.spectral.band_lims_wvn_array
    jt, pt = jmap((2,) * pkd.nband, lims), pmap((2,) * pkd.nband, lims)
    remapped = pres(pt, pkd)
    np.testing.assert_allclose(remapped, jres(jt, jkd), rtol=1e-12)
    for ib in range(pkd.nband):
        (s, e), (ks, ke) = pt.band_lims_gpt[ib], pkd.spectral.band_lims_gpt[ib]
        np.testing.assert_allclose(remapped[s:e].sum(), src[ks:ke].sum(), rtol=1e-10)
    _, lw = kdist_pair(files["lw"], "float32")
    with pytest.raises(ValueError, match="band structure differs"):
        pres(lw.spectral, pkd)
    spec = sw_spectral_g112()
    np.testing.assert_array_equal(pres(spec), default_solar_source(spec))
    np.testing.assert_array_equal(pres(spec, lw), default_solar_source(spec))  # no solar terms


def test_sw_driver_with_kdist(files):
    """rfmip_clear_sky_sw(kdist=...) of both packages on a 14-band, 112
    g-point remap of the synthetic file's solar terms: equal to passing the
    resolved source, different from the default source, and the port within
    2e-2 W/m2 of the JAX driver."""
    from rte_rrtmgp_nn_tpu.drivers.rfmip import rfmip_clear_sky_sw as jsw
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import resolve_solar_source
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_sw as psw
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
    from test_torch_core import SW_MODEL, model_pair, rfmip_pair

    jkd, pkd = kdist_pair(files["sw"], "float32")
    jd, pd = rfmip_pair(synthesize_rfmip(6, 8, seed=41))
    jm, pm = model_pair(SW_MODEL)
    with_kd = psw(pd, [pm, pm], kdist=pkd, device="cpu")
    explicit = psw(pd, [pm, pm], solar_source=resolve_solar_source(sw_spectral_g112(), pkd),
                   device="cpu")
    default = psw(pd, [pm, pm], device="cpu")
    ref = jsw(jd, [jm, jm], kdist=jkd)
    for n in ("flux_up", "flux_dn", "flux_dn_dir"):
        np.testing.assert_array_equal(getattr(with_kd, n).numpy(), getattr(explicit, n).numpy())
        close(getattr(with_kd, n), getattr(ref, n), 0.0, SW_ATOL, n)
    assert float((with_kd.flux_dn - default.flux_dn).abs().max()) > 1e-2


def test_solar_variability_matches_jax(tmp_path):
    from rte_rrtmgp_nn_tpu.extensions.solar_variability import SolarVar as JSV
    from rte_rrtmgp_nn_tpu_torch.extensions.solar_variability import SolarVar as PSV

    rng = np.random.default_rng(7)
    nfrac = 134
    tbl = np.stack([0.15 + 0.02 * rng.random(nfrac), 1000.0 * rng.random(nfrac)], axis=1)
    p = str(tmp_path / "solar-var.nc")
    write_nc(p, {"n_solar_frac": nfrac, "n_solar_terms": 2},
             {"solar_var_avgcyc": (("n_solar_frac", "n_solar_terms"), tbl)})
    j, q = JSV.load(p), PSV.load(p)
    np.testing.assert_array_equal(q.avgcyc_ind, j.avgcyc_ind)
    for frac in (0.0, 1.0, 0.001, 1.0 / 264, 0.25, 0.5, 0.77, 1.0 - 1.0 / 264, 0.9999):
        assert q.ind_interp(frac) == j.ind_interp(frac), frac
    assert q.ind_interp(0.0) == (tbl[0, 0], tbl[0, 1])
    with pytest.raises(ValueError, match="out of range"):
        q.ind_interp(1.5)


# -- compute_bc and heating rates ----------------------------------------------------

@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", ["lw_top_at_1", "lw_bottom_first", "sw"])
def test_compute_bc_matches_jax(files, case, dtype_name):
    from rte_rrtmgp_nn_tpu.extensions.compute_bc import compute_bc as jbc
    from rte_rrtmgp_nn_tpu_torch.extensions.compute_bc import compute_bc as pbc

    jdt, pdt, rtol = DTYPES[dtype_name]
    kind = case[:2]
    top_at_1 = case != "lw_bottom_first"
    jkd, pkd = kdist_pair(files[kind], dtype_name)
    ja, pa = atmosphere(dtype_name, top_at_1=top_at_1)
    top = 0 if top_at_1 else -1
    outs = []
    for bc, kd, (play, plev, tlay, tlev, tsfc, gc), full in (
            (jbc, jkd, ja, lambda v: jnp.full((4,), v, jdt)),
            (pbc, pkd, pa, lambda v: torch.full((4,), v, dtype=pdt))):
        mu0 = full(0.8) if kind == "sw" else None
        outs.append(bc(kd, tlay[:, top], plev[:, top], gc, mu0=mu0, top_at_1=top_at_1))
    ref, got = outs
    assert tuple(got.shape) == (4, pkd.ngpt) and float(got.min()) >= 0.0
    close(got, ref, 20 * rtol, atol=20 * rtol * float(got.max()), name=case)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_heating_rates_match_jax(dtype_name):
    from rte_rrtmgp_nn_tpu.extensions import heating_rates as jhr
    from rte_rrtmgp_nn_tpu_torch.extensions import heating_rates as phr

    jdt, pdt, rtol = DTYPES[dtype_name]
    rng = np.random.default_rng(9)
    up, dn = rng.uniform(100, 400, (3, 9)), rng.uniform(100, 400, (3, 9))
    plev = np.sort(rng.uniform(10.0, 1e5, (3, 9)), axis=1)
    j = [jnp.asarray(a, jdt) for a in (up, dn, plev)]
    p = [torch.as_tensor(a, dtype=pdt) for a in (up, dn, plev)]
    got = phr.compute_heating_rate(*p)
    assert tuple(got.shape) == (3, 8)
    # the net flux differences cancel: bound by the fluxes over the thinnest layer
    atol = rtol * 9.80665 / 1004.64 * 800.0 / float(np.diff(plev, axis=1).min())
    close(got, jhr.compute_heating_rate(*j), rtol, atol, "K/s")
    close(phr.compute_heating_rate_kday(*p), jhr.compute_heating_rate_kday(*j), rtol,
          atol * 86400.0, "K/day")
    assert phr.SECONDS_PER_DAY == jhr.SECONDS_PER_DAY == 86400.0


def test_kdist_dataclasses_are_frozen(files):
    _, pkd = kdist_pair(files["lw"], "float32")
    with pytest.raises(dataclasses.FrozenInstanceError):
        pkd.kmajor = None
