"""The port's cloud optics, its netCDF writing and the Garand reader against
the JAX package on the same numpy inputs: lookup-table and Pade cloud
optics as two-stream and absorption properties for every ice roughness,
with radii at and beyond both ends of the valid range and cells without
cloud (tau, ssa, g to rtol 1e-5); coefficient files written with the JAX
package's write_nc and read by both loaders; the idealized cloud
placement; the synthetic coefficient tables' ranges.

Also holds the helpers test_torch_allsky.py imports."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import allsky as jallsky
from rte_rrtmgp_nn_tpu.drivers.allsky_io import read_garand as jread_garand
from rte_rrtmgp_nn_tpu.extensions import cloud_optics as jco
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.utils import ncio as jncio
from rte_rrtmgp_nn_tpu_torch.drivers import allsky as pallsky
from rte_rrtmgp_nn_tpu_torch.drivers.allsky_io import read_garand as pread_garand
from rte_rrtmgp_nn_tpu_torch.extensions import cloud_optics as pco
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping
from rte_rrtmgp_nn_tpu_torch.testing import (
    cloud_optics_nc_variables, garand_nc_variables, synthesize_cloud_optics, synthesize_garand)
from rte_rrtmgp_nn_tpu_torch.utils import ncio as pncio
from test_torch_core import CPU, close

SPECS = {"lw": (jplanck.lw_spectral_g128, pplanck.lw_spectral_g128),
         "sw": (jplanck.sw_spectral_g112, pplanck.sw_spectral_g112)}


def write_cloud_file(path, which, seed, flavour, writer=pncio.write_nc):
    """A synthetic coefficient file for the ``which`` ("lw"/"sw") bands;
    ``flavour`` "lut", "pade" or "both"."""
    spec = SPECS[which][1]()
    arrays = {}
    for fl in (("lut", "pade") if flavour == "both" else (flavour,)):
        arrays.update(synthesize_cloud_optics(spec, seed, fl))
    writer(str(path), *cloud_optics_nc_variables(arrays))
    return str(path)


def jax_cloud_optics_arrays(co) -> dict:
    """The fields of a JAX CloudOptics as numpy arrays and numbers."""
    out = {}
    for f in dataclasses.fields(co):
        v = getattr(co, f.name)
        if f.name != "spectral" and v is not None:
            out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return out


def cloud_optics_pair(tmp_path, which, seed, flavour):
    """(JAX CloudOptics, port CloudOptics) of one synthetic coefficient
    file: the JAX loader reads it, and the port's data is made from the
    JAX object's arrays (cloud_optics_from_arrays)."""
    path = write_cloud_file(tmp_path / f"co-{which}-{flavour}-{seed}.nc", which, seed, flavour)
    j = jco.load_cloud_optics(path)
    spec = SpectralMapping.bands_only(np.asarray(j.spectral.band_lims_wvn_array))
    return j, pco.cloud_optics_from_arrays(jax_cloud_optics_arrays(j), spec, CPU)


def cloud_fields(co, rng, shape=(6, 7)):
    """Water paths and radii with cloud-free cells (wp = 0, re = 0) and
    radii at and beyond both ends of the valid range."""
    def phase(lo, hi):
        wp = rng.uniform(0.0, 40.0, shape) * (rng.uniform(0, 1, shape) > 0.3)
        re = rng.uniform(lo - 0.4 * (hi - lo), hi + 0.4 * (hi - lo), shape)
        re.flat[:4] = (lo, hi, lo - 1.0, hi + 1.0)
        wp.flat[:4] = 5.0
        return wp.astype(np.float32), np.where(wp > 0, np.maximum(re, 0.5), 0.0).astype(np.float32)

    lwp, rel = phase(co.radliq_lwr, co.radliq_upr)
    iwp, rei = phase(co.radice_lwr, co.radice_upr)
    assert ((lwp == 0) & (iwp > 0)).any() and ((lwp > 0) & (iwp == 0)).any()
    return lwp, iwp, rel, rei


@pytest.mark.parametrize("icergh", [1, 2, 3])
@pytest.mark.parametrize("as_2str", [True, False], ids=["2str", "1scl"])
@pytest.mark.parametrize("flavour", ["lut", "pade"])
def test_cloud_optics_matches_jax(tmp_path, rng, flavour, as_2str, icergh):
    j, p = cloud_optics_pair(tmp_path, "sw", 61, flavour)
    j, p = j.set_ice_roughness(icergh), p.set_ice_roughness(icergh)
    assert p.is_lut == j.is_lut == (flavour == "lut") and p.icergh == icergh
    fields = cloud_fields(p, rng)
    ref = jco.cloud_optics(j, *(jnp.asarray(a) for a in fields), as_2str=as_2str)
    got = pco.cloud_optics(p, *(torch.from_numpy(a) for a in fields), as_2str=as_2str)
    assert type(got).__name__ == type(ref).__name__
    assert got.spectral.nband == got.spectral.ngpt == p.nband
    # tau, ssa, g (or the absorption tau, a difference) to rtol 1e-5
    close(got.tau, ref.tau, atol=1e-6)
    if as_2str:
        close(got.ssa, ref.ssa, atol=1e-7)
        close(got.g, ref.g, atol=1e-7)
        clear = (fields[0] == 0) & (fields[1] == 0)
        assert clear.any() and (got.tau.numpy()[clear] == 0).all()
        assert float(got.tau.max()) > 1.0


def test_ice_roughness_changes_the_answer_and_is_range_checked(tmp_path, rng):
    _, p = cloud_optics_pair(tmp_path, "lw", 62, "lut")
    fields = [torch.from_numpy(a) for a in cloud_fields(p, rng)]
    a = pco.cloud_optics(p.set_ice_roughness(1), *fields).tau
    b = pco.cloud_optics(p.set_ice_roughness(3), *fields).tau
    assert float((a - b).abs().max()) > 1e-3
    for bad in (0, 4):
        with pytest.raises(ValueError, match="out of range"):
            p.set_ice_roughness(bad)


@pytest.mark.parametrize("prefer", ["lut", "pade"])
@pytest.mark.parametrize("flavour", ["lut", "pade", "both"])
def test_load_cloud_optics_reads_what_jax_reads(tmp_path, flavour, prefer):
    """A file written with the JAX package's write_nc, read by both
    loaders: the same flavour is chosen and every field is equal."""
    path = write_cloud_file(tmp_path / "co.nc", "lw", 63, flavour, writer=jncio.write_nc)
    j = jco.load_cloud_optics(path, prefer=prefer)
    p = pco.load_cloud_optics(path, prefer=prefer, device=CPU)
    assert p.is_lut == j.is_lut == (flavour == "lut" or (flavour == "both" and prefer == "lut"))
    assert p.spectral.band_lims_wvn == j.spectral.band_lims_wvn
    for name, ref in jax_cloud_optics_arrays(j).items():
        got = getattr(p, name)
        if torch.is_tensor(got):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        else:
            assert got == ref, name
    absent = pco.PADE_FIELDS + pco.SIZREG_FIELDS if p.is_lut else pco.LUT_FIELDS
    assert all(getattr(p, n) is None for n in absent)
    p64 = p.to(CPU, torch.float64)
    assert (p64.lut_extliq if p.is_lut else p64.pade_extliq).dtype == torch.float64


def test_write_nc_and_chararray_match_jax(tmp_path, rng):
    """The port's write_nc writes the file the JAX package's does (each
    reader reads the other's file), and the char-array layout is equal."""
    data = {"a": (("x", "y"), rng.uniform(0, 1, (3, 4))),
            "b": (("y",), rng.uniform(0, 1, 4).astype(np.float32)),
            "names": (("x", "w"), pncio.strings_to_chararray(["tlay", "h2o", "o3"], 8))}
    dims = {"x": 3, "y": 4, "w": 8}
    np.testing.assert_array_equal(pncio.strings_to_chararray(["tlay", "carbon_dioxide"], 6),
                                  jncio.strings_to_chararray(["tlay", "carbon_dioxide"], 6))
    pncio.write_nc(str(tmp_path / "sub" / "p.nc"), dims, data, attrs={"title": "t"})
    jncio.write_nc(str(tmp_path / "j.nc"), dims, data, attrs={"title": "t"})
    for path, reader in ((tmp_path / "sub" / "p.nc", jncio.NCFile), (tmp_path / "j.nc", pncio.NCFile)):
        with reader(str(path)) as f:
            assert f.read("a").dtype.itemsize == 8 and f.read("b").dtype.itemsize == 4
            np.testing.assert_array_equal(f.read("a"), data["a"][1])
            np.testing.assert_array_equal(f.read("b"), data["b"][1])
            assert f.read_strings("names") == ["tlay", "h2o", "o3"]
            assert f.dim_size("y") == 4


@pytest.mark.parametrize("top_at_1", [True, False])
def test_read_garand_tiles_the_columns_like_jax(tmp_path, top_at_1):
    """ncol = 5 is not a multiple of the file's two columns."""
    path = str(tmp_path / "garand.nc")
    arrays = synthesize_garand(9, 64, top_at_1)
    pncio.write_nc(path, *garand_nc_variables(arrays))
    j, p = jread_garand(path, 5), pread_garand(path, 5)
    assert (p.ncol, p.nlay) == (j.ncol, j.nlay) == (5, 9)
    for n in ("play", "plev", "tlay", "tlev"):
        np.testing.assert_array_equal(getattr(p, n), getattr(j, n), err_msg=n)
    np.testing.assert_array_equal(p.play[4], arrays["p_lay"][:, 0].astype(np.float32))
    assert bool(p.play[0, 0] < p.play[0, -1]) == top_at_1
    assert p.gas_concs.gas_names == j.gas_concs.gas_names
    for g in p.gas_concs.gas_names:
        np.testing.assert_array_equal(p.gas_concs.get_raw(g).numpy(),
                                      np.asarray(j.gas_concs.get_raw(g)), err_msg=g)


def test_make_clouds_matches_jax_and_places_every_kind(tmp_path):
    """The idealized cloud placement on numpy arrays and on tensors; the
    synthetic Garand profiles give liquid-only, ice-only, mixed and clear
    layers."""
    j, p = cloud_optics_pair(tmp_path, "lw", 65, "lut")
    path = str(tmp_path / "garand.nc")
    pncio.write_nc(path, *garand_nc_variables(synthesize_garand(10, 66)))
    atm = pread_garand(path, 7)
    ref = jallsky.make_clouds(atm.play, atm.tlay, j)
    got = pallsky.make_clouds(atm.play, atm.tlay, p)
    got_t = pallsky.make_clouds(torch.from_numpy(atm.play), torch.from_numpy(atm.tlay), p)
    mask = np.arange(7) % 2
    ref_m = jallsky.make_clouds(atm.play, atm.tlay, j, cloud_col=mask)
    got_m = pallsky.make_clouds(torch.from_numpy(atm.play), torch.from_numpy(atm.tlay), p,
                                cloud_col=torch.from_numpy(mask))
    for r, g, gt, rm, gm in zip(ref, got, got_t, ref_m, got_m):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(gt.numpy(), r)
        np.testing.assert_array_equal(gm.numpy(), rm)
    lwp, iwp, rel, rei = got
    assert (lwp[2::3] == 0).all() and (iwp[2::3] == 0).all()  # every third column is clear
    kinds = [(lwp > 0) & (iwp == 0), (lwp == 0) & (iwp > 0), (lwp > 0) & (iwp > 0),
             (lwp == 0) & (iwp == 0)]
    assert all(k.any() for k in kinds)
    assert set(np.unique(rel)) == {0.0, 12.0} and set(np.unique(rei)) == {0.0, 95.0}
    lay = pallsky.cloud_fields_lay_major(atm.play, atm.tlay, p, True, CPU)
    np.testing.assert_array_equal(lay[0].numpy(), lwp.T)


@pytest.mark.parametrize("which", ["lw", "sw"])
@pytest.mark.parametrize("flavour", ["lut", "pade"])
def test_synthetic_coefficients_are_physical(which, flavour):
    """ext > 0, 0 < ssa < 1, 0 < g < 1 over the whole radius range, every
    roughness: read through cloud_optics with a unit water path."""
    spec = SPECS[which][1]()
    co = pco.cloud_optics_from_arrays(synthesize_cloud_optics(spec, 67, flavour),
                                      SpectralMapping.bands_only(spec.band_lims_wvn_array), CPU,
                                      torch.float64)
    n = 400
    one, zero = torch.ones((1, n), dtype=torch.float64), torch.zeros((1, n), dtype=torch.float64)
    rel = torch.linspace(co.radliq_lwr, co.radliq_upr, n, dtype=torch.float64)[None]
    rei = torch.linspace(co.radice_lwr, co.radice_upr, n, dtype=torch.float64)[None]
    cases = [(co, (one, zero, rel, zero))]
    cases += [(co.set_ice_roughness(r), (zero, one, zero, rei)) for r in (1, 2, 3)]
    for c, fields in cases:
        op = pco.cloud_optics(c, *fields)
        assert float(op.tau.min()) > 0 and bool(torch.isfinite(op.tau).all())
        assert 0 < float(op.ssa.min()) and float(op.ssa.max()) < 1
        assert 0 < float(op.g.min()) and float(op.g.max()) < 1
    if flavour == "pade":  # all three size regimes are reached
        assert set(pco._pade_irad(rel, co.pade_sizreg_extliq).unique().tolist()) == {0, 1, 2}
        assert set(pco._pade_irad(rei, co.pade_sizreg_extice).unique().tolist()) == {0, 1, 2}


def test_cloud_lut_pack_is_made_once_per_data_and_device(tmp_path):
    _, p = cloud_optics_pair(tmp_path, "sw", 68, "lut")
    liq, ice, geom = p.lut_pack
    assert p.lut_pack[0] is liq  # kept with the object, on its device
    assert p.to(CPU, torch.float64).lut_pack[0] is not liq  # a new object packs anew
    nband = p.nband
    assert tuple(liq.shape) == (20, 3 * nband) and tuple(ice.shape) == (18, 3 * nband)
    assert liq.is_contiguous() and liq.dtype == torch.float32
    np.testing.assert_array_equal(liq[:, nband:2 * nband].numpy(), p.lut_ssaliq.numpy().T)
    np.testing.assert_array_equal(ice[:, :nband].numpy(), p.lut_extice[0].numpy().T)
    assert geom == (2.5, 1.0, 10.0, 10.0)
    rough = p.set_ice_roughness(2)
    np.testing.assert_array_equal(rough.lut_pack[1][:, :nband].numpy(),
                                  p.lut_extice[1].numpy().T)
    _, pade = cloud_optics_pair(tmp_path, "sw", 68, "pade")
    with pytest.raises(ValueError, match="lookup-table"):
        pade.lut_pack
