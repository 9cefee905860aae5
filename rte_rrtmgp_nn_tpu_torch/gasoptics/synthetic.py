"""Synthetic k-distribution generator (copy of
rte_rrtmgp_nn_tpu/gasoptics/synthetic.py, which cannot be imported without
JAX; numpy only).

The real RRTMGP k-distribution files are staged from an external archive by
the reference's CI (``_stage_files.py``) and are not shipped in-repo. This
module builds physically-plausible synthetic k-distributions -- correct
structure, realistic magnitudes, smooth pressure/temperature/eta
dependencies, Planck tables computed from physics -- and writes them in the
exact reference netCDF format (the variable set of
``examples/mo_load_coefficients.F90:104-250``). They serve as the offline
oracle for exercising and validating the complete LUT gas-optics code path
(loading, gas pruning, minor-gas reduction, flavors, interpolation, tau,
sources), not as a substitute for the real spectroscopy.
"""
from __future__ import annotations

import numpy as np

from ..utils import ncio
from .planck import (
    LW_BAND_LIMS_WVN,
    SW_BAND_LIMS_WVN,
    planck_band_radiance,
    solar_band_fractions,
)

# RRTMGP-standard reference grids
PRESS_REF = np.exp(np.linspace(np.log(109663.0), np.log(1.005), 59))  # Pa, decreasing
TEMP_REF = np.linspace(160.0, 355.0, 14)
PRESS_REF_TROP = 9948.5  # Pa
NETA = 9


def _k_profile(rng, ngpt_band, base_lo, base_hi, ntemp, npres_plus1, neta):
    """Smooth absorption-coefficient block (ntemp, npres+1, neta, ngpt_band):
    g-points ascending in k (correlated-k ordering), mild T/p/eta shape."""
    k0 = np.logspace(base_lo, base_hi, ngpt_band)  # per-gpt base magnitude
    t = np.linspace(-1, 1, ntemp)[:, None, None, None]
    p = np.linspace(-1, 1, npres_plus1)[None, :, None, None]
    e = np.linspace(-1, 1, neta)[None, None, :, None]
    a_t, a_p, a_e = rng.uniform(0.1, 0.5), rng.uniform(0.2, 0.8), rng.uniform(0.1, 0.4)
    shape = np.exp(a_t * t + a_p * p + a_e * e * (1 - e))
    return k0[None, None, None, :] * shape


def generate_kdist_nc(
    path: str,
    kind: str = "lw",
    gases=("h2o", "co2", "o3", "n2o", "ch4"),
    gpts_per_band: int = 4,
    nband: int | None = None,
    seed: int = 0,
    pfrac_uniform: bool = False,
    key_pairs=None,
) -> None:
    """Write a synthetic k-distribution file (netCDF-3 classic).

    key_pairs optionally overrides the per-band key-species pairs (list of
    (lo, hi) 1-based gas indices, cycled over bands; (0, 0) = no key gas)
    -- used by loader tests that need specific gases to be non-key so they
    can be pruned.

    pfrac_uniform=True writes a (T, p, eta)-independent Planck fraction
    (1/gpts_per_band): use for oracle tests whose closed-form answer needs
    vertically homogeneous pfrac (e.g. isothermal blackbody). The default
    varies pfrac smoothly in all table axes (band-normalized) so parity
    tests can see the 3-D interpolation weights and level/layer pairing."""
    rng = np.random.default_rng(seed)
    band_lims_all = LW_BAND_LIMS_WVN if kind == "lw" else SW_BAND_LIMS_WVN
    nband = nband or len(band_lims_all)
    band_lims = band_lims_all[:nband]
    ngpt = nband * gpts_per_band
    ngas = len(gases)
    ntemp, npres, neta = len(TEMP_REF), len(PRESS_REF), NETA
    nT_planck = 196

    # band -> g-point limits, 1-based inclusive
    band2gpt = np.stack(
        [np.arange(nband) * gpts_per_band + 1, (np.arange(nband) + 1) * gpts_per_band], 1
    )

    # key species: cycle through gas pairs; include a (0,0) "no gas" band
    # (rewritten to (2,2) by the loader) when there are >= 4 bands.
    # only h2o/co2/o3 are key species; n2o/ch4 stay minor-only so pruning
    # them exercises the minor-reduction path without failing key checks
    key_species = np.zeros((nband, 2, 2), dtype=np.int32)  # C (nbnd, atm, pair)
    if key_pairs is not None:
        for ib in range(nband):
            key_species[ib, 0] = key_species[ib, 1] = key_pairs[ib % len(key_pairs)]
    else:
        pairs = [(1, 2), (1, 3), (3, 3), (2, 2), (1, 1), (2, 3)]
        for ib in range(nband):
            lo = pairs[ib % len(pairs)]
            hi = pairs[(ib + 1) % len(pairs)]
            key_species[ib, 0] = lo
            key_species[ib, 1] = hi
        if nband >= 4:
            key_species[3, :, :] = 0  # exercise the (0,0)->(2,2) rewrite

    # vmr_ref (C order: ntemp, 1+ngas, 2)
    ref_vmr = {"h2o": 5e-3, "co2": 4e-4, "o3": 5e-7, "n2o": 3.3e-7, "ch4": 1.8e-6}
    vmr_ref = np.ones((ntemp, 1 + ngas, 2))
    for i, g in enumerate(gases):
        vmr_ref[:, 1 + i, :] = ref_vmr.get(g, 1e-6)

    # kmajor (C: ntemp, npres+1, neta, ngpt) ~ tau O(0.01-3) per layer
    kmajor = np.zeros((ntemp, npres + 1, neta, ngpt))
    for ib in range(nband):
        s, e = ib * gpts_per_band, (ib + 1) * gpts_per_band
        blk = _k_profile(rng, gpts_per_band, -24.5, -21.5, ntemp, npres + 1, neta)
        kmajor[..., s:e] = blk

    # minor gases: two lower (one density-scaled, one complement-scaled by
    # h2o) and one upper, covering the scaling branches
    gas_minor = ["n2o", "ch4", "o3"]
    identifier_minor = ["n2o", "ch4", "o3"]
    minors_lower = [("n2o", (1, gpts_per_band), True, False, "h2o"),
                    ("ch4", (gpts_per_band + 1, 2 * gpts_per_band), True, True, "h2o")]
    minors_upper = [("o3", (1, gpts_per_band), False, False, "")]

    def build_minor(specs):
        names, limits, swd, sbc, scl, kstart = [], [], [], [], [], []
        rows = 0
        blocks = []
        for name, (g1, g2), wd, bc, sg in specs:
            names.append(name)
            limits.append((g1, g2))
            swd.append(wd)
            sbc.append(bc)
            scl.append(sg)
            kstart.append(rows + 1)  # 1-based
            ng = g2 - g1 + 1
            blocks.append(_k_profile(rng, ng, -25.0, -23.0, ntemp, 1, neta)[:, 0])
            rows += ng
        kminor = np.concatenate(blocks, axis=-1) if blocks else np.zeros((ntemp, neta, 0))
        return names, np.array(limits, np.int32), np.array(swd, np.int32), np.array(sbc, np.int32), scl, np.array(kstart, np.int32), kminor

    (mg_lo, lim_lo, swd_lo, sbc_lo, scl_lo, ks_lo, kminor_lower) = build_minor(minors_lower)
    (mg_up, lim_up, swd_up, sbc_up, scl_up, ks_up, kminor_upper) = build_minor(minors_upper)

    dims = {
        "temperature": ntemp,
        "pressure": npres,
        "absorber": ngas,
        "minor_absorber": len(gas_minor),
        "absorber_ext": ngas + 1,
        "mixing_fraction": neta,
        "atmos_layer": 2,
        "bnd": nband,
        "gpt": ngpt,
        "pair": 2,
        "minor_absorber_intervals_lower": len(mg_lo),
        "minor_absorber_intervals_upper": len(mg_up),
        "temperature_Planck": nT_planck,
        "contributors_lower": kminor_lower.shape[-1],
        "contributors_upper": kminor_upper.shape[-1],
        "string_len": 32,
        "fit_coeffs": 2,
    }
    variables = {
        "gas_names": (("absorber", "string_len"), ncio.strings_to_chararray(list(gases), 32)),
        "key_species": (("bnd", "atmos_layer", "pair"), key_species),
        "bnd_limits_wavenumber": (("bnd", "pair"), band_lims.astype(np.float64)),
        "bnd_limits_gpt": (("bnd", "pair"), band2gpt.astype(np.int32)),
        "press_ref": (("pressure",), PRESS_REF),
        "temp_ref": (("temperature",), TEMP_REF),
        "absorption_coefficient_ref_P": ((), np.float64(1.0)),
        "absorption_coefficient_ref_T": ((), np.float64(250.0)),
        "press_ref_trop": ((), np.float64(PRESS_REF_TROP)),
        "kminor_lower": (("temperature", "mixing_fraction", "contributors_lower"),
                         kminor_lower),
        "kminor_upper": (("temperature", "mixing_fraction", "contributors_upper"),
                         kminor_upper),
        "gas_minor": (("minor_absorber", "string_len"), ncio.strings_to_chararray(gas_minor, 32)),
        "identifier_minor": (("minor_absorber", "string_len"), ncio.strings_to_chararray(identifier_minor, 32)),
        "minor_gases_lower": (("minor_absorber_intervals_lower", "string_len"), ncio.strings_to_chararray(mg_lo, 32)),
        "minor_gases_upper": (("minor_absorber_intervals_upper", "string_len"), ncio.strings_to_chararray(mg_up, 32)),
        "minor_limits_gpt_lower": (("minor_absorber_intervals_lower", "pair"), lim_lo),
        "minor_limits_gpt_upper": (("minor_absorber_intervals_upper", "pair"), lim_up),
        "minor_scales_with_density_lower": (("minor_absorber_intervals_lower",), swd_lo),
        "minor_scales_with_density_upper": (("minor_absorber_intervals_upper",), swd_up),
        "scale_by_complement_lower": (("minor_absorber_intervals_lower",), sbc_lo),
        "scale_by_complement_upper": (("minor_absorber_intervals_upper",), sbc_up),
        "scaling_gas_lower": (("minor_absorber_intervals_lower", "string_len"), ncio.strings_to_chararray(scl_lo, 32)),
        "scaling_gas_upper": (("minor_absorber_intervals_upper", "string_len"), ncio.strings_to_chararray(scl_up, 32)),
        "kminor_start_lower": (("minor_absorber_intervals_lower",), ks_lo),
        "kminor_start_upper": (("minor_absorber_intervals_upper",), ks_up),
        "vmr_ref": (("temperature", "absorber_ext", "atmos_layer"), vmr_ref),
        "kmajor": (("temperature", "pressure_plus1", "mixing_fraction", "gpt"), kmajor),
    }
    dims["pressure_plus1"] = npres + 1

    if kind == "lw":
        t_planck = np.linspace(TEMP_REF[0], TEMP_REF[-1], nT_planck)
        totplnk = planck_band_radiance(t_planck, band_lims)  # (nT, nband)
        # Planck fraction varying smoothly in (T, p, eta, g) but exactly
        # normalized within each band (so physics tests keep sum = 1 while
        # parity tests can see the 3-D interpolation weights and the
        # level<->layer pfrac pairing)
        if pfrac_uniform:
            pfrac = np.full((ntemp, npres + 1, neta, ngpt), 1.0 / gpts_per_band)
        else:
            it = np.arange(ntemp)[:, None, None, None]
            ip = np.arange(npres + 1)[None, :, None, None]
            ie = np.arange(neta)[None, None, :, None]
            ig = np.arange(ngpt)[None, None, None, :]
            pfrac = 1.0 + 0.5 * np.sin(
                0.7 * ig + 0.31 * it + 0.17 * ip + 0.43 * ie
            )
            pfrac = pfrac.reshape(ntemp, npres + 1, neta, nband, gpts_per_band)
            pfrac = pfrac / pfrac.sum(axis=-1, keepdims=True)
            pfrac = pfrac.reshape(ntemp, npres + 1, neta, ngpt)
        variables["totplnk"] = (("bnd", "temperature_Planck"), totplnk.T)
        variables["plank_fraction"] = (("temperature", "pressure_plus1", "mixing_fraction", "gpt"), pfrac)
        variables["optimal_angle_fit"] = (
            ("bnd", "fit_coeffs"),
            np.tile(np.array([[-0.74, 1.77]]), (nband, 1)),
        )
    else:
        frac = solar_band_fractions(band_lims)
        tsi = 1360.85
        solar = np.zeros(ngpt)
        for ib in range(nband):
            solar[ib * gpts_per_band : (ib + 1) * gpts_per_band] = tsi * frac[ib] / gpts_per_band
        # NRLSSI2 sensitivity spectra scaled so the default indices give a
        # small correction: (mg_default - a)*facular ~ +7e-5*solar,
        # (sb_default - b)*sunspot ~ -9e-4*solar
        # band-dependent facular/sunspot shapes so the NRLSSI2 combination
        # is distinguishable from any quiet-only or band-fraction fallback
        # in end-to-end tests (the real file's terms vary by band too)
        band_ramp = np.repeat(1.0 + 0.5 * np.arange(nband) / nband, gpts_per_band)
        variables["solar_source_quiet"] = (("gpt",), solar)
        variables["solar_source_facular"] = (("gpt",), 0.5 * solar * band_ramp)
        variables["solar_source_sunspot"] = (("gpt",), -1.0e-5 * solar * band_ramp)
        variables["tsi_default"] = ((), np.float64(tsi))
        variables["mg_default"] = ((), np.float64(0.1567652))
        variables["sb_default"] = ((), np.float64(902.7126))
        # rayleigh: physical nu^4-ish magnitude per band
        nu_c = band_lims.mean(axis=1)
        sigma = 4.5e-27 * (nu_c / (1.0 / 0.55e-4)) ** 4
        krayl = np.zeros((ntemp, neta, ngpt))
        for ib in range(nband):
            krayl[..., ib * gpts_per_band : (ib + 1) * gpts_per_band] = sigma[ib]
        variables["rayl_lower"] = (("temperature", "mixing_fraction", "gpt"), krayl)
        variables["rayl_upper"] = (("temperature", "mixing_fraction", "gpt"), krayl * 1.01)

    ncio.write_nc(path, dims, variables)
