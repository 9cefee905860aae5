"""Synthetic inputs for the tests and the chip smoke run (RFMIP-like and
Garand-like atmospheres, cloud-optics coefficient files, seeded MLPs), and
the rule that holds a kernel against its plain twin.

Input synthesis is numpy only, not physics. One seeded dict of arrays can
feed both the JAX package's and this package's ``RFMIPData`` (and the
arrays of a net both packages' models), so the two are compared on
identical inputs.
"""
from __future__ import annotations

import copy

import numpy as np

from .drivers.allsky_io import GARAND_GASES


def synthesize_rfmip(ncol: int, nlay: int, seed: int, top_at_1: bool = True) -> dict:
    """A clear-sky RFMIP-like problem of ``ncol`` columns and ``nlay``
    layers, from ``seed``.

    Returns a dict of float32 numpy arrays: play/tlay (ncol, nlay),
    plev/tlev (ncol, nlay+1), tsfc/sfc_emis/sfc_alb/sza/tsi (ncol,), and
    ``gases``: h2o and o3 2-D; co2 2-D but constant in height; ch4 and n2o
    per-layer 1-D profiles, constant; cfc11 and cfc12 scalars. The other
    gases of the g-128 LW model are absent (they take the missing-gas
    path). sza spans 0-120 deg, so about a quarter of the columns are night.
    ``top_at_1`` selects the vertical orientation (True: index 0 is the top
    of the atmosphere). Also holds ``top_at_1``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    psfc = rng.uniform(95000.0, 103000.0, ncol)
    frac = np.exp(np.linspace(np.log(1.0e-4), 0.0, nlay + 1))  # of psfc, top to surface
    plev = psfc[:, None] * frac[None, :]
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    sigma = play / psfc[:, None]
    # stratosphere ~215 K over a troposphere warming towards the surface
    t_sfc_air = rng.uniform(260.0, 305.0, ncol)
    tlay = np.maximum(215.0, t_sfc_air[:, None] * sigma ** 0.19)
    tlay = tlay + rng.uniform(-2.0, 2.0, (ncol, nlay))
    tlev = np.concatenate(
        [tlay[:, :1] - 1.0, 0.5 * (tlay[:, 1:] + tlay[:, :-1]), t_sfc_air[:, None]], axis=1)
    tsfc = t_sfc_air + rng.uniform(-2.0, 5.0, ncol)

    h2o = (1.0e-2 * rng.uniform(0.2, 1.0, ncol)[:, None] * sigma ** 3.0
           * rng.uniform(0.8, 1.2, (ncol, nlay)) + 2.0e-6)
    o3 = 8.0e-6 * np.exp(-((np.log(sigma) - np.log(0.01)) / 1.5) ** 2) + 2.0e-8
    o3 = o3 * rng.uniform(0.8, 1.2, (ncol, nlay))
    co2 = rng.uniform(2.8e-4, 8.0e-4, ncol)[:, None] * np.ones((1, nlay))
    ch4 = np.full(nlay, rng.uniform(8.0e-7, 2.5e-6))
    n2o = np.full(nlay, rng.uniform(2.7e-7, 3.9e-7))
    gases = {
        "h2o": h2o, "o3": o3, "co2": co2, "ch4": ch4, "n2o": n2o,
        "cfc11": np.asarray(2.3e-10), "cfc12": np.asarray(5.2e-10),
    }

    out = {
        "play": play, "plev": plev, "tlay": tlay, "tlev": tlev, "tsfc": tsfc,
        "sfc_emis": rng.uniform(0.9, 1.0, ncol),
        "sfc_alb": rng.uniform(0.05, 0.3, ncol),
        "sza": rng.uniform(0.0, 120.0, ncol),
        "tsi": rng.uniform(1355.0, 1365.0, ncol),
    }
    if not top_at_1:
        for k in ("play", "plev", "tlay", "tlev"):
            out[k] = out[k][:, ::-1]
        gases = {k: (v[..., ::-1] if np.ndim(v) else v) for k, v in gases.items()}
    out = {k: np.ascontiguousarray(v, dtype=f32) for k, v in out.items()}
    out["gases"] = {k: np.array(v, dtype=f32) for k, v in gases.items()}
    out["top_at_1"] = bool(top_at_1)
    return out


# RFMIP's 18 experiments (0-based), by the (co2, ch4, n2o) they take here:
# "pd" present-day, "pi" pre-industrial, "fut" future (the reference global
# means of gas_concs.get_ref_vmr, scenarios 1, 2, 3), a number a multiple of
# the pre-industrial CO2 with present-day CH4 and N2O, and "lgm" the Last
# Glacial Maximum (180 ppm, 350 ppb, 200 ppb).
RFMIP_EXPERIMENTS = (
    "pd", "pi", 4.0, "fut", 0.5, 2.0, 3.0, 8.0, "pi_co2", "pi_ch4", "pi_n2o",
    "pd", "pd", "pd", "pd", "pi", "fut", "lgm")


def rfmip_experiment_gases(scenario) -> tuple[float, float, float]:
    """(co2, ch4, n2o) VMRs of one RFMIP_EXPERIMENTS entry."""
    from .gas_concs import get_ref_vmr

    ref = lambda i: tuple(get_ref_vmr(i, g) for g in ("co2", "ch4", "n2o"))
    pd, pi = ref(1), ref(2)
    if isinstance(scenario, float):
        return (scenario * pi[0], pd[1], pd[2])
    return {"pd": pd, "pi": pi, "fut": ref(3), "pi_co2": (pi[0], pd[1], pd[2]),
            "pi_ch4": (pd[0], pi[1], pd[2]), "pi_n2o": (pd[0], pd[1], pi[2]),
            "lgm": (180e-6, 350e-9, 200e-9)}[scenario]


def synthesize_rfmip_experiments(nexp: int, nsites: int, nlay: int, seed: int,
                                 top_at_1: bool = True) -> dict:
    """An RFMIP-like problem of ``nexp`` experiments over the same
    ``nsites`` sites: synthesize_rfmip(nsites, nlay, seed), repeated for
    each experiment (columns experiment-major, as RFMIPData has them), with
    CO2, CH4 and N2O set per experiment by RFMIP_EXPERIMENTS (2-D, constant
    in height and over the sites). So the forcing pairs of the eval metrics
    (parallel/shard_ops RF_PAIRS_*) measure real forcings on the same
    atmospheres, each the scenario training/eval_loop.METRIC_NAMES names:
    experiment 0 present-day, 1 pre-industrial, 3 future, 9 present-day
    with pre-industrial CH4, 10 with pre-industrial N2O. Returns the
    synthesize_rfmip dict (ncol = nexp * nsites) with ``nexp``."""
    if not 1 <= nexp <= len(RFMIP_EXPERIMENTS):
        raise ValueError(f"nexp {nexp}: 1 to {len(RFMIP_EXPERIMENTS)} experiments")
    site = synthesize_rfmip(nsites, nlay, seed, top_at_1=top_at_1)
    out = {k: np.ascontiguousarray(np.concatenate([v] * nexp, axis=0))
           for k, v in site.items() if isinstance(v, np.ndarray)}
    gases = {k: (np.concatenate([v] * nexp, axis=0) if v.ndim == 2 else v)
             for k, v in site["gases"].items()}
    for name, k in (("co2", 0), ("ch4", 1), ("n2o", 2)):
        vmr = np.repeat([rfmip_experiment_gases(s)[k] for s in RFMIP_EXPERIMENTS[:nexp]], nsites)
        gases[name] = np.ascontiguousarray(
            np.broadcast_to(vmr[:, None], (nexp * nsites, nlay)), dtype=np.float32)
    out.update(gases=gases, top_at_1=site["top_at_1"], nexp=nexp)
    return out


# The RFMIP file's per-experiment global means that synthesize_rfmip does not
# make, by file variable, with their units attribute: (value in those units,
# units). cfc12eq and hfc134aeq differ from cfc12 and hfc134a, so a reader that
# takes one for the other shows it (ROADMAP Queue 3 F12).
RFMIP_FILE_GM_EXTRA = {
    "no2_GM": (5.0e-2, "1.e-9"),
    "oxygen_GM": (0.209, "1"),
    "nitrogen_GM": (0.781, "1"),
    "cfc12eq_GM": (1100.0, "1.e-12"),
    "hfc134a_GM": (80.0, "1.e-12"),
    "hfc134aeq_GM": (950.0, "1.e-12"),
}


def write_rfmip_file(path: str, nexp: int, nsites: int, nlay: int, seed: int) -> None:
    """Write synthesize_rfmip_experiments(nexp, nsites, nlay, seed) in the
    RFMIP input file's layout (netCDF-3, scipy's writer, which both
    packages' ncio read): dimensions expt, site, layer, level; pressures
    and the surface's emissivity, albedo, solar zenith angle and TSI per
    site; temperatures per experiment and site; water_vapor and ozone per
    experiment, site and layer; CO2, CH4, N2O, CFC-11 and CFC-12 and the
    gases of RFMIP_FILE_GM_EXTRA as ``<name>_GM`` per experiment, each
    with a ``units`` scale factor."""
    from scipy.io import netcdf_file

    a = synthesize_rfmip_experiments(nexp, nsites, nlay, seed)
    by_exp = lambda v: np.asarray(v).reshape(nexp, nsites, *np.shape(v)[1:])
    per_exp = lambda v: by_exp(v)[:, 0, 0]  # constant over the sites and layers
    g = a["gases"]
    gm = {
        "carbon_dioxide_GM": (per_exp(g["co2"]) / 1e-6, "1.e-6"),
        "methane_GM": (per_exp(g["ch4"]) / 1e-9, "1.e-9"),
        "nitrous_oxide_GM": (per_exp(g["n2o"]) / 1e-9, "1.e-9"),
        "cfc11_GM": (np.full(nexp, float(g["cfc11"]) / 1e-12), "1.e-12"),
        "cfc12_GM": (np.full(nexp, float(g["cfc12"]) / 1e-12), "1.e-12"),
        **{k: (np.full(nexp, v), u) for k, (v, u) in RFMIP_FILE_GM_EXTRA.items()},
    }
    with netcdf_file(path, "w") as f:
        for name, size in (("expt", nexp), ("site", nsites), ("layer", nlay),
                           ("level", nlay + 1)):
            f.createDimension(name, size)

        def var(name, dims, data, units=None):
            v = f.createVariable(name, "f4", dims)
            v[...] = np.asarray(data, np.float32)
            if units is not None:
                v.units = units

        var("pres_layer", ("site", "layer"), by_exp(a["play"])[0])
        var("pres_level", ("site", "level"), by_exp(a["plev"])[0])
        var("temp_layer", ("expt", "site", "layer"), by_exp(a["tlay"]))
        var("temp_level", ("expt", "site", "level"), by_exp(a["tlev"]))
        var("surface_temperature", ("expt", "site"), by_exp(a["tsfc"]))
        for name, key in (("surface_emissivity", "sfc_emis"), ("surface_albedo", "sfc_alb"),
                          ("solar_zenith_angle", "sza"), ("total_solar_irradiance", "tsi")):
            var(name, ("site",), by_exp(a[key])[0])
        var("water_vapor", ("expt", "site", "layer"), by_exp(g["h2o"]), units="1")
        var("ozone", ("expt", "site", "layer"), by_exp(g["o3"]), units="1")
        for name, (v, units) in gm.items():
            var(name, ("expt",), v, units=units)


def synthesize_garand(nlay: int, seed: int, top_at_1: bool = True) -> dict:
    """Two atmospheric profiles in the layout of the all-sky example's
    Garand file, from ``seed``: float64 numpy arrays ``p_lay``/``t_lay``
    (nlay, 2), ``p_lev``/``t_lev`` (nlay+1, 2) and ``vmr_<gas>`` (nlay, 2)
    for the GARAND_GASES, ready for ``write_nc`` with the dimensions
    (lay, lev, col).

    Pressure runs from 10 Pa to about 1000 hPa, quadratically spaced, so
    several layers lie between 100 and 900 hPa; a cool and a warm profile
    cross 263 K and 273 K inside that range at different heights, so with
    the all-sky driver's cloud placement liquid-only, ice-only, mixed and
    clear layers all occur (nlay >= 8). ``top_at_1`` False stores the
    surface first."""
    rng = np.random.default_rng(seed)
    psfc = np.array([100500.0, 101300.0]) + rng.uniform(-300.0, 300.0, 2)
    frac = 1.0e-4 + (1.0 - 1.0e-4) * np.linspace(0.0, 1.0, nlay + 1) ** 2
    plev = frac[:, None] * psfc[None, :]                   # (nlay+1, 2), top first
    play = 0.5 * (plev[1:] + plev[:-1])
    sigma = play / psfc[None, :]
    t0 = np.array([288.0, 305.0])
    tlay = np.maximum(215.0, t0[None, :] * sigma ** 0.19) + rng.uniform(-0.2, 0.2, (nlay, 2))
    tlev = np.concatenate([tlay[:1] - 1.0, 0.5 * (tlay[1:] + tlay[:-1]), t0[None, :]], axis=0)
    ones = np.ones((nlay, 2))
    gases = {
        "h2o": 1.2e-2 * sigma ** 3.0 * rng.uniform(0.8, 1.2, (nlay, 2)) + 3.0e-6,
        "co2": 4.1e-4 * ones,
        "o3": (8.0e-6 * np.exp(-((np.log(sigma) - np.log(0.01)) / 1.5) ** 2) + 2.0e-8)
              * rng.uniform(0.9, 1.1, (nlay, 2)),
        "n2o": 3.3e-7 * ones, "co": 1.2e-7 * ones, "ch4": 1.8e-6 * ones,
        "o2": 0.209 * ones, "n2": 0.781 * ones,
    }
    out = {"p_lay": play, "p_lev": plev, "t_lay": tlay, "t_lev": tlev}
    out.update({f"vmr_{g}": gases[g] for g in GARAND_GASES})
    if not top_at_1:
        out = {k: v[::-1] for k, v in out.items()}
    return {k: np.ascontiguousarray(v, dtype=np.float64) for k, v in out.items()}


def garand_nc_variables(arrays: dict) -> tuple[dict, dict]:
    """(dims, variables) of ``write_nc`` for a synthesize_garand dict."""
    nlay = arrays["p_lay"].shape[0]
    dims = {"lay": nlay, "lev": nlay + 1, "col": arrays["p_lay"].shape[1]}
    variables = {k: (("lev" if v.shape[0] == nlay + 1 else "lay", "col"), v)
                 for k, v in arrays.items()}
    return dims, variables


def synthesize_cloud_optics(spectral, seed: int, flavour: str = "lut") -> dict:
    """Cloud-optics coefficients on ``spectral``'s bands, from ``seed``, as
    float64 numpy arrays under the coefficient file's variable names.

    ``flavour`` "lut": ``lut_{ext,ssa,asy}liq`` (nband, 20) and
    ``lut_{ext,ssa,asy}ice`` (3 roughness classes, nband, 18), smooth in
    radius. "pade": ``pade_{ext,ssa,asy}{liq,ice}`` with (ncoeff, 3 size
    regimes, nband) for liquid, a leading roughness axis for ice, 6
    coefficients for extinction ([2/3]) and 5 for ssa and asymmetry ([2/2]),
    and the six ``pade_sizreg_*`` bounds; every coefficient is positive, so
    no denominator has a pole at a positive radius. Both give ext > 0, 0 <
    ssa < 1 and 0 < g < 1 over the radius ranges 2.5-21.5 (liquid) and
    10-180 microns (ice), which ``radliq_*``/``radice_*`` hold, with
    ``bnd_limits_wavenumber`` (nband, 2)."""
    rng = np.random.default_rng(seed)
    nband = spectral.nband
    out = {"bnd_limits_wavenumber": spectral.band_lims_wvn_array,
           "radliq_lwr": np.float64(2.5), "radliq_upr": np.float64(21.5),
           "radice_lwr": np.float64(10.0), "radice_upr": np.float64(180.0)}
    if flavour == "lut":
        def tables(lo, hi, nsize, scale):
            re = np.linspace(lo, hi, nsize)[None, :]
            a = rng.uniform(0.8, 1.2, (nband, 1))
            ext = scale * a / re * (1.0 + 0.1 * np.sin(re / hi * 3.0))
            s0 = rng.uniform(0.4, 0.97, (nband, 1))
            ssa = s0 - 0.25 * s0 * (re - lo) / (hi - lo)
            g0 = rng.uniform(0.70, 0.80, (nband, 1))
            asy = g0 + 0.15 * (re - lo) / (hi - lo)
            return ext, ssa, asy

        for n, t in zip(("ext", "ssa", "asy"), tables(2.5, 21.5, 20, 1.6)):
            out[f"lut_{n}liq"] = t
        ice = [tables(10.0, 180.0, 18, 3.0) for _ in range(3)]
        for k, n in enumerate(("ext", "ssa", "asy")):
            out[f"lut_{n}ice"] = np.stack([r[k] for r in ice])
        return out
    if flavour != "pade":
        raise ValueError(f"flavour {flavour!r}: 'lut' or 'pade'")

    def pade(hi, scale):
        # [2/3] extinction, about scale / re; [2/2] co-albedo and asymmetry
        # between their value at re = 0 and the ratio of the leading terms
        shape = (3, nband)
        ext = np.stack([scale * rng.uniform(0.4, 0.6, shape),
                        scale * rng.uniform(0.01, 0.03, shape),
                        scale * rng.uniform(0.5e-5, 1.5e-5, shape),
                        rng.uniform(0.25, 0.35, shape),
                        rng.uniform(1.0e-3, 3.0e-3, shape),
                        rng.uniform(0.5e-6, 1.5e-6, shape)])

        def ratio(c0_lo, c0_hi, f_lo, f_hi):
            c3, c4 = rng.uniform(0.05, 0.2, shape), rng.uniform(1.0e-3, 4.0e-3, shape) * 20.0 / hi
            f = rng.uniform(f_lo, f_hi, shape)
            return np.stack([rng.uniform(c0_lo, c0_hi, shape), f * c3, f * c4, c3, c4])

        return ext, ratio(0.02, 0.2, 0.1, 0.6), ratio(0.70, 0.78, 0.80, 0.92)

    for n, t in zip(("ext", "ssa", "asy"), pade(21.5, 1.0)):
        out[f"pade_{n}liq"] = t
        out[f"pade_sizreg_{n}liq"] = np.array([2.5, 8.0, 6.0, 21.5])
    ice = [pade(180.0, 3.0) for _ in range(3)]
    for k, n in enumerate(("ext", "ssa", "asy")):
        out[f"pade_{n}ice"] = np.stack([r[k] for r in ice])
        out[f"pade_sizreg_{n}ice"] = np.array([10.0, 50.0, 60.0, 180.0])
    return out


def cloud_optics_nc_variables(arrays: dict) -> tuple[dict, dict]:
    """(dims, variables) of ``write_nc`` for synthesize_cloud_optics dicts
    (one flavour, or both merged into one dict)."""
    dims = {"nband": arrays["bnd_limits_wavenumber"].shape[0], "pair": 2, "nbound": 4}
    names = {1: ("nband",), 2: ("nband", "nsize"), 3: ("nrghice", "nband", "nsize")}
    variables = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if k == "bnd_limits_wavenumber":
            vd = ("nband", "pair")
        elif v.ndim == 0:
            vd = ()
        elif k.startswith("pade_sizreg"):
            vd = ("nbound",)
        elif k.startswith("lut_"):
            phase = k[-3:]
            dims[f"nsize_{phase}"] = v.shape[-1]
            vd = tuple(f"nsize_{phase}" if d == "nsize" else d for d in names[v.ndim])
        else:  # pade_*: ([nrghice,] ncoeff, nsizereg, nband)
            nco = f"ncoeff_{v.shape[-3]}"
            dims[nco] = v.shape[-3]
            vd = (nco, "nsizereg", "nband")
            if v.ndim == 4:
                vd = ("nrghice",) + vd
        if "nrghice" in vd:
            dims["nrghice"] = v.shape[0]
        if "nsizereg" in vd:
            dims["nsizereg"] = v.shape[-2]
        variables[k] = (vd, v)
    return dims, variables


# every activation of models/network.py, once each, for a generic-depth net
ALL_ACTIVATIONS = ("linear", "relu", "sigmoid", "hard_sigmoid", "softsign", "tanh", "gaussian")


def random_mlp_arrays(dims, activations, seed: int, names=None):
    """The arrays of a random MLP with layer widths ``dims``: (weights
    (n_in, n_out) each, biases, activations, input names, input min, input
    max, output mean, output std), float32, from ``seed``."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(0, 0.1, b).astype(np.float32) for b in dims[1:]]
    names = names or tuple(f"x{i}" for i in range(dims[0]))
    mn = rng.uniform(-1, 0, dims[0]).astype(np.float32)
    mx = (mn + rng.uniform(1, 2, dims[0])).astype(np.float32)
    om = rng.normal(0, 0.1, dims[-1]).astype(np.float32)
    os_ = rng.uniform(0.5, 1.5, dims[-1]).astype(np.float32)
    return ws, bs, tuple(activations), tuple(names), mn, mx, om, os_


def random_gas_optics_net_arrays(dims, activations, seed: int, names=None):
    """random_mlp_arrays with the output standardization of an NN
    gas-optics net: mean 1 and std 0.1, so that ystd*y + ymean (the 8th
    root of tau / col_dry) stays near 1 as in the shipped nets. With a mean
    near 0 it crosses zero, where the (...)**8 postprocessing turns any
    rounding difference into an unbounded relative one."""
    ws, bs, acts, names, mn, mx, om, os_ = random_mlp_arrays(dims, activations, seed, names)
    return (ws, bs, acts, names, mn, mx, np.ones_like(om), np.full_like(os_, 0.1))


def sw_g224_net_arrays(sw112, seed: int):
    """A 224-output SW absorption net standing in for the reference's g-224
    net (16 g-points a band): random_gas_optics_net_arrays from ``seed`` at
    the widths of the g-112 net ``sw112`` but for its 224 outputs, with
    ``sw112``'s activations, input names and input scalings; each band's 16
    outputs take the output mean and std of that band's g-112 outputs,
    spread over them in order, so that the two nets' optical depths are of
    one size band by band."""
    from .gasoptics.planck import SW_G112_GPT_PER_BAND

    counts = np.asarray(SW_G112_GPT_PER_BAND)
    starts = np.cumsum(counts) - counts
    src = [s + (j * n) // 16 for s, n in zip(starts, counts) for j in range(16)]
    ws, bs, acts, _, _, _, _, _ = random_gas_optics_net_arrays(
        sw112.dims[:-1] + [16 * len(counts)], sw112.activations, seed)
    a = lambda t: t.detach().cpu().numpy()
    return (ws, bs, acts, sw112.input_names, a(sw112.input_min), a(sw112.input_max),
            a(sw112.output_mean)[src], a(sw112.output_std)[src])


def model_arrays(model):
    """The arrays of an NNModel of this package (any device), in the
    random_mlp_arrays layout."""
    a = lambda t: t.detach().cpu().numpy()
    return ([a(w) for w in model.weights], [a(b) for b in model.biases], model.activations,
            model.input_names, a(model.input_min), a(model.input_max),
            a(model.output_mean), a(model.output_std))


def split_lw_both_arrays(weights, biases, activations, input_names, input_min, input_max,
                         output_mean, output_std):
    """The arrays of a "lw_both" net (2*ngpt outputs: tau || pfrac) split
    into an absorption net (the first ngpt outputs) and a Planck-fraction
    net (the rest, linear output): two-model LW that computes exactly the
    one-model fluxes. Takes and returns the random_mlp_arrays layout."""
    ngpt = np.shape(weights[-1])[1] // 2
    halves = []
    for sl in (slice(0, ngpt), slice(ngpt, 2 * ngpt)):
        ws = [np.asarray(w) for w in weights[:-1]] + [np.asarray(weights[-1])[:, sl]]
        bs = [np.asarray(b) for b in biases[:-1]] + [np.asarray(biases[-1])[sl]]
        halves.append((ws, bs, tuple(activations), tuple(input_names), np.asarray(input_min),
                       np.asarray(input_max), np.asarray(output_mean)[sl],
                       np.asarray(output_std)[sl]))
    return halves


def float64_copy(model):
    """A float64 copy of an NNModel of this package (the arbiter's net)."""
    return copy.deepcopy(model).double()


def bound_excess(a, ref, rtol: float, atol: float) -> float:
    """max |a - ref| / (atol + rtol |ref|) over tensors a and ref: at most 1
    when a is within the bound of ref. Taken on a's device (ref is brought
    there), so that outputs at GCM block size stay on the card."""
    a = a.double()
    ref = ref.double().to(a.device)
    if a.numel() == 0:
        return 0.0
    return float(((a - ref).abs() / (atol + rtol * ref.abs())).max())


# How much further than the float32 twin a kernel output may land from
# float64 at its worst element: two float32 evaluations of one net that sum
# in different orders fall on different sides of the float64 value, and
# which one is further at the single worst of 10^4-10^7 outputs is chance.
FLOAT32_SPREAD = 2.0


def hold_kernel(kernel, twin, twin64, rtol: float, atol: float) -> dict:
    """The rule for an elementwise kernel output against its plain twin:
    within the bound (rtol, atol) of the float32 twin; beyond it float64
    decides, and the kernel passes if it is within the bound of the float64
    twin, or within FLOAT32_SPREAD times the float32 twin's own distance
    from it, in the bound's measure. Returns the three excesses (kernel vs
    twin, kernel vs float64, twin vs float64; each at most 1 within the
    bound) and ``ok``."""
    e = {"kernel_twin": bound_excess(kernel, twin, rtol, atol)}
    if e["kernel_twin"] > 1.0:
        e["kernel_f64"] = bound_excess(kernel, twin64, rtol, atol)
        e["twin_f64"] = bound_excess(twin, twin64, rtol, atol)
        e["ok"] = e["kernel_f64"] <= max(1.0, FLOAT32_SPREAD * e["twin_f64"])
    else:
        e["ok"] = True
    return e


LUT_GASES = ("h2o", "co2", "o3", "n2o", "ch4")  # the synthetic k-distributions' gases
LUT_CLOUD_LAYERS = (0.55, 0.7)  # a cloud between these fractions of the layer axis, top-at-0

# The clear-sky regression's gases: the synthetic k-distributions' own (the
# JAX suite's tests/test_lut_gas_optics.py GASES).
REGRESSION_GASES = LUT_GASES


def make_atmosphere(ncol: int = 4, nlay: int = 20, t_iso=None, rng=None) -> tuple:
    """The clear-sky regression's atmosphere (the JAX suite's
    tests/test_lut_gas_optics.py make_atmosphere, the same profile and
    default generator ``np.random.default_rng(1)``): pressure levels from 40
    Pa to 101325 Pa, log-spaced; temperatures 220 + 70 (p/pmax)^0.3 K with
    +-5 K of noise (isothermal at ``t_iso`` when given); h2o decreasing
    upwards, the other REGRESSION_GASES constant. Returns float64 numpy
    (play, plev, tlay, tlev, tsfc, gases): the caller picks the dtype;
    ``gases`` maps a name to an (ncol, nlay) array or a scalar VMR."""
    rng = rng or np.random.default_rng(1)
    plev = np.exp(np.linspace(np.log(40.0), np.log(101325.0), nlay + 1))
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).copy()
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    if t_iso is not None:
        tlay = np.full((ncol, nlay), t_iso)
        tlev = np.full((ncol, nlay + 1), t_iso)
        tsfc = np.full((ncol,), t_iso)
    else:
        prof = 220 + 70 * (play / play.max()) ** 0.3
        tlay = prof + rng.uniform(-5, 5, (ncol, nlay))
        tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]), tlay[:, -1:]], 1)
        tsfc = tlev[:, -1] + rng.uniform(0, 5, ncol)
    gases = {"h2o": 3e-3 * (play / play.max()) ** 1.5 + 1e-6, "co2": 4e-4, "o3": 5e-7,
             "n2o": 3.2e-7, "ch4": 1.8e-6}
    return play, plev, tlay, tlev, tsfc, gases


def write_lut_files(directory: str, gpts_per_band: int, seed: int = 0) -> dict:
    """Write a synthetic LW (16 bands) and SW (14 bands) k-distribution
    file into ``directory``; returns their paths by "lw" and "sw"."""
    import os

    from .gasoptics.synthetic import generate_kdist_nc

    paths = {}
    for kind in ("lw", "sw"):
        paths[kind] = os.path.join(directory, f"kdist-synthetic-{kind}-g{gpts_per_band}.nc")
        generate_kdist_nc(paths[kind], kind=kind, gases=LUT_GASES, gpts_per_band=gpts_per_band,
                          seed=seed)
    return paths


def lut_inputs(data: dict, device, dtype):
    """The tensors the lookup-table path takes, from a synthesize_rfmip
    dict: (play, plev, tlay, tlev, tsfc, mu0, GasConcs of LUT_GASES). mu0 is
    the cosine of sza held to [0.2, 1] (every column lit)."""
    import torch

    from .gas_concs import GasConcs

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    mu0 = np.clip(np.cos(np.deg2rad(data["sza"].astype(np.float64))), 0.2, 1.0)
    gases = GasConcs({g: t(data["gases"][g]) for g in LUT_GASES})
    return (*(t(data[k]) for k in ("play", "plev", "tlay", "tlev", "tsfc")), t(mu0), gases)


def lut_fluxes(kd_lw, kd_sw, data: dict, device, dtype) -> dict:
    """The lookup-table gas optics with every LW solver and the SW solver
    behind it, on a synthesize_rfmip dict: broadband fluxes by name --
    ``lw1_*`` one angle, ``lw3_*`` three Gauss angles, ``lwopt_*`` the
    optimal-angle secants, ``lw2s_*`` the two-stream solver and ``lwtang_*``
    the rescaled solve on the gas optics incremented by a scattering cloud
    (LUT_CLOUD_LAYERS), ``sw_*`` two-stream SW, ``hr_lw`` the one-angle
    heating rate [K/day]."""
    import torch

    from .extensions.heating_rates import compute_heating_rate_kday
    from .gasoptics.lut_gas_optics import (
        compute_optimal_angles, gas_optics_lw_lut, gas_optics_sw_lut)
    from .optical_props import OpticalProps2str, increment
    from .rte import rte_lw, rte_sw
    from .spectral import SpectralMapping

    top_at_1 = data["top_at_1"]
    play, plev, tlay, tlev, tsfc, mu0, gases = lut_inputs(data, device, dtype)
    ncol, nlay = play.shape
    props, src = gas_optics_lw_lut(kd_lw, play, plev, tlay, tsfc, gases, tlev=tlev,
                                   top_at_1=top_at_1)
    emis = torch.full((ncol, kd_lw.nband), 0.97, dtype=dtype, device=device)
    out = {}
    for tag, kw in (("lw1", {}), ("lw3", dict(n_gauss_angles=3)),
                    ("lwopt", dict(lw_ds=compute_optimal_angles(kd_lw, props.tau)))):
        sol = rte_lw(props, top_at_1, src, emis, broadband=True, **kw)
        out[f"{tag}_up"], out[f"{tag}_dn"] = sol.flux_up, sol.flux_dn
    out["hr_lw"] = compute_heating_rate_kday(out["lw1_up"], out["lw1_dn"], plev)
    # a scattering cloud on the band grid, in the same layers either way up
    lo, hi = (int(f * nlay) for f in LUT_CLOUD_LAYERS)
    rows = slice(lo, hi) if top_at_1 else slice(nlay - hi, nlay - lo)
    tau_c = torch.zeros((ncol, nlay, kd_lw.nband), dtype=dtype, device=device)
    tau_c[:, rows] = 3.0
    bands = SpectralMapping.bands_only(kd_lw.spectral.band_lims_wvn_array)
    cloudy = increment(
        OpticalProps2str(props.tau, torch.zeros_like(props.tau), torch.zeros_like(props.tau),
                         kd_lw.spectral),
        OpticalProps2str(tau_c, torch.full_like(tau_c, 0.6), torch.full_like(tau_c, 0.8), bands))
    for tag, kw in (("lw2s", dict(use_2stream=True)), ("lwtang", {})):
        sol = rte_lw(cloudy, top_at_1, src, emis, **kw)
        out[f"{tag}_up"], out[f"{tag}_dn"] = sol.flux_up.sum(-1), sol.flux_dn.sum(-1)

    sw_props, sw_src = gas_optics_sw_lut(kd_sw, play, plev, tlay, gases)
    alb = torch.full((ncol, kd_sw.ngpt), 0.1, dtype=dtype, device=device)
    sol = rte_sw(sw_props, top_at_1, mu0, sw_src.toa_source, alb, alb, broadband=True)
    out.update(sw_up=sol.flux_up, sw_dn=sol.flux_dn, sw_dir=sol.flux_dn_dir)
    return out


def lut_reference_fluxes(directory: str, ncol: int, nlay: int, seed: int, top_at_1: bool,
                         device, dtype, gpts_per_band: int = 4) -> dict:
    """lut_fluxes on k-distribution files written into ``directory`` and a
    synthesize_rfmip atmosphere, all from ``seed``, on ``device``."""
    from .gasoptics.kdist import load_kdist

    paths = write_lut_files(directory, gpts_per_band, seed)
    kd = {k: load_kdist(p, LUT_GASES, dtype=dtype, device=device) for k, p in paths.items()}
    data = synthesize_rfmip(ncol, nlay, seed, top_at_1=top_at_1)
    return lut_fluxes(kd["lw"], kd["sw"], data, device, dtype)


# W/m2: a column's error times its distance |k*mu0 - 1| from the two-stream
# resonance stays below this where the two-stream coefficients are float32:
# the JAX package's staged SW routes (ROADMAP Queue 3 F1: float32
# coefficients lose accuracy as 1/|k*mu0 - 1|; about twice the largest
# product measured on an H100). The port's SW routes take float64
# coefficients (ops/sw_solver.pifm_coefficients) and need no such law.
SW_F1_LAW = 4e-3

# the matched absorption / Rayleigh pairs in artifacts/, by hidden widths:
# trained on the synthetic 56-g-point SW k-distribution of sw_pair_setup
SW_PAIR_TAGS = {"48_48": "HR_3.61e-01_FRC_2.75e+00", "128_128": "HR_4.22e-02_FRC_1.44e-01"}


def artifact_path(name: str) -> str:
    """The path of ``name`` in the repository's artifacts/ directory."""
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", name)


def sw_pair_paths(width: str) -> list:
    """The files of the in-repo sw-synth56-lut absorption and Rayleigh nets
    of hidden widths ``width`` ("48_48" or "128_128"), in that order."""
    return [artifact_path(f"sw-synth56-lut_{k}_{width}_{SW_PAIR_TAGS[width]}.nc")
            for k in ("absorption", "rayleigh")]


def sw_pair_setup(directory: str, width: str = "48_48", device="cpu", dtype=None) -> dict:
    """The SW real-pair problem: the matched sw-synth56-lut absorption and
    Rayleigh nets of hidden widths ``width`` (sw_pair_paths), and the
    synthetic SW k-distribution they were trained on (generate_kdist_nc
    with kind="sw", gpts_per_band=4, nband=14, seed 0: 56 g-points),
    written into ``directory``. Returns a dict: "models" [absorption,
    Rayleigh] and "kdist" (its LUT_GASES) on ``device`` in ``dtype``
    (default float32), "spectral" the k-distribution's spectral mapping,
    "solar" its solar source per g-point (numpy, float64), "paths" the
    nets' files and "kdist_path"."""
    import os

    import torch

    from .drivers.rfmip import resolve_solar_source
    from .gasoptics.kdist import load_kdist
    from .gasoptics.synthetic import generate_kdist_nc
    from .models.network import load_model_netcdf

    dtype = dtype or torch.float32
    kdist_path = os.path.join(directory, "kdist-synthetic-sw-g4-nband14.nc")
    if not os.path.exists(kdist_path):
        generate_kdist_nc(kdist_path, kind="sw", gases=LUT_GASES, gpts_per_band=4, nband=14)
    kd = load_kdist(kdist_path, LUT_GASES, dtype=dtype, device=device)
    paths = sw_pair_paths(width)
    return {"models": [load_model_netcdf(p, device=device, dtype=dtype) for p in paths],
            "kdist": kd, "spectral": kd.spectral,
            "solar": np.asarray(resolve_solar_source(kd.spectral, kd), np.float64),
            "paths": paths, "kdist_path": kdist_path}


def _resonance(op, mu0):
    """Per column the smallest |k*mu0 - 1| over layers and g-points, k the
    two-stream eigenvalue of the optical properties ``op`` (tau, ssa, g;
    column-major) and ``mu0`` a scalar or per column."""
    import torch

    from .ops.sw_solver import pifm_eigenvalue

    k = pifm_eigenvalue(op.ssa, op.g)[2]
    mu0 = torch.as_tensor(mu0, dtype=k.dtype)
    if mu0.ndim:
        mu0 = mu0[:, None, None]
    return (k * mu0 - 1.0).abs().amin((1, 2)).numpy()


def rfmip_sw_optics64(data, sw64, spectral=None):
    """(tau, ssa, mu0) of the clear-sky SW problem ``data`` (an RFMIPData):
    the float64 gas optics of the nets ``sw64`` on the CPU, column-major
    (ncol, nlay, ngpt), on ``spectral`` (default the g-112 mapping), and mu0
    per column as the drivers take it."""
    import torch

    from .drivers import rfmip
    from .gas_concs import GasConcs
    from .gasoptics import nn_gas_optics as go
    from .gasoptics.planck import sw_spectral_g112

    f64 = torch.float64
    play, plev, tlay, _, mu0, _, _, concs = rfmip.sw_staged_inputs(data, "cpu", f64)
    spec = spectral or sw_spectral_g112()
    tau, ssa, _ = go.gas_optics_sw_nn(sw64, play, plev, tlay, GasConcs(concs), spec,
                                      torch.zeros(spec.ngpt, dtype=f64))
    return tau, ssa, mu0


def rfmip_sw_resonance_distance(data, sw64, spectral=None):
    """(per column the smallest |k*mu0 - 1| over layers and g-points of the
    clear-sky SW problem, mu0), k the two-stream eigenvalue from the float64
    gas optics of the nets ``sw64`` on the CPU (rfmip_sw_optics64, on
    ``spectral``, default the g-112 mapping)."""
    import torch

    from .gasoptics.planck import sw_spectral_g112
    from .optical_props import OpticalProps2str

    tau, ssa, mu0 = rfmip_sw_optics64(data, sw64, spectral)
    op = OpticalProps2str(tau, ssa, torch.zeros_like(tau), spectral or sw_spectral_g112())
    return _resonance(op, mu0), mu0.numpy()


def allsky_sw_optics64(play, plev, tlay, concs, cloud_col, sw_models, cloud_lw, cloud_sw,
                       spectral=None):
    """The optical properties of an all-sky SW problem, in float64 on the
    CPU, column-major: the gas optics of ``sw_models`` on ``spectral``
    (default the g-112 or g-224 mapping by the nets' outputs, others
    refused: gasoptics.planck.spectral_for), and
    the clouds of the all-sky placement (make_clouds with ``cloud_col``,
    radii from ``cloud_lw``) with ``cloud_sw``'s optics, delta-scaled and
    incremented. ``play``, ``plev``, ``tlay``, ``concs`` (each gas (ncol,
    nlay)) and ``cloud_col`` (per column): numpy arrays or tensors."""
    import torch

    from .drivers.allsky import make_clouds
    from .extensions.cloud_optics import cloud_optics
    from .gas_concs import GasConcs
    from .gasoptics.nn_gas_optics import gas_optics_sw_nn
    from .gasoptics.planck import spectral_for, sw_spectral_g112, sw_spectral_g224
    from .optical_props import OpticalProps2str, delta_scale, increment

    spectral = spectral_for("sw", sw_models, entry="allsky_sw_optics64",
                            accepts=(sw_spectral_g112, sw_spectral_g224), spectral=spectral)
    f64 = torch.float64
    play, plev, tlay = _cpu64(play), _cpu64(plev), _cpu64(tlay)
    clouds = make_clouds(play, tlay, cloud_lw.to("cpu", f64), cloud_col=_cpu64(cloud_col))
    models = [float64_copy(m).to("cpu") for m in sw_models]
    tau, ssa, _ = gas_optics_sw_nn(models, play, plev, tlay,
                                   GasConcs({k: _cpu64(v) for k, v in concs.items()}), spectral,
                                   torch.zeros(spectral.ngpt, dtype=f64))
    return increment(OpticalProps2str(tau, ssa, torch.zeros_like(tau), spectral),
                     delta_scale(cloud_optics(cloud_sw.to("cpu", f64), *clouds, as_2str=True)))


def _cpu64(a):
    import torch

    return torch.as_tensor(np.array(a.cpu() if torch.is_tensor(a) else a), dtype=torch.float64)


def gcm_sw_resonance_distance(host: dict, idx, sw_models, cloud_lw, cloud_sw,
                              spectral=None) -> np.ndarray:
    """Per column ``idx`` of a GCM host dict (drivers.gcm.synthesize_gcm_columns),
    the smallest |k*mu0 - 1| over layers and g-points of the all-sky SW
    problem that gcm_sweep_allsky solves there (allsky_sw_optics64 with the
    sweep's cloud columns, on ``spectral``, default by the nets' outputs as
    the sweep takes it), k the two-stream eigenvalue, mu0 clipped as the
    sweep clips it."""
    play = np.asarray(host["play"][idx])
    ncol, nlay = play.shape
    concs = {}
    for k in host:
        if k.startswith("gas:"):
            v = np.asarray(host[k][idx], np.float64)
            concs[k[4:]] = v if v.ndim == 2 else np.broadcast_to(v[:, None], (ncol, nlay))
    cloud_col = (((np.arange(host["play"].shape[0]) + 1) % 3) != 0)[idx]
    mu0 = np.clip(np.cos(np.deg2rad(host["sza"][idx])).astype(np.float32), 0.05, 1.0)
    op = allsky_sw_optics64(play, host["plev"][idx], host["tlay"][idx], concs, cloud_col,
                            sw_models, cloud_lw, cloud_sw, spectral)
    return _resonance(op, _cpu64(mu0))


# the in-repo LW net of the reference's shipped LW shape, 18 -> 64 -> 64 ->
# 256 softsign (the 128-wide demo net does about 2.4 times its MLP work)
LW_NET_64 = "lw-g128-demo_both_64_64_HR_2.62e-01_FRC_2.07e+01.nc"
ALLSKY_PAIR_FLAVOURS = ("lut", "pade")  # the cloud-optics files of each band


def allsky_pair_setup(directory: str, width: str = "128_128", ncol: int = 1800, nlay: int = 60,
                      seed: int = 0, device="cpu", dtype=None) -> dict:
    """The all-sky problem on the real nets, as a GCM step poses it
    (drivers/gcm.py ``_allsky_body`` without the packing): ``ncol`` x
    ``nlay`` columns of synthesize_rfmip(ncol, nlay, seed), whose columns
    all differ; clouds by make_clouds with every third column clear
    (``cloud_col``, as the GCM places them); mu0 = cos(sza) clipped to
    [0.05, 1], ``day`` the columns whose SW flux the GCM keeps; SW on the
    sw-synth56-lut pair of hidden widths ``width`` and its 56-g-point
    mapping and solar source (sw_pair_setup); LW on the LW_NET_64 net and
    the g-128 mapping; cloud coefficients of synthesize_cloud_optics(seed)
    on each mapping's bands in both flavours, written into ``directory``.

    Returns a dict on ``device`` in ``dtype`` (default float32): "sw" (the
    sw_pair_setup dict), "solar" (its source as a tensor), "lw_models",
    "lw_spectral", "table", "cloud" and "cloud_paths" by "<lw|sw>_<lut|pade>",
    "data" (the numpy problem), "cloud_col", "mu0", "day", "clouds" (lwp,
    iwp, rel, rei, column-major), and the all-sky cores' inputs after their
    nets, table or source, spectral mapping and cloud optics: "lw_staged",
    "sw_staged" (column-major, top at index 0) and "lw_canon", "sw_canon"
    (the layer-major inputs of the JAX package's fused cores; the port's
    are allsky_pair_fused). Call them through allsky_pair_cores."""
    import os

    import torch

    from .drivers import rfmip
    from .drivers.allsky import make_clouds
    from .drivers.rfmip_io import rfmip_data_from_arrays
    from .extensions.cloud_optics import load_cloud_optics
    from .gas_concs import GasConcs
    from .gasoptics.planck import PlanckTable, lw_spectral_g128
    from .models.network import load_model_netcdf
    from .utils.ncio import write_nc

    dtype = dtype or torch.float32
    pair = sw_pair_setup(directory, width, device=device, dtype=dtype)
    lw_spec = lw_spectral_g128()
    paths, cloud = {}, {}
    for band, spec in (("lw", lw_spec), ("sw", pair["spectral"])):
        for flavour in ALLSKY_PAIR_FLAVOURS:
            key = f"{band}_{flavour}"
            paths[key] = os.path.join(directory, f"cloud-{band}{spec.ngpt}-{flavour}-{seed}.nc")
            if not os.path.exists(paths[key]):
                write_nc(paths[key], *cloud_optics_nc_variables(
                    synthesize_cloud_optics(spec, seed, flavour)))
            cloud[key] = load_cloud_optics(paths[key], dtype=dtype, device=device)
    data = synthesize_rfmip(ncol, nlay, seed, top_at_1=True)
    rd = rfmip_data_from_arrays(data)
    play, plev, tlay, tlev, tsfc, emis, concs = rfmip.lw_staged_inputs(rd, lw_spec, device,
                                                                        dtype)
    alb = torch.as_tensor(data["sfc_alb"], dtype=dtype, device=device)[:, None].expand(
        ncol, pair["spectral"].nband)
    gases = GasConcs(concs)
    concs = {k: gases.get_vmr(k, ncol, nlay).contiguous() for k in concs}
    cloud_col = ((np.arange(ncol) + 1) % 3) != 0
    clouds = make_clouds(play, tlay, cloud["lw_lut"],
                         cloud_col=torch.as_tensor(cloud_col, dtype=dtype, device=device))
    cos_sza = np.cos(np.deg2rad(data["sza"]))
    mu0 = torch.as_tensor(np.clip(cos_sza.astype(np.float32), 0.05, 1.0), dtype=dtype,
                          device=device)
    canon = lambda a: a.T.contiguous()
    concs_t = {k: canon(v) for k, v in concs.items()}
    play_t, plev_t, tlay_t, tlev_t, *cld_t = map(canon, (play, plev, tlay, tlev, *clouds))
    return {
        "sw": pair, "solar": torch.as_tensor(pair["solar"], dtype=dtype, device=device),
        "lw_models": [load_model_netcdf(artifact_path(LW_NET_64), device=device, dtype=dtype)],
        "lw_spectral": lw_spec,
        "table": PlanckTable.compute(lw_spec.band_lims_wvn_array, device=device, dtype=dtype),
        "cloud": cloud, "cloud_paths": paths, "data": data, "cloud_col": cloud_col,
        "mu0": mu0, "day": torch.as_tensor(cos_sza > 0.0, device=device), "clouds": clouds,
        "lw_staged": (play, plev, tlay, tlev, tsfc, emis, *clouds, concs),
        "sw_staged": (play, plev, tlay, mu0, alb, alb, *clouds, concs),
        "lw_canon": (play_t, plev_t, tlay_t, tlev_t, tsfc, emis, *cld_t, concs_t),
        "sw_canon": (play_t, plev_t, tlay_t, mu0, alb, alb, *cld_t, concs_t),
    }


ALLSKY_PAIR_CORES = ("lw_fused", "lw_staged", "lw_lay_major", "sw_fused", "sw_staged",
                     "sw_parallel")


def allsky_pair_fused(p: dict, band: str, flavour: str) -> tuple:
    """The positional arguments of ``fused.lw_args`` / ``lw_core``
    (``band`` "lw") or ``fused.sw_args`` / ``sw_core`` ("sw"), clouds last,
    on the problem ``p`` (allsky_pair_setup) with ``flavour`` cloud optics:
    the SW boundary as the all-sky drivers pose it (``fused.sw_boundary``)."""
    from .drivers import fused

    play_t, plev_t, tlay_t, tlev_t, tsfc, emis, *cld_t, concs_t = p["lw_canon"]
    clouds = (p["cloud"][f"{band}_{flavour}"], tuple(cld_t))
    if band == "lw":
        return (p["lw_models"], p["table"], p["lw_spectral"], play_t, plev_t, tlay_t, tlev_t,
                tsfc, emis, concs_t, clouds)
    _, _, _, mu0, alb_dir, alb_dif, *_ = p["sw_canon"]
    spectral = p["sw"]["spectral"]
    return (p["sw"]["models"], spectral, play_t, plev_t, tlay_t, mu0,
            *fused.sw_boundary(spectral, p["solar"], alb_dir, alb_dif), concs_t, clouds)


def allsky_pair_cores(p: dict, flavour: str) -> dict:
    """The all-sky cores of both bands on the problem ``p``
    (allsky_pair_setup) with ``flavour`` ("lut" or "pade") cloud optics, as
    closures by ALLSKY_PAIR_CORES name: "lw_fused" / "sw_fused" the fused
    cores (K1 / K2 in the flavour's cloud mode on CUDA), "lw_staged" the
    general LW core with one angle (K3, then K7), "lw_lay_major" the
    layer-major LW core (PyTorch sweeps: the CPU oracle), "sw_staged" the
    layer-major SW core (K5, then the PyTorch sweeps), "sw_parallel" the
    general SW core with the log-depth adding."""
    from .drivers import allsky, fused

    lw_m, sw_m = p["lw_models"], p["sw"]["models"]
    lw_head = (lw_m, p["table"], p["lw_spectral"], p["cloud"][f"lw_{flavour}"])
    sw_head = (sw_m, p["sw"]["spectral"], p["solar"], p["cloud"][f"sw_{flavour}"])
    return {
        "lw_fused": lambda: fused.lw_core(*allsky_pair_fused(p, "lw", flavour), top_at_1=True),
        "lw_staged": lambda: allsky._allsky_lw_core(*lw_head, *p["lw_staged"], top_at_1=True,
                                                    n_gauss_angles=1),
        "lw_lay_major": lambda: allsky._allsky_lw_core_lay_major(*lw_head, *p["lw_staged"],
                                                                 top_at_1=True),
        "sw_fused": lambda: fused.sw_core(*allsky_pair_fused(p, "sw", flavour), top_at_1=True),
        "sw_staged": lambda: allsky._allsky_sw_core_lay_major(*sw_head, *p["sw_staged"],
                                                              top_at_1=True),
        "sw_parallel": lambda: allsky._allsky_sw_core(*sw_head, *p["sw_staged"], top_at_1=True,
                                                      scan_mode="parallel"),
    }


def without_clouds(kw: dict) -> dict:
    """A fused kernel's cloud keywords (fused.lw_args / fused.sw_args)
    with every cloud field set to 0."""
    import torch

    z = lambda v: torch.zeros_like(v) if torch.is_tensor(v) else tuple(map(torch.zeros_like, v))
    return {k: (z(v) if k in ("cld_fields", "cld_bands", "cld_tau_band") else v)
            for k, v in kw.items()}


def allsky_pair_optics64(p64: dict, flavour: str):
    """allsky_sw_optics64 of the float64 problem ``p64`` (allsky_pair_setup)
    with its ``flavour`` SW cloud optics."""
    play, plev, tlay, *_, concs = p64["sw_staged"]
    return allsky_sw_optics64(play, plev, tlay, concs, p64["cloud_col"], p64["sw"]["models"],
                              p64["cloud"]["lw_lut"], p64["cloud"][f"sw_{flavour}"],
                              p64["sw"]["spectral"])


def allsky_pair_resonance_distance(p64: dict, flavour: str) -> np.ndarray:
    """Per column of the float64 problem ``p64`` (allsky_pair_setup), the
    smallest |k*mu0 - 1| over layers and g-points after the ``flavour``
    clouds' delta-scaled increment."""
    return _resonance(allsky_pair_optics64(p64, flavour), _cpu64(p64["mu0"]))
