"""The benchmark's input generators: numpy only, from a seed, so the
traffic stays fixed whatever the program does.

Copies of the port's ``testing.synthesize_rfmip``,
``testing.synthesize_rfmip_experiments`` (with the reference-scenario VMRs
of ``gas_concs``), ``drivers.gcm.synthesize_gcm_columns`` (here on the
numpy dict, with the Garand file's gases) and the lookup-table flavour of
``testing.synthesize_cloud_optics``, and a netCDF-3 writer of the
cloud-optics coefficient file. Same arrays from the same seed as those
functions (a test holds them against each other).
"""
from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

# reference-scenario global-mean VMRs (mo_gas_ref_concentrations.F90:46-60):
# present-day, pre-industrial, future
REF_VMR = {
    "co2": (397.5470e-6, 284.3170e-6, 1066.850e-6),
    "n2o": (326.9880e-9, 273.0211e-9, 389.3560e-9),
    "ch4": (1831.471e-9, 808.2490e-9, 2478.709e-9),
}
# RFMIP's 18 experiments by the (co2, ch4, n2o) they take: present-day,
# pre-industrial, future, a multiple of pre-industrial CO2 with present-day
# CH4 and N2O, one gas pre-industrial, or the Last Glacial Maximum
RFMIP_EXPERIMENTS = (
    "pd", "pi", 4.0, "fut", 0.5, 2.0, 3.0, 8.0, "pi_co2", "pi_ch4", "pi_n2o",
    "pd", "pd", "pd", "pd", "pi", "fut", "lgm")
# the gases of the all-sky example's Garand file
GARAND_GASES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2")


def state_seed(seed: int, k: int) -> int:
    """The seed of a run's k-th input state."""
    return int(np.random.SeedSequence([int(seed), int(k)]).generate_state(1, np.uint64)[0])


def synthesize_rfmip(ncol: int, nlay: int, seed: int) -> dict:
    """A clear-sky RFMIP-like problem, top of the atmosphere first: float32
    play/tlay (ncol, nlay), plev/tlev (ncol, nlay+1), tsfc/sfc_emis/sfc_alb/
    sza/tsi (ncol,) and ``gases`` (h2o, o3 2-D; co2 2-D, constant in height;
    ch4, n2o per-layer profiles; cfc11, cfc12 scalars); sza spans 0-120 deg,
    so about a quarter of the columns are night."""
    rng = np.random.default_rng(seed)
    psfc = rng.uniform(95000.0, 103000.0, ncol)
    frac = np.exp(np.linspace(np.log(1.0e-4), 0.0, nlay + 1))
    plev = psfc[:, None] * frac[None, :]
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    sigma = play / psfc[:, None]
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
    gases = {"h2o": h2o, "o3": o3, "co2": co2, "ch4": ch4, "n2o": n2o,
             "cfc11": np.asarray(2.3e-10), "cfc12": np.asarray(5.2e-10)}
    out = {"play": play, "plev": plev, "tlay": tlay, "tlev": tlev, "tsfc": tsfc,
           "sfc_emis": rng.uniform(0.9, 1.0, ncol), "sfc_alb": rng.uniform(0.05, 0.3, ncol),
           "sza": rng.uniform(0.0, 120.0, ncol), "tsi": rng.uniform(1355.0, 1365.0, ncol)}
    out = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}
    out["gases"] = {k: np.array(v, dtype=np.float32) for k, v in gases.items()}
    out["top_at_1"] = True
    return out


def experiment_gases(scenario) -> tuple:
    """(co2, ch4, n2o) VMRs of one RFMIP_EXPERIMENTS entry."""
    ref = lambda i: tuple(REF_VMR[g][i] for g in ("co2", "ch4", "n2o"))
    pd, pi = ref(0), ref(1)
    if isinstance(scenario, float):
        return (scenario * pi[0], pd[1], pd[2])
    return {"pd": pd, "pi": pi, "fut": ref(2), "pi_co2": (pi[0], pd[1], pd[2]),
            "pi_ch4": (pd[0], pi[1], pd[2]), "pi_n2o": (pd[0], pd[1], pi[2]),
            "lgm": (180e-6, 350e-9, 200e-9)}[scenario]


def synthesize_rfmip_experiments(nexp: int, nsites: int, nlay: int, seed: int) -> dict:
    """``nexp`` RFMIP experiments over the same ``nsites`` sites
    (synthesize_rfmip of the sites, repeated experiment-major), CO2, CH4
    and N2O set per experiment (2-D, constant in height and over the
    sites). Holds ``nexp``."""
    site = synthesize_rfmip(nsites, nlay, seed)
    out = {k: np.ascontiguousarray(np.concatenate([v] * nexp, axis=0))
           for k, v in site.items() if isinstance(v, np.ndarray)}
    gases = {k: (np.concatenate([v] * nexp, axis=0) if v.ndim == 2 else v)
             for k, v in site["gases"].items()}
    for name, k in (("co2", 0), ("ch4", 1), ("n2o", 2)):
        vmr = np.repeat([experiment_gases(s)[k] for s in RFMIP_EXPERIMENTS[:nexp]], nsites)
        gases[name] = np.ascontiguousarray(
            np.broadcast_to(vmr[:, None], (nexp * nsites, nlay)), dtype=np.float32)
    out.update(gases=gases, top_at_1=True, nexp=nexp)
    return out


def synthesize_gcm_columns(base: dict, ncol_target: int, seed: int) -> dict:
    """Tile and perturb the columns of ``base`` (a synthesize_rfmip dict) up
    to ``ncol_target`` columns, keeping the Garand file's gases: host
    arrays, column first; a gas constant in height travels as (ncol,)."""
    rng = np.random.default_rng(seed)
    ncol = base["play"].shape[0]
    idx = np.tile(np.arange(ncol), int(np.ceil(ncol_target / ncol)))[:ncol_target]
    tpert = rng.uniform(-2.0, 2.0, (ncol_target, 1)).astype(np.float32)
    out = {"play": base["play"][idx], "plev": base["plev"][idx],
           "tlay": base["tlay"][idx] + tpert, "tlev": base["tlev"][idx] + tpert,
           "tsfc": base["tsfc"][idx] + tpert[:, 0], "sfc_emis": base["sfc_emis"][idx],
           "sfc_alb": base["sfc_alb"][idx], "sza": base["sza"][idx], "tsi": base["tsi"][idx]}
    for g, v in base["gases"].items():
        if g not in GARAND_GASES:
            continue
        v = np.asarray(v)
        if v.ndim == 1:
            v = np.broadcast_to(v[None, :], (ncol, v.shape[0]))
        if v.ndim == 2:
            vi = v[idx]
            if np.all(vi == vi[:, :1]):
                vi = vi[:, 0]
            out[f"gas:{g}"] = vi
        else:
            out[f"gas:{g}"] = np.broadcast_to(v, (ncol_target,)).copy()
    return out


def synthesize_cloud_lut(band_lims: np.ndarray, seed: int) -> dict:
    """Lookup-table cloud-optics coefficients on these bands, float64 under
    the coefficient file's names: ``lut_{ext,ssa,asy}liq`` (nband, 20) over
    2.5-21.5 microns, ``lut_{ext,ssa,asy}ice`` (3 roughness classes, nband,
    18) over 10-180 microns, smooth in radius, ext > 0, 0 < ssa, g < 1."""
    rng = np.random.default_rng(seed)
    nband = len(band_lims)
    out = {"bnd_limits_wavenumber": np.asarray(band_lims, np.float64),
           "radliq_lwr": np.float64(2.5), "radliq_upr": np.float64(21.5),
           "radice_lwr": np.float64(10.0), "radice_upr": np.float64(180.0)}

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


def write_cloud_file(path: str, lut: dict) -> None:
    """A synthesize_cloud_lut dict as the cloud-optics coefficient file
    (netCDF-3)."""
    nband = lut["bnd_limits_wavenumber"].shape[0]
    with netcdf_file(path, "w") as f:
        f.createDimension("nband", nband)
        f.createDimension("pair", 2)
        f.createDimension("nrghice", lut["lut_extice"].shape[0])
        f.createDimension("nsize_liq", lut["lut_extliq"].shape[1])
        f.createDimension("nsize_ice", lut["lut_extice"].shape[2])
        for name, v in lut.items():
            v = np.asarray(v, np.float64)
            if name == "bnd_limits_wavenumber":
                dims = ("nband", "pair")
            elif v.ndim == 0:
                dims = ()
            elif name.endswith("liq"):
                dims = ("nband", "nsize_liq")
            else:
                dims = ("nrghice", "nband", "nsize_ice")
            f.createVariable(name, "d", dims)[...] = v
