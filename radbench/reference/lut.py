"""Plain reference of RRTMGP's lookup-table gas optics, with the fluxes
behind it, in PyTorch tensor operations of any precision, on any device.

It imports neither JAX nor the port: it reads the k-distribution's netCDF
file itself (scipy) and keeps every gas and minor-absorber interval the file
names, so the inputs must hold each of its gases. The equations are those of
``mo_gas_optics_kernels.F90``:
  - column dry air (``physics.col_dry``) and the gas columns, VMR times dry
    air;
  - ``interpolation`` (:47-144): the lower temperature index and fraction,
    the lower pressure index and fraction on the log-pressure grid, the
    troposphere where log(play) exceeds the file's log(press_ref_trop), and
    for the two key species of each g-point's band and atmosphere, at each
    of the two temperature nodes, the mixing column col1 + r * col2 (r the
    ratio of their reference VMRs at that node) and eta = col1 / that, on
    the eta grid;
  - the major absorbers (``gas_optical_depths_major``, :300-350): the
    mixing column times the trilinear (temperature, pressure, eta)
    interpolation of kmajor, the upper atmosphere's pressure plane shifted
    by one;
  - the minor absorbers (``gas_optical_depths_minor``, :360-462): in each
    interval's g-points and atmosphere, the gas column, times the density
    play/tlay in hPa/K where the interval scales with density, times the
    scaling gas's share of the dry air (or its complement), times the
    bilinear (temperature, eta) interpolation of kminor;
  - Rayleigh (``compute_tau_rayleigh``, :469-511): the bilinear
    interpolation of the atmosphere's table times dry air plus water;
  - the Planck fraction, the unscaled trilinear interpolation of
    plank_fraction, times the band Planck radiance interpolated linearly in
    the file's totplnk (``compute_Planck_source``, :514-611): a level takes
    the fraction of the layer below it, top first, the surface that of the
    lowest layer;
  - the solar source: the NRLSSI2 quiet, facular and sunspot terms at the
    file's default indices (mo_gas_optics_rrtmgp.F90:1058-1095).
The transport is ``physics.lw_transport`` (one angle) and
``physics.sw_solve`` (g = 0, ssa Rayleigh over the total), as for the nets.

Departures, each noted where it is made:
  - the troposphere's branch is taken where ``decide`` (the precision that
    the program under test computes log(play) in) puts it, the rest in the
    working precision: the branch is a step, and a layer within a rounding of
    the tropopause would otherwise take the other table;
  - vertical order: inputs with the surface first are turned over, solved
    top first and turned back;
  - ``Precision.tf32``: every table and every interpolation weight is
    rounded to TF32 as ``physics.tf32_round`` rounds (the control).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.io import netcdf_file

from . import physics as P

PA_TO_HPA = 0.01
# NRLSSI2 facular and sunspot index offsets (mo_gas_optics_rrtmgp.F90:1075-1083)
SOLAR_A_OFFSET, SOLAR_B_OFFSET = 0.1495954, 0.00066696


def _names(var) -> list:
    return [b"".join(r).decode().strip("\x00 ").lower() for r in np.atleast_2d(var[:])]


@dataclasses.dataclass
class Minor:
    """One atmosphere's minor-absorber intervals: g-point ranges (0-based,
    half-open), the gas's column index, the scaling gas's (0: none), the
    flags and the first kminor row of each."""
    gpts: list
    gas: list
    scaling_gas: list
    by_density: list
    by_complement: list
    start: list
    kminor: np.ndarray  # (ntemp, neta, contributors)


@dataclasses.dataclass
class KDistFile:
    """A k-distribution file's tables, float64, and what each g-point reads.
    Column indices: 0 dry air, 1 + i the file's i-th gas."""
    gases: list
    band_gpts: list  # [(start, end)] per band
    log_p: np.ndarray  # (npres,) log(press_ref), decreasing
    temp: np.ndarray  # (ntemp,)
    log_p_trop: float
    vmr_ref: np.ndarray  # (ntemp, 1 + ngas, 2): [.., .., 0] lower, 1 upper
    key: np.ndarray  # (ngpt, 2 atmospheres, 2) column index of each key species
    kmajor: np.ndarray  # (ntemp, npres + 1, neta, ngpt)
    minor: tuple  # (lower, upper) Minor
    pfrac: np.ndarray = None  # LW: like kmajor
    totplnk: np.ndarray = None  # LW: (nPlanckTemp, nband)
    krayl: np.ndarray = None  # SW: (2, ntemp, neta, ngpt)
    solar: np.ndarray = None  # SW: (ngpt,) at the default indices

    @property
    def ngpt(self) -> int:
        return self.kmajor.shape[-1]

    @property
    def gpt2band(self) -> np.ndarray:
        return np.concatenate([np.full(e - s, b) for b, (s, e) in enumerate(self.band_gpts)])


def read_kdist(path: str) -> KDistFile:
    """The k-distribution netCDF file at ``path`` (the variable set of
    examples/mo_load_coefficients.F90), every gas kept."""
    with netcdf_file(path, "r", mmap=False) as f:
        v = f.variables
        a = lambda n: np.array(v[n].data, np.float64)
        gases = _names(v["gas_names"])
        col = lambda name: 1 + gases.index(name) if name in gases else 0
        band_gpts = [(int(s) - 1, int(e)) for s, e in np.array(v["bnd_limits_gpt"][:])]
        ks = np.array(v["key_species"][:], int)  # (nband, atmosphere, pair), 1-based gases
        # a band with no key species takes the second gas for both
        # (mo_gas_optics_rrtmgp.F90:1509-1514)
        ks[(ks == 0).all(axis=2)] = 2
        g2b = np.concatenate([np.full(e - s, b) for b, (s, e) in enumerate(band_gpts)])
        ident = _names(v["identifier_minor"])
        base = _names(v["gas_minor"])

        def minor(side):
            names = _names(v[f"minor_gases_{side}"])
            lims = np.array(v[f"minor_limits_gpt_{side}"][:], int).reshape(len(names), 2)
            return Minor(gpts=[(int(s) - 1, int(e)) for s, e in lims],
                         gas=[col(base[ident.index(n)]) for n in names],
                         scaling_gas=[col(n) for n in _names(v[f"scaling_gas_{side}"])],
                         by_density=[bool(x) for x in np.ravel(v[f"minor_scales_with_density_{side}"][:])],
                         by_complement=[bool(x) for x in np.ravel(v[f"scale_by_complement_{side}"][:])],
                         start=[int(x) - 1 for x in np.ravel(v[f"kminor_start_{side}"][:])],
                         kminor=a(f"kminor_{side}"))

        out = KDistFile(gases=gases, band_gpts=band_gpts, log_p=np.log(a("press_ref")),
                        temp=a("temp_ref"), log_p_trop=float(np.log(a("press_ref_trop"))),
                        vmr_ref=a("vmr_ref"), key=ks[g2b], kmajor=a("kmajor"),
                        minor=(minor("lower"), minor("upper")))
        if "totplnk" in v:
            out.pfrac, out.totplnk = a("plank_fraction"), a("totplnk").T
        else:
            out.krayl = np.stack([a("rayl_lower"), a("rayl_upper")])
            out.solar = (a("solar_source_quiet")
                         + (float(a("mg_default")) - SOLAR_A_OFFSET) * a("solar_source_facular")
                         + (float(a("sb_default")) - SOLAR_B_OFFSET) * a("solar_source_sunspot"))
    return out


class KDistOn:
    """A KDistFile's tables on a device, in a precision (TF32-rounded for
    the control)."""

    def __init__(self, kd: KDistFile, device, prec: P.Precision):
        self.kd, self.prec = kd, prec
        t = lambda x: None if x is None else self.round(
            torch.as_tensor(np.asarray(x), dtype=prec.dtype, device=device))
        self.kmajor, self.vmr_ref = t(kd.kmajor), t(kd.vmr_ref)
        self.kminor = [t(m.kminor) for m in kd.minor]
        self.pfrac, self.totplnk, self.krayl, self.solar = (
            t(kd.pfrac), t(kd.totplnk), t(kd.krayl), t(kd.solar))
        self.key = torch.as_tensor(kd.key, device=device)
        self.band = torch.as_tensor(kd.gpt2band, device=device)

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return P.tf32_round(x) if self.prec.tf32 else x


def interpolation(k: KDistOn, play, tlay, col, decide: torch.dtype) -> dict:
    """The interpolation state of every (column, layer, g-point): indices
    and fractions in temperature and pressure, the troposphere, and per
    temperature node the key species' mixing column, eta index and
    fraction."""
    kd = k.kd
    ntemp, npres, neta = len(kd.temp), len(kd.log_p), kd.kmajor.shape[2]
    dt = (kd.temp[-1] - kd.temp[0]) / (ntemp - 1)
    dlogp = (kd.log_p.min() - kd.log_p.max()) / (npres - 1)
    jt = torch.clamp(((tlay - (kd.temp[0] - dt)) / dt).long() - 1, 0, ntemp - 2)
    ft = (tlay - torch.as_tensor(kd.temp, dtype=tlay.dtype, device=tlay.device)[jt]) / dt
    logp = torch.log(play)
    loc = (logp - kd.log_p[0]) / dlogp
    jp = torch.clamp(loc.long(), 0, npres - 2)
    fp = loc - jp.to(loc.dtype)
    # departure: the branch is taken in the program's precision (see above)
    tropo = torch.log(play.to(decide)) > kd.log_p_trop
    up = (~tropo).long()  # 0 lower, 1 upper atmosphere
    g = torch.arange(kd.ngpt, device=play.device)
    key = k.key[g, up[..., None]]  # (ncol, nlay, ngpt, pair): this atmosphere's key species
    c1 = torch.gather(col, 2, key[..., 0])  # (ncol, nlay, ngpt)
    c2 = torch.gather(col, 2, key[..., 1])
    tiny = torch.finfo(col.dtype).tiny
    nodes = []
    for d in (0, 1):
        vref = k.vmr_ref[(jt + d)[..., None, None], key, up[..., None, None]]
        mix = c1 + vref[..., 0] / vref[..., 1] * c2
        ok = mix > 2.0 * tiny
        eta = torch.where(ok, c1 / torch.where(ok, mix, 1.0), 0.5)
        loc_eta = eta * (neta - 1)
        je = torch.clamp(loc_eta.long(), 0, neta - 2)
        nodes.append((mix, je, loc_eta - je.to(loc_eta.dtype)))
    return {"jt": jt, "ft": ft, "jp": jp, "fp": fp, "tropo": tropo, "up": up, "nodes": nodes}


def _interp3(k: KDistOn, ic: dict, table, scaled: bool):
    """Trilinear (temperature, pressure, eta) interpolation of a (ntemp,
    npres + 1, neta, ngpt) table at every g-point, times the mixing column
    where ``scaled``."""
    ngpt = table.shape[-1]
    g = torch.arange(ngpt, device=table.device)
    out = 0.0
    for d in (0, 1):
        mix, je, fe = ic["nodes"][d]
        wt = (ic["ft"] if d else 1.0 - ic["ft"])[..., None]
        for dp in (0, 1):
            wp = (ic["fp"] if dp else 1.0 - ic["fp"])[..., None]
            jp = (ic["jp"] + ic["up"] + dp)[..., None]
            for de in (0, 1):
                w = wt * wp * (fe if de else 1.0 - fe)
                if scaled:
                    w = mix * w
                out = out + k.round(w) * table[(ic["jt"] + d)[..., None], jp, je + de, g]
    return out


def tau_absorption(k: KDistOn, ic: dict, play, tlay, col):
    """Major plus minor absorption optical depth (ncol, nlay, ngpt)."""
    kd = k.kd
    tau = _interp3(k, ic, k.kmajor, scaled=True)
    h2o = 1 + kd.gases.index("h2o")
    dry_share = 1.0 / (1.0 + col[..., h2o] / col[..., 0])  # dry air over dry air plus water
    density = PA_TO_HPA * play / tlay
    for atm, (m, kminor) in enumerate(zip(kd.minor, k.kminor)):
        inside = ic["tropo"] if atm == 0 else ~ic["tropo"]
        for i, (s, e) in enumerate(m.gpts):
            scale = col[..., m.gas[i]]
            if m.by_density[i]:
                scale = scale * density
                if m.scaling_gas[i]:
                    share = col[..., m.scaling_gas[i]] / col[..., 0] * dry_share
                    scale = scale * ((1.0 - share) if m.by_complement[i] else share)
            rows = torch.arange(m.start[i], m.start[i] + e - s, device=play.device)
            contrib = 0.0
            for d in (0, 1):
                _, je, fe = ic["nodes"][d]
                je, fe = je[..., s:e], fe[..., s:e]
                wt = (ic["ft"] if d else 1.0 - ic["ft"])[..., None]
                for de in (0, 1):
                    w = k.round(wt * (fe if de else 1.0 - fe))
                    contrib = contrib + w * kminor[(ic["jt"] + d)[..., None], je + de, rows]
            tau[..., s:e] = tau[..., s:e] + torch.where(inside[..., None],
                                                        scale[..., None] * contrib, 0.0)
    return tau


def tau_rayleigh(k: KDistOn, ic: dict, col):
    """Rayleigh optical depth (ncol, nlay, ngpt)."""
    g = torch.arange(k.kd.ngpt, device=col.device)
    out = 0.0
    for d in (0, 1):
        _, je, fe = ic["nodes"][d]
        wt = (ic["ft"] if d else 1.0 - ic["ft"])[..., None]
        for de in (0, 1):
            w = k.round(wt * (fe if de else 1.0 - fe))
            out = out + w * k.krayl[ic["up"][..., None], (ic["jt"] + d)[..., None], je + de, g]
    h2o = 1 + k.kd.gases.index("h2o")
    return out * (col[..., h2o] + col[..., 0])[..., None]


def planck(k: KDistOn, t):
    """Band Planck radiance at temperatures t (...) -> (..., nband): linear
    in the file's totplnk over the temperature grid's range, the index
    truncated toward zero and clamped, the fraction not."""
    kd = k.kd
    n = k.totplnk.shape[0]
    v = (t - kd.temp[0]) / ((kd.temp[-1] - kd.temp[0]) / (n - 1))
    i = torch.trunc(v)
    frac = (v - i)[..., None]
    i = torch.clamp(i, 0, n - 2).long()
    return k.totplnk[i] + frac * (k.totplnk[i + 1] - k.totplnk[i])


def _columns(k: KDistOn, plev, gases: dict, shape):
    """(ncol, nlay, 1 + ngas) column amounts: dry air, then the file's
    gases, each VMR (broadcastable to ``shape``) times dry air."""
    dry = P.col_dry(torch.broadcast_to(gases["h2o"], shape), plev)
    missing = [g for g in k.kd.gases if g not in gases]
    if missing:
        raise ValueError(f"the k-distribution's gases {missing} are not in the inputs")
    return torch.stack([dry] + [torch.broadcast_to(gases[g], shape) * dry for g in k.kd.gases],
                       dim=-1)


def _top_first(top_at_1: bool, *fields):
    return fields if top_at_1 else tuple(f.flip(1) for f in fields)


def lw_fluxes(k: KDistOn, play, plev, tlay, tlev, tsfc, emis, gases: dict, decide,
              top_at_1: bool = True):
    """LW broadband (flux_up, flux_dn) (ncol, nlay + 1) in the inputs'
    vertical order: one angle, emissivity ``emis`` (ncol,) in every band,
    the troposphere decided in ``decide``."""
    play, plev, tlay, tlev = _top_first(top_at_1, play, plev, tlay, tlev)
    gases = {g: v.flip(1) if not top_at_1 and v.ndim == 2 else v for g, v in gases.items()}
    col = _columns(k, plev, gases, play.shape)
    ic = interpolation(k, play, tlay, col, decide)
    tau = tau_absorption(k, ic, play, tlay, col)
    pfrac = _interp3(k, ic, k.pfrac, scaled=False)
    up, dn = P.lw_transport(tau, pfrac, planck(k, tlay)[..., k.band], planck(k, tlev)[..., k.band],
                            planck(k, tsfc)[..., k.band], emis)
    return _top_first(top_at_1, up, dn)


def sw_fluxes(k: KDistOn, play, plev, tlay, gases: dict, mu0, tsi, alb, decide,
              top_at_1: bool = True):
    """SW broadband (flux_up, flux_dn total, flux_dn direct) (ncol, nlay +
    1) in the inputs' vertical order: the solar source scaled to each
    column's total ``tsi`` (ncol,), falling at cos(zenith) ``mu0`` (ncol,),
    albedo ``alb`` (ncol,) for both beams."""
    play, plev, tlay = _top_first(top_at_1, play, plev, tlay)
    gases = {g: v.flip(1) if not top_at_1 and v.ndim == 2 else v for g, v in gases.items()}
    col = _columns(k, plev, gases, play.shape)
    ic = interpolation(k, play, tlay, col, decide)
    tau_a = tau_absorption(k, ic, play, tlay, col)
    tau_r = tau_rayleigh(k, ic, col)
    tau = tau_a + tau_r
    tiny = torch.finfo(tau.dtype).tiny
    ssa = torch.where(tau > 0, tau_r / torch.clamp_min(tau, tiny), 0.0)
    toa = k.solar[None, :] * (tsi / k.solar.sum())[:, None]
    out = P.sw_solve(tau, ssa, torch.zeros_like(tau), mu0, toa * mu0[:, None], alb)
    return _top_first(top_at_1, *out)
