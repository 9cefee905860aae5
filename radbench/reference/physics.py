"""Plain reference of the radiation that the benchmark's cells run, in
PyTorch tensor operations of any precision, on any device.

It imports neither JAX nor the port: it reads the same net files and the
same generated inputs the program gets, and works out everything else
itself (column dry air, the NN input scaling and the nets, the
post-processing, a Planck table, the solar source, cloud placement and
lookup-table cloud optics with delta scaling, the LW no-scattering
transport at the diffusivity angle, the SW PIFM two-stream coefficients and
the adding method, night masking). The equations are those of RTE+RRTMGP-NN:
  - NN gas optics (mo_gas_optics_rrtmgp.F90 :618-798; mod_network_rrtmgp.F90
    :125-409): features log(play), h2o**(1/4), o3**(1/4), other gases raw,
    tlay; missing gases zero; min-max scaled; softsign hidden layers;
    tau = (std * y + mean)**8 * col_dry, Planck fraction y**2;
  - Planck sources (mo_gas_optics_kernels.F90 :615-683) from a table of
    band-integrated Planck radiance at 1 K steps, linear interpolation;
  - LW transport (mo_rte_solver_kernels.F90 :119-330), linear-in-tau source
    (Clough 1992 Eq 13);
  - SW two-stream (:1364-1480, Zdunkowski PIFM, ecRAD arrangement, energy
    clamps) and adding (:1526-1637);
  - cloud optics (mo_cloud_optics.F90 :603-645, liquid and ice combined,
    then delta scaling with f = g**2, mo_optical_props.F90).

``Precision(dtype, tf32)``: the working dtype, and whether the nets' matrix
products take TF32 operands (the mantissa rounded to 10 bits, as the tensor
cores round it). The reference is float64; the control of the output check
is float32 with TF32 products.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.io import netcdf_file

# physical constants (mo_rrtmgp_constants.F90:30-64, 2018 SI values)
M_H2O, M_DRY = 0.018016, 0.028964   # kg/mol
AVOGAD = 6.02214076e23
GRAV = 9.80665
H_PLANCK, C_LIGHT, K_BOLTZ = 6.62607015e-34, 2.99792458e8, 1.380649e-23

# the single-angle LW solve: diffusivity secant and weight (Clough 1992)
LW_SECANT, LW_WEIGHT = 1.66, 0.5

LW_BAND_LIMS = np.array([
    [10.0, 250.0], [250.0, 500.0], [500.0, 630.0], [630.0, 700.0],
    [700.0, 820.0], [820.0, 980.0], [980.0, 1080.0], [1080.0, 1180.0],
    [1180.0, 1390.0], [1390.0, 1480.0], [1480.0, 1800.0], [1800.0, 2080.0],
    [2080.0, 2250.0], [2250.0, 2380.0], [2380.0, 2600.0], [2600.0, 3250.0]])
SW_BAND_LIMS = np.array([
    [820.0, 2680.0], [2680.0, 3250.0], [3250.0, 4000.0], [4000.0, 4650.0],
    [4650.0, 5150.0], [5150.0, 6150.0], [6150.0, 7700.0], [7700.0, 8050.0],
    [8050.0, 12850.0], [12850.0, 16000.0], [16000.0, 22650.0],
    [22650.0, 29000.0], [29000.0, 38000.0], [38000.0, 50000.0]])
# g-points per band of the g-128 LW and g-112 SW k-distributions
LW_G128 = (10, 14, 13, 13, 13, 5, 7, 6, 10, 7, 8, 8, 5, 3, 2, 4)
SW_G112 = (10, 8, 11, 8, 9, 10, 11, 4, 9, 9, 8, 4, 8, 3)
# share of the total solar irradiance in each of the 14 SW bands, and the
# g-112 quadrature weights within each band (the values the SW nets were
# calibrated with)
SW_BAND_FRAC = np.array([
    0.00909312, 0.00431360, 0.01349780, 0.01242415, 0.01245213,
    0.03365848, 0.06882194, 0.01813326, 0.26774213, 0.16940386,
    0.25643558, 0.09959361, 0.02677813, 0.00765220])
SW_G112_WEIGHTS = np.array([
    4.744510e-01, 6.595975e-02, 1.816000e-01, 6.120147e-02, 9.805695e-02, 5.860860e-02,
    4.772100e-02, 1.240117e-02, 0.000000e+00, 0.000000e+00,
    4.878908e-01, 0.000000e+00, 2.264766e-01, 8.324431e-02, 7.027994e-02, 7.638789e-02,
    4.699742e-02, 8.723056e-03,
    1.420353e-01, 1.882236e-01, 2.336958e-01, 1.366161e-01, 9.115447e-02, 8.815820e-02,
    5.921351e-02, 4.686406e-02, 1.013625e-02, 3.902698e-03, 0.000000e+00,
    6.093057e-01, 0.000000e+00, 2.302559e-01, 2.418488e-02, 8.003857e-02, 3.782881e-02,
    1.389124e-02, 4.494912e-03,
    6.267478e-01, 0.000000e+00, 1.336020e-01, 1.572723e-01, 1.283346e-02, 5.816937e-02,
    3.335073e-03, 6.700779e-03, 1.339150e-03,
    4.464527e-01, 1.278056e-01, 1.257601e-01, 8.916908e-02, 9.163224e-02, 6.031463e-02,
    4.344327e-02, 1.194205e-02, 2.544567e-03, 9.358611e-04,
    3.024887e-01, 1.386793e-01, 1.360908e-01, 1.125309e-01, 1.068824e-01, 8.335674e-02,
    6.080678e-02, 4.478720e-02, 1.028710e-02, 3.377065e-03, 7.129892e-04,
    9.518136e-01, 3.029497e-02, 1.757651e-02, 3.149473e-04,
    5.968806e-01, 7.718770e-02, 1.249199e-01, 8.063259e-02, 6.139691e-02, 4.330772e-02,
    8.408561e-03, 5.515603e-03, 1.750396e-03,
    3.450730e-01, 5.322559e-01, 5.999247e-02, 4.880588e-02, 3.673054e-03, 6.426522e-03,
    8.384651e-04, 2.678180e-03, 2.565694e-04,
    0.000000e+00, 2.112400e-01, 1.216404e-01, 2.333712e-01, 3.599011e-01, 0.000000e+00,
    6.760912e-02, 6.238176e-03,
    1.000000e+00, 0.000000e+00, 0.000000e+00, 0.000000e+00,
    1.317331e-01, 0.000000e+00, 1.725765e-01, 1.395657e-01, 1.292342e-01, 1.197905e-01,
    1.140565e-01, 1.930434e-01,
    5.062469e-01, 0.000000e+00, 4.937531e-01])
TSI_DEFAULT = 1360.85  # W/m2, the solar source's total without a per-column TSI

# idealized cloud placement of the all-sky example (rrtmgp_allsky.F90:329-350)
CLOUD_P = (100.0e2, 900.0e2)  # Pa: clouds strictly between
CLOUD_T_LIQ, CLOUD_T_ICE = 263.0, 273.0  # K: liquid above, ice below
CLOUD_WP = 10.0  # g/m2 of each phase present


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def gpt2band(counts) -> np.ndarray:
    return np.repeat(np.arange(len(counts)), counts)


# ---------------------------------------------------------------- the nets

@dataclasses.dataclass
class Net:
    """An MLP as the reference's netCDF file stores it."""
    weights: list   # (n_in, n_out) each
    biases: list
    activations: tuple
    input_names: tuple
    input_min: np.ndarray
    input_max: np.ndarray
    output_mean: np.ndarray
    output_std: np.ndarray

    @property
    def dims(self) -> list:
        return [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]


def _strings(var) -> tuple:
    return tuple(b"".join(row).decode().strip("\x00 ").lower() for row in np.asarray(var[:]))


def read_net(path: str) -> Net:
    """A net in the reference's netCDF-3 format (nn_weights_i (n_in, n_out),
    nn_bias_i, nn_activation_char, nn_inputs_char, the input min / max and
    the output mean / std)."""
    with netcdf_file(path, "r", mmap=False) as f:
        v = f.variables
        n = f.dimensions["nn_layers"]
        w = [np.array(v[f"nn_weights_{i}"][:], np.float32) for i in range(1, n + 1)]
        b = [np.array(v[f"nn_bias_{i}"][:], np.float32) for i in range(1, n + 1)]
        return Net(w, b, _strings(v["nn_activation_char"]), _strings(v["nn_inputs_char"]),
                   np.array(v["nn_input_coeffs_min"][:], np.float32),
                   np.array(v["nn_input_coeffs_max"][:], np.float32),
                   np.array(v["nn_output_coeffs_mean"][:], np.float32),
                   np.array(v["nn_output_coeffs_std"][:], np.float32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest, ties
    to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# the hidden layers' activations of the configurations' nets
ACT = {"softsign": lambda h: h / (1.0 + torch.abs(h)), "linear": lambda h: h}


class NetOn:
    """A net's tensors on a device, in a precision."""

    def __init__(self, net: Net, device, prec: Precision):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=prec.dtype, device=device)
        self.net, self.prec = net, prec
        self.w = [t(w) for w in net.weights]
        self.b = [t(b) for b in net.biases]
        self.in_min, self.in_max = t(net.input_min), t(net.input_max)
        self.mean, self.std = t(net.output_mean), t(net.output_std)

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output before any activation."""
        h = x
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            if self.prec.tf32:
                h = tf32_round(h) @ tf32_round(w) + b
            else:
                h = h @ w + b
            if i + 1 < len(self.w):
                h = ACT[self.net.activations[i]](h)
        return h

    def tau(self, y: torch.Tensor, col_dry: torch.Tensor) -> torch.Tensor:
        n = y.shape[-1]
        return (self.std[:n] * y + self.mean[:n]) ** 8 * col_dry[..., None]


# ------------------------------------------------------------ gas optics

def col_dry(h2o: torch.Tensor, plev: torch.Tensor) -> torch.Tensor:
    """Dry-air molecules per cm2 in each layer (hydrostatic)."""
    fact = 1.0 / (1.0 + h2o)
    m_air = (M_DRY + M_H2O * h2o) * fact
    dp = torch.abs(plev[:, :-1] - plev[:, 1:])
    return 10.0 * dp * AVOGAD * fact / (1000.0 * m_air * 100.0 * GRAV)


def features(net: NetOn, play, tlay, gases: dict) -> torch.Tensor:
    """The scaled NN inputs (ncol, nlay, n_inputs). ``gases``: VMRs, each
    broadcastable to (ncol, nlay)."""
    cols = []
    for name in net.net.input_names:
        if name == "tlay":
            v = tlay
        elif name == "play":
            v = torch.log(play)
        elif name in gases:
            v = torch.broadcast_to(gases[name], play.shape)
            if name in ("h2o", "o3"):
                v = torch.sqrt(torch.sqrt(v))
        else:
            v = torch.zeros_like(play)
        cols.append(v)
    return (torch.stack(cols, dim=-1) - net.in_min) / (net.in_max - net.in_min)


def planck_table(band_lims, dtype, device, t_min=160.0, t_max=355.0, n_quad=256):
    """Band-integrated Planck radiance [W/m2/sr] at 1 K steps from t_min to
    t_max, by Gauss-Legendre quadrature over each band, in float64 on the
    host; returned as a (ntemp, nband) tensor."""
    temps = np.arange(t_min, t_max + 0.5, 1.0)
    x, w = np.polynomial.legendre.leggauss(n_quad)
    out = np.zeros((temps.size, len(band_lims)))
    for ib, (lo, hi) in enumerate(np.asarray(band_lims, np.float64)):
        nu = (0.5 * (x + 1.0) * (hi - lo) + lo) * 100.0  # m-1
        wgt = w * 0.5 * (hi - lo) * 100.0
        e = np.exp(np.clip(H_PLANCK * C_LIGHT * nu[None] / (K_BOLTZ * temps[:, None]), None, 700))
        out[:, ib] = (2.0 * H_PLANCK * C_LIGHT ** 2 * nu[None] ** 3 / (e - 1.0)) @ wgt
    return torch.as_tensor(out, dtype=dtype, device=device), float(t_min)


def planck_at(table, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the table at temperatures t (...) -> (...,
    nband): index truncated toward zero and clamped, fraction not."""
    tab, t_min = table
    v = t - t_min
    i = torch.clamp(torch.trunc(v), 0, tab.shape[0] - 2)
    frac = (v - torch.trunc(v))[..., None]
    i = i.long()
    return tab[i] + frac * (tab[i + 1] - tab[i])


def solar_source(tsi: float = TSI_DEFAULT) -> np.ndarray:
    """TOA solar flux per g-point of the g-112 mapping, summing to ``tsi``."""
    out = np.zeros(sum(SW_G112))
    band = gpt2band(SW_G112)
    for ib in range(len(SW_G112)):
        sel = band == ib
        out[sel] = tsi * SW_BAND_FRAC[ib] * SW_G112_WEIGHTS[sel]
    return out


# ------------------------------------------------------------ clouds

def cloud_fields(play, tlay, cloud_col, radii):
    """The all-sky example's cloud placement: (lwp, iwp, rel, rei), each
    (ncol, nlay); ``cloud_col`` (ncol,) bool; ``radii`` = (liquid, ice)
    effective radius of a cloudy cell."""
    mask = (play > CLOUD_P[0]) & (play < CLOUD_P[1]) & cloud_col[:, None]
    liq = mask & (tlay > CLOUD_T_LIQ)
    ice = mask & (tlay < CLOUD_T_ICE)
    z = torch.zeros_like(play)
    return (torch.where(liq, CLOUD_WP, z), torch.where(ice, CLOUD_WP, z),
            torch.where(liq, radii[0], z), torch.where(ice, radii[1], z))


def lut_phase(wp, re, tables, r_lo, r_hi):
    """One phase's (tau, ssa, g) per band from lookup tables (ext, ssa, asy),
    each (nband, nsize), linear in radius on an even grid from r_lo to r_hi;
    tau 0 where wp is 0."""
    ext, ssa, asy = tables
    n = ext.shape[1]
    step = (r_hi - r_lo) / (n - 1)
    f = (re - r_lo) / step
    i = torch.clamp(torch.floor(f), 0, n - 2)
    frac = (f - i)[..., None]
    i = i.long()
    lerp = lambda t: t.T[i] + frac * (t.T[i + 1] - t.T[i])
    tau = torch.where((wp > 0)[..., None], wp[..., None] * lerp(ext), 0.0)
    return tau, lerp(ssa), lerp(asy)


def cloud_optics(fields, lut: dict, prec: Precision, device):
    """Liquid and ice combined: (tau, ssa, g) per band, each (ncol, nlay,
    nband). ``lut``: the coefficient arrays (first ice roughness)."""
    lwp, iwp, rel, rei = fields
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=prec.dtype, device=device)
    tl, sl, gl = lut_phase(lwp, rel, [t(lut[f"lut_{k}liq"]) for k in ("ext", "ssa", "asy")],
                           float(lut["radliq_lwr"]), float(lut["radliq_upr"]))
    ti, si, gi = lut_phase(iwp, rei, [t(lut[f"lut_{k}ice"][0]) for k in ("ext", "ssa", "asy")],
                           float(lut["radice_lwr"]), float(lut["radice_upr"]))
    tau = tl + ti
    scat = tl * sl + ti * si
    tiny = torch.finfo(prec.dtype).tiny
    ssa = torch.where(tau > 0, scat / torch.clamp_min(tau, tiny), 0.0)
    g = torch.where(scat > 0, (tl * sl * gl + ti * si * gi) / torch.clamp_min(scat, tiny), 0.0)
    return tau, ssa, g


def delta_scale(tau, ssa, g):
    """Delta scaling with the forward fraction f = g**2."""
    f = g * g
    wf = ssa * f
    return tau * (1.0 - wf), ssa * (1.0 - f) / (1.0 - wf), (g - f) / (1.0 - f)


# ------------------------------------------------------------ solvers

def lw_transport(tau, pfrac, b_lay, b_lev, b_sfc, emis):
    """Broadband (flux_up, flux_dn), each (ncol, nlay+1), top first, of the
    no-scattering solve at the diffusivity angle: tau, pfrac (ncol, nlay,
    ngpt); band Planck radiance expanded to g-points at the layers (ncol,
    nlay, ngpt), levels (ncol, nlay+1, ngpt) and surface (ncol, ngpt); a
    level's source takes the Planck fraction of the layer below it, the
    surface level that of the lowest layer; emis (ncol,)."""
    tl = tau * LW_SECANT
    trans = torch.exp(-tl)
    thresh = float(np.sqrt(torch.finfo(tau.dtype).eps))
    big = tl > thresh
    fact = torch.where(big, (1.0 - trans) / torch.where(big, tl, 1.0) - trans,
                       tl * (0.5 - tl / 3.0))
    lay = pfrac * b_lay
    lev_t = pfrac * b_lev[:, :-1]
    lev_b = torch.cat([pfrac[:, 1:] * b_lev[:, 1:-1], pfrac[:, -1:] * b_lev[:, -1:]], dim=1)
    src_dn = (1.0 - trans) * lev_b + 2.0 * fact * (lay - lev_b)
    src_up = (1.0 - trans) * lev_t + 2.0 * fact * (lay - lev_t)
    nlay = tau.shape[1]
    scale = 2.0 * np.pi * LW_WEIGHT
    rad = torch.zeros_like(tau[:, 0])
    dn = [rad.sum(-1)]
    for l in range(nlay):
        rad = trans[:, l] * rad + src_dn[:, l]
        dn.append(rad.sum(-1))
    e = emis[:, None]
    rad = rad * (1.0 - e) + e * pfrac[:, -1] * b_sfc
    up = [rad.sum(-1)]
    for l in range(nlay - 1, -1, -1):
        rad = trans[:, l] * rad + src_up[:, l]
        up.append(rad.sum(-1))
    return torch.stack(up[::-1], dim=1) * scale, torch.stack(dn, dim=1) * scale


def two_stream(tau, ssa, g, mu0):
    """PIFM (Zdunkowski) reflectances and transmittances (rdif, tdif, rdir,
    tdir) in the ecRAD arrangement with the energy clamps; mu0 broadcasts."""
    eps = torch.finfo(tau.dtype).eps
    k_min = 1.0e4 * eps
    g1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    g2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    g3 = (2.0 - 3.0 * mu0 * g) * 0.25
    g4 = 1.0 - g3
    a1 = g1 * g4 + g2 * g3
    a2 = g1 * g3 + g2 * g4
    k = torch.sqrt(torch.clamp_min((g1 - g2) * (g1 + g2), k_min))
    t_dir = torch.exp(-tau / mu0)
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    k2e = 2.0 * k * e1
    rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
    rdif = rt * g2 * (1.0 - e2)
    tdif = rt * k2e
    kmu = k * mu0
    one_m = 1.0 - kmu * kmu
    c = ssa * rt / torch.where(torch.abs(one_m) >= eps, one_m, eps)
    rdir = c * ((1.0 - kmu) * (a2 + k * g3) - (1.0 + kmu) * (a2 - k * g3) * e2
                - k2e * (g3 - a2 * mu0) * t_dir)
    tdir = c * (k2e * (g4 + a1 * mu0)
                - t_dir * ((1.0 + kmu) * (a1 + k * g4) - (1.0 - kmu) * (a1 - k * g4) * e2))
    rdir = torch.minimum(torch.clamp_min(rdir, 0.0), 1.0 - t_dir)
    tdir = torch.minimum(torch.clamp_min(tdir, 0.0), 1.0 - t_dir - rdir)
    return rdif, tdif, rdir, tdir


def sw_solve(tau, ssa, g, mu0, inc_dir, alb):
    """Broadband (flux_up, flux_dn total, flux_dn direct), each (ncol,
    nlay+1), top first: tau, ssa, g (ncol, nlay, ngpt); mu0 (ncol,);
    inc_dir (ncol, ngpt) the direct flux on a horizontal surface at the top;
    alb (ncol,) for the direct and diffuse beams alike; no diffuse flux at
    the top."""
    m = mu0[:, None, None]
    rdif, tdif, rdir, tdir = two_stream(tau, ssa, g, m)
    nlay = tau.shape[1]
    beam = inc_dir[:, None] * torch.exp(-torch.cumsum(tau / m, dim=1))
    dirs = torch.cat([inc_dir[:, None], beam], dim=1)  # (ncol, nlay+1, ngpt)
    s_up, s_dn = rdir * dirs[:, :-1], tdir * dirs[:, :-1]
    a = alb[:, None].expand_as(inc_dir)
    src = dirs[:, -1] * a
    alb_below, src_below = [None] * nlay, [None] * nlay
    for l in range(nlay - 1, -1, -1):
        alb_below[l], src_below[l] = a, src
        d = 1.0 / (1.0 - rdif[:, l] * a)
        a, src = (rdif[:, l] + tdif[:, l] * tdif[:, l] * a * d,
                  s_up[:, l] + tdif[:, l] * d * (src + a * s_dn[:, l]))
    fdn = torch.zeros_like(inc_dir)
    up, dn = [src.sum(-1)], [dirs[:, 0].sum(-1)]
    for l in range(nlay):
        d = 1.0 / (1.0 - rdif[:, l] * alb_below[l])
        fdn = (tdif[:, l] * fdn + rdif[:, l] * src_below[l] + s_dn[:, l]) * d
        up.append((fdn * alb_below[l] + src_below[l]).sum(-1))
        dn.append((fdn + dirs[:, l + 1]).sum(-1))
    return torch.stack(up, dim=1), torch.stack(dn, dim=1), dirs.sum(-1)


# ------------------------------------------------------------ the calls

def lw_fluxes(net: NetOn, table, play, plev, tlay, tlev, tsfc, emis, gases,
              cloud_tau_abs: Optional[torch.Tensor] = None):
    """LW broadband (flux_up, flux_dn) (ncol, nlay+1), top first, from one
    "both" net of 2 x 128 outputs (tau || Planck fraction) on the g-128
    mapping; ``cloud_tau_abs`` (ncol, nlay, nband) the clouds' absorption
    optical depth, or None."""
    band = torch.as_tensor(gpt2band(LW_G128), device=play.device)
    y = net.raw(features(net, play, tlay, gases))
    ngpt = y.shape[-1] // 2
    tau = net.tau(y[..., :ngpt], col_dry(torch.broadcast_to(gases["h2o"], play.shape), plev))
    pfrac = y[..., ngpt:] ** 2
    if cloud_tau_abs is not None:
        tau = tau + cloud_tau_abs[..., band]
    return lw_transport(tau, pfrac, planck_at(table, tlay)[..., band],
                        planck_at(table, tlev)[..., band], planck_at(table, tsfc)[..., band], emis)


def sw_fluxes(net_abs: NetOn, net_ray: NetOn, play, plev, tlay, gases, mu0, inc_dir, alb,
              cloud=None):
    """SW broadband (flux_up, flux_dn total, flux_dn direct) from the
    absorption and Rayleigh nets on the g-112 mapping: gas ssa = tau_ray /
    tau, g = 0; ``cloud`` the delta-scaled (tau, ssa, g) per band (ncol,
    nlay, nband), combined with the gases per g-point, or None."""
    cd = col_dry(torch.broadcast_to(gases["h2o"], play.shape), plev)
    tau_a = net_abs.tau(net_abs.raw(features(net_abs, play, tlay, gases)), cd)
    tau_r = net_ray.tau(net_ray.raw(features(net_ray, play, tlay, gases)), cd)
    tau = tau_a + tau_r
    tiny = torch.finfo(tau.dtype).tiny
    ssa = torch.where(tau > 0, tau_r / torch.clamp_min(tau, tiny), 0.0)
    g = torch.zeros_like(tau)
    if cloud is not None:
        band = torch.as_tensor(gpt2band(SW_G112), device=play.device)
        tc, sc, gc = (c[..., band] for c in cloud)
        scat = tau * ssa + tc * sc
        tau = tau + tc
        g = torch.where(scat > 0, tc * sc * gc / torch.clamp_min(scat, tiny), 0.0)
        ssa = torch.where(tau > 0, scat / torch.clamp_min(tau, tiny), 0.0)
    return sw_solve(tau, ssa, g, mu0, inc_dir, alb)
