"""Visual ML-evaluation diagnostics: error profiles and 2-D histograms.

Port of rte_rrtmgp_nn_tpu/training/diagnostics.py. Reference parity: ``examples/rrtmgp-nn-training/ml_eval_funcs.py`` -- the
plotting helpers used to judge candidate emulator models visually:
heating-rate error profiles (:46-68), three-panel flux/heating-rate error
profiles with MAE/bias/RMSE/R^2 annotations (:84-162), and log-density
2-D histograms of predicted-vs-true optical depth / transmittance /
two-stream outputs (:165-269).

Framework-native differences: fluxes are passed as separate (nsample,
nlev) up/dn arrays instead of the reference's concatenated 122-column
matrix; every plot function returns the matplotlib Figure (callers save
or show); matplotlib import is deferred so the module stays importable in
plot-free environments (training nodes, CI without display, a GPU host
without matplotlib).

Scalar statistics are host-side numpy on purpose: diagnostics run once
per eval on already-materialized outputs; the in-loop metrics live in
``eval_loop`` (on the device) instead. The heating rate has the package's
sign (extensions/heating_rates: +g/cp d(F_dn - F_up)/dp, as the JAX
package's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from ..extensions import heating_rates

__all__ = [
    "heating_rate_stats",
    "plot_heating_rate_error",
    "plot_flux_and_hr_error",
    "plot_hist2d",
    "plot_hist2d_tau",
    "plot_hist2d_transmittance",
    "plot_hist2d_reftrans",
    "save_eval_figures",
]


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for the plotting diagnostics "
            "(rte_rrtmgp_nn_tpu_torch.training.diagnostics); the scalar metrics in "
            "training.eval_loop have no such dependency"
        ) from e


def _hr_kday(flux_up, flux_dn, plev) -> np.ndarray:
    """extensions.heating_rates.compute_heating_rate_kday on arrays, as
    numpy (float64 stays float64)."""
    t = lambda a: torch.as_tensor(np.asarray(a))
    return heating_rates.compute_heating_rate_kday(t(flux_up), t(flux_dn), t(plev)).numpy()


def _rmse(a, b, axis=None):
    return np.sqrt(np.mean((a - b) ** 2, axis=axis))


def _mae(a, b, axis=None):
    return np.mean(np.abs(a - b), axis=axis)


def heating_rate_stats(hr_true: np.ndarray, hr_pred: np.ndarray) -> dict:
    """Scalar heating-rate error statistics (ml_eval_funcs.py:70-82).

    Returns {mae, mae_pct, bias, bias_pct, rmse, r2, text} where text is
    the reference's four annotation lines."""
    t = np.asarray(hr_true).ravel()
    p = np.asarray(hr_pred).ravel()
    mae = _mae(p, t)
    bias = float(np.mean(p - t))
    rmse = _rmse(p, t)
    r2 = float(np.corrcoef(p, t)[0, 1]) ** 2
    mean_t = float(t.mean())
    mae_pct = 100.0 * abs(mae / mean_t) if mean_t else float("inf")
    bias_pct = 100.0 * abs(bias / mean_t) if mean_t else float("inf")
    text = (
        f"MAE : {mae:0.2f} ({mae_pct:0.1f}%)",
        f"Bias: {bias:0.2f} ({bias_pct:0.1f}%)",
        f"RMSE: {rmse:0.2f}",
        f"R$^2$: {r2:0.5f}",
    )
    return {"mae": float(mae), "mae_pct": mae_pct, "bias": bias,
            "bias_pct": bias_pct, "rmse": float(rmse), "r2": r2,
            "text": text}


def _annotate(ax, lines, x=0.45, y0=0.87, dy=0.08, size=10):
    for i, s in enumerate(lines):
        ax.annotate(s, xy=(x, y0 - i * dy), xycoords="axes fraction",
                    size=size)


def plot_heating_rate_error(hr_true, hr_pred, plev, title=None):
    """RMSE-vs-pressure profile of the heating-rate error
    (ml_eval_funcs.py:46-68). hr_*: (nsample, nlay) [K/day]; plev:
    (nsample, nlay+1) [Pa]. Returns the Figure."""
    plt = _plt()
    hr_true = np.asarray(hr_true)
    hr_pred = np.asarray(hr_pred)
    plev = np.asarray(plev)
    play_hpa = 0.01 * 0.5 * (plev[:, 1:] + plev[:, :-1]).mean(axis=0)
    prof = _rmse(hr_true, hr_pred, axis=0)
    fig, ax = plt.subplots(1)
    ax.plot(prof, play_hpa)
    ax.invert_yaxis()
    ax.grid()
    ax.set_ylabel("Pressure (hPa)", fontsize=15)
    ax.set_xlabel("Heating rate (K d$^{-1}$)", fontsize=15)
    _annotate(ax, heating_rate_stats(hr_true, hr_pred)["text"])
    fig.suptitle(title or "Error in heating rate", fontsize=16)
    return fig


def plot_flux_and_hr_error(
    flux_up_true, flux_dn_true, flux_up_pred, flux_dn_pred, plev,
    ax=None, xlabel: bool = True, xmax=None, ind_p: int = 0,
):
    """Three-panel MAE profile: downwelling flux, upwelling flux, heating
    rate, with the reference's TOA/sfc/profile annotations
    (ml_eval_funcs.py:84-162). flux_*: (nsample, nlev) [W/m2] ordered
    TOA->surface; plev: (nsample, nlev) [Pa]. Returns the Figure."""
    plt = _plt()
    up_t = np.asarray(flux_up_true)
    dn_t = np.asarray(flux_dn_true)
    up_p = np.asarray(flux_up_pred)
    dn_p = np.asarray(flux_dn_pred)
    plev = np.asarray(plev)

    toa_t, sfc_up_t, sfc_dn_t = up_t[:, 0], up_t[:, -1], dn_t[:, -1]
    toa_p, sfc_up_p, sfc_dn_p = up_p[:, 0], up_p[:, -1], dn_p[:, -1]

    up_t, dn_t = up_t[:, ind_p:], dn_t[:, ind_p:]
    up_p, dn_p = up_p[:, ind_p:], dn_p[:, ind_p:]
    plev = plev[:, ind_p:]

    hr_t = np.asarray(_hr_kday(up_t, dn_t, plev))
    hr_p = np.asarray(_hr_kday(up_p, dn_p, plev))

    def mae_line(name, t, p):
        m = _mae(t, p)
        pct = 100.0 * abs(m / t.mean()) if t.mean() else float("inf")
        return f"MAE{name}: {m:0.2f} ({pct:0.1f}%)"

    y = 0.01 * plev.mean(axis=0)
    ylay = 0.01 * 0.5 * (plev[:, 1:] + plev[:, :-1]).mean(axis=0)

    fig = None
    if ax is None:
        fig, ax = plt.subplots(ncols=3)
    else:
        fig = getattr(ax[0], "figure", None)
    ax[0].plot(_mae(dn_t, dn_p, axis=0), y)
    ax[1].plot(_mae(up_t, up_p, axis=0), y)
    ax[2].plot(_mae(hr_t, hr_p, axis=0), ylay)
    ax[0].set_ylabel("Pressure (hPa)", fontsize=12)
    if xlabel:
        ax[0].set_xlabel("Downwelling flux (W m$^{-2}$)", fontsize=12)
        ax[1].set_xlabel("Upwelling flux (W m$^{-2}$)", fontsize=12)
        ax[2].set_xlabel("Heating rate (K d$^{-1}$)", fontsize=12)
    for a in ax:
        a.invert_yaxis()
        a.grid()
    if xmax is not None:
        for a, xm in zip(ax, xmax):
            a.set_xlim([0, xm])
    _annotate(ax[0], (mae_line("", dn_t, dn_p),
                      mae_line(", sfc", sfc_dn_t, sfc_dn_p)))
    _annotate(ax[1], (mae_line("", up_t, up_p),
                      mae_line(", sfc", sfc_up_t, sfc_up_p),
                      mae_line(", TOA", toa_t, toa_p)))
    _annotate(ax[2], heating_rate_stats(hr_t, hr_p)["text"])
    return fig


_HIST_LABELS = {
    "transmittance": "Transmittance",
    "normalized_tau": "Normalized optical depth",
    "tau": "Optical depth",
}


def plot_hist2d(y_true, y_pred, nbins: int = 100, kind: Optional[str] = None):
    """Log-density 2-D histogram of predicted vs true values on a square
    identity-line plot, annotated with R^2/MSE/MAE (ml_eval_funcs.py:
    165-204). kind picks the axis label ('transmittance',
    'normalized_tau', 'tau'); None reproduces the reference's value-range
    auto-detection. Returns the Figure."""
    plt = _plt()
    from matplotlib.colors import LogNorm

    x = np.asarray(y_true).ravel()
    y = np.asarray(y_pred).ravel()
    r2 = float(np.corrcoef(x, y)[0, 1]) ** 2

    fig, ax = plt.subplots()
    _, _, _, img = ax.hist2d(x, y, bins=nbins, norm=LogNorm())
    if kind is None:
        if x.max() < 1.1 and x.min() > -0.1:
            kind = "transmittance"
        elif x.min() < 0.0:
            kind = "normalized_tau"
        else:
            kind = "tau"
    label = _HIST_LABELS[kind]
    ax.set_xlabel(label)
    ax.set_ylabel(f"{label} (predicted)")
    lo = min(ax.get_xlim()[0], ax.get_ylim()[0])
    hi = max(ax.get_xlim()[1], ax.get_ylim()[1])
    ax.set_xlim(lo, hi)
    ax.set_ylim(lo, hi)
    fig.colorbar(img, ax=ax)
    mse_err = float(np.mean((x - y) ** 2))
    mae_err = float(np.mean(np.abs(x - y)))
    _annotate(ax, (f"R-squared = {r2:0.5f}", f"MSE = {mse_err:0.5f}",
                   f"MAE = {mae_err:0.5f}"), x=0.05, y0=0.92, dy=0.05)
    ax.grid()
    ax.plot([lo, hi], [lo, hi], "k")
    return fig


def plot_hist2d_tau(y_true, y_pred, nbins: int = 100, tau_max: float = 10.0):
    """Optical-depth histogram restricted to tau < tau_max on both axes
    (ml_eval_funcs.py:259-263)."""
    t = np.asarray(y_true)
    p = np.asarray(y_pred)
    mask = (t < tau_max) & (p < tau_max)
    return plot_hist2d(t[mask], p[mask], nbins, kind="tau")


def plot_hist2d_transmittance(y_true, y_pred, nbins: int = 100):
    """Histogram of exp(-tau) transmittances (ml_eval_funcs.py:265-269)."""
    return plot_hist2d(np.exp(-np.asarray(y_true)),
                       np.exp(-np.asarray(y_pred)), nbins,
                       kind="transmittance")


def plot_hist2d_reftrans(y_true, y_pred, nbins: int = 100):
    """2x2 panel of the four two-stream outputs Rdif/Tdif/Rdir/Tdir
    (ml_eval_funcs.py:207-257). y_*: (nsample, 4). Returns the Figure."""
    plt = _plt()
    from matplotlib.colors import LogNorm

    names = ["Rdif", "Tdif", "Rdir", "Tdir"]
    long_names = ["Diffuse reflectance", "Diffuse transmittance",
                  "Direct reflectance", "Direct transmittance"]
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    fig, axs = plt.subplots(2, 2, figsize=(10, 9))
    for i, ax in enumerate(axs.ravel()):
        x = y_true[:, i].ravel()
        y = y_pred[:, i].ravel()
        r2 = float(np.corrcoef(x, y)[0, 1]) ** 2
        _, _, _, img = ax.hist2d(x, y, bins=nbins, norm=LogNorm())
        ax.set_xlabel(names[i])
        ax.set_ylabel(f"{names[i]} (predicted)")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        fig.colorbar(img, ax=ax)
        bias_err = float(np.mean(y - x))
        mae_err = float(np.mean(np.abs(x - y)))
        _annotate(ax, (f"R-squared = {r2:0.4f}", f"Bias = {bias_err:0.5f}",
                       f"MAE = {mae_err:0.5f}"), x=0.05, y0=0.92, dy=0.06,
                  size=8)
        ax.grid()
        ax.plot([0, 1], [0, 1], "k")
        ax.set_title(long_names[i])
    fig.tight_layout()
    return fig


def save_eval_figures(
    outdir,
    flux_up_true, flux_dn_true, flux_up_pred, flux_dn_pred, plev,
    prefix: str = "eval",
) -> list:
    """Write the reference's per-eval diagnostic figure set (flux + HR
    error profiles, HR error profile) as PNGs under outdir; returns the
    written paths."""
    import os

    plt = _plt()
    os.makedirs(outdir, exist_ok=True)
    paths = []

    fig = plot_flux_and_hr_error(
        flux_up_true, flux_dn_true, flux_up_pred, flux_dn_pred, plev)
    fig.set_size_inches(12, 5)
    fig.tight_layout()
    p = os.path.join(outdir, f"{prefix}_flux_hr_error.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    paths.append(p)

    hr_t = np.asarray(_hr_kday(
        np.asarray(flux_up_true), np.asarray(flux_dn_true), np.asarray(plev)))
    hr_p = np.asarray(_hr_kday(
        np.asarray(flux_up_pred), np.asarray(flux_dn_pred), np.asarray(plev)))
    fig = plot_heating_rate_error(hr_t, hr_p, plev)
    p = os.path.join(outdir, f"{prefix}_hr_error.png")
    fig.savefig(p, dpi=120)
    plt.close(fig)
    paths.append(p)
    return paths
