"""The pieces of the lookup-table training recipes, shared by
scripts/torch_train_from_lut.py (LW), scripts/torch_train_from_lut_sw.py
(SW), the tests and the smoke run.

The JAX package keeps these steps inline in scripts/train_from_lut.py (the
recipe of the shipped ``artifacts/lw-synth64-lut_both_128_128_*.nc``) and
scripts/train_from_lut_sw.py (``artifacts/sw-synth56-lut_*``): the
predictand scalings of the gendata file (step 3), the paired-experiment
batch sampler, and the radiation-in-the-loop eval (step 4). LW: the
candidate "lw_both" net's tau and Planck fraction (on CUDA the MLP kernel,
K3), the Planck sources, and the one-angle broadband transport (on CUDA
the transport kernel, K7). SW: the absorption and Rayleigh nets' tau and
ssa (on CUDA the MLP kernel's SW epilogue, K5), then ``rte_sw``,
day-masked. Both are scored by the 8 metrics against the LUT's own fluxes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..drivers.rfmip_io import RFMIPData
from ..gasoptics.kdist import KDist
from ..gasoptics.nn_gas_optics import predict_nn_lw, predict_nn_sw
from ..gasoptics.planck import compute_planck_source_nn
from ..models.network import NNModel
from ..optical_props import OpticalProps1scl, OpticalProps2str
from ..rte import rte_lw, rte_sw
from ..sources import SourceFuncLW
from .eval_loop import eval_metrics
from .gendata import load_training_data
from .train import TrainState, scale_outputs_tau, standardize_coeffs

GASES = ("h2o", "co2", "o3", "n2o", "ch4")
# the five scored forcing pairs (parallel/shard_ops RF_PAIRS_*) and how often
# a batch's first half draws each: the N2O / CH4 pairs' 0.02 W/m2
# thresholds are the tightest of the 8 metrics
EVAL_PAIRS = np.array([(0, 1), (3, 0), (3, 1), (0, 10), (0, 9)])
EVAL_PAIR_P = (0.15, 0.15, 0.2, 0.25, 0.25)
# the metrics' normalizers: the published RRTMGP-vs-LBL error levels
REF_SCORES = np.array([0.1, 0.1, 0.2, 0.05, 0.05, 0.1, 0.02, 0.02])


@dataclasses.dataclass
class LWTrainingSet:
    """A "lw_both" gendata file as the net trains on it (numpy, rows =
    nexp * nsites * nlay): ``xs`` the min-max scaled features, ``ys`` the
    targets ((tau/col_dry)**(1/8) standardized || sqrt(pfrac)), the
    scalings the model carries, and the file's col_dry."""

    xs: np.ndarray
    ys: np.ndarray
    xmin: np.ndarray
    xmax: np.ndarray
    out_mean: np.ndarray
    out_std: np.ndarray
    col_dry: np.ndarray


def lw_training_set(train_nc: str, ngpt: int) -> LWTrainingSet:
    """Read a LW gendata file back through the training loader and apply
    the reference predictand scalings: tau -> (tau/col_dry)**(1/8) with
    per-g-point mean and global std; the Planck fraction trains on its
    square root with identity standardization (inference squares the raw
    output, nn_gas_optics.predict_nn_lw). The features are min-max scaled."""
    x_un, y_raw, col_dry = load_training_data(train_nc, "lw_both")
    tau_t, pfrac_t = y_raw[:, :ngpt], y_raw[:, ngpt:]
    ysig = scale_outputs_tau(torch.as_tensor(tau_t), torch.as_tensor(col_dry)).numpy()
    ymean, ystd = standardize_coeffs(ysig)
    ys = np.concatenate([(ysig - ymean) / ystd, np.sqrt(np.maximum(pfrac_t, 0.0))], axis=-1)
    xmin, xmax = x_un.min(axis=0), x_un.max(axis=0)
    xs = (x_un - xmin) / np.where(xmax > xmin, xmax - xmin, 1.0)
    return LWTrainingSet(
        xs=xs, ys=ys, xmin=xmin, xmax=xmax,
        out_mean=np.concatenate([ymean, np.zeros(ngpt)]).astype(np.float32),
        out_std=np.concatenate([ystd, np.ones(ngpt)]).astype(np.float32),
        col_dry=col_dry)


def sample_pair_rows(rng: np.random.Generator, nexp: int, nsites: int, nlay: int,
                     npairs: int, eval_pair_p=EVAL_PAIR_P) -> np.ndarray:
    """The rows of one batch of ``npairs`` experiment pairs (2 * npairs
    rows: the first experiments, then their partners; the hybrid loss pairs
    row i with row i + npairs): one site and layer per pair, half the pairs
    from EVAL_PAIRS, half two distinct random experiments. The scored pairs
    are drawn with the shares ``eval_pair_p`` (the draws of
    scripts/train_from_lut.py) or, with None, uniformly (the draws of
    scripts/train_demo.py and train_demo_sw.py). With fewer than 11
    experiments the scored pairs beyond them are left out (their shares
    renormalized), and with none left every pair is random."""
    site = rng.integers(0, nsites, npairs)
    lay = rng.integers(0, nlay, npairs)
    keep = EVAL_PAIRS.max(axis=1) < nexp
    n_eval = npairs // 2 if keep.any() else 0
    if not n_eval:
        ab = np.zeros((0, 2), np.int64)
    elif eval_pair_p is None:
        ab = EVAL_PAIRS[keep][rng.integers(0, int(keep.sum()), n_eval)]
    else:
        p = np.asarray(eval_pair_p)[keep]
        ab = EVAL_PAIRS[keep][rng.choice(int(keep.sum()), n_eval, p=p / p.sum())]
    ra = rng.integers(0, nexp, npairs - n_eval)
    rb = (ra + rng.integers(1, nexp, npairs - n_eval)) % nexp
    ea = np.concatenate([ab[:, 0], ra])
    eb = np.concatenate([ab[:, 1], rb])
    rows_a = (ea * nsites + site) * nlay + lay
    rows_b = (eb * nsites + site) * nlay + lay
    return np.concatenate([rows_a, rows_b])


def pair_index(npairs: int, device) -> torch.Tensor:
    """(npairs, 2) batch rows of the hybrid loss's pairs: (i, i + npairs)."""
    i = torch.arange(npairs, device=device)
    return torch.stack([i, i + npairs], dim=1)


class LWFluxEval:
    """The candidate net's broadband LW fluxes on the training problem:
    ``fluxes(model)`` -> (flux_up, flux_dn), (ncol, nlay+1) on ``device``;
    ``metrics(model)`` the 8 eval metrics against ``ref_up`` / ``ref_dn``
    (the LUT's fluxes). The scaled features and col_dry are those of the
    gendata file (``LWTrainingSet``), the temperatures and emissivity the
    problem's, all moved to ``device`` once."""

    def __init__(self, kd: KDist, data: RFMIPData, ts: LWTrainingSet, ref_up, ref_dn, device,
                 dtype=torch.float32):
        ncol, nlay = np.shape(data.play)
        t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
        self.kd, self.top_at_1, self.nexp = kd, data.top_at_1, data.nexp
        self.tlay, self.tlev, self.tsfc = t(data.tlay), t(data.tlev), t(data.tsfc)
        self.col_dry = t(ts.col_dry.reshape(ncol, nlay))
        self.emis = t(data.sfc_emis)[:, None].expand(ncol, kd.nband).contiguous()
        self.x = t(ts.xs.reshape(ncol, nlay, -1))
        self.ref_up, self.ref_dn = t(ref_up), t(ref_dn)
        self.plev = t(data.plev)

    def fluxes(self, model: NNModel):
        spec = self.kd.spectral
        tau, pfrac = predict_nn_lw([model], self.x, self.col_dry)
        lay, lev, sfc, jac = compute_planck_source_nn(pfrac, self.tlay, self.tlev, self.tsfc,
                                                      spec, self.kd.planck, top_at_1=self.top_at_1)
        sources = SourceFuncLW(lay, lev, sfc, jac, spec)
        sol = rte_lw(OpticalProps1scl(tau, spec), self.top_at_1, sources, self.emis,
                     broadband=True)
        return sol.flux_up, sol.flux_dn

    def metrics(self, model: NNModel) -> np.ndarray:
        up, dn = self.fluxes(model)
        return eval_metrics(up, dn, self.ref_up, self.ref_dn, self.plev, self.nexp,
                            top_at_1=self.top_at_1)


@dataclasses.dataclass
class SWTrainingSet:
    """A SW gendata file as the absorption and Rayleigh nets train on it
    (numpy, rows = nexp * nsites * nlay): ``xs`` the min-max scaled
    features, ``ys_abs`` / ``ys_ray`` the standardized (tau/col_dry)**(1/8)
    of tau_abs = tau (1 - ssa) and tau_ray = tau ssa, each net's scalings,
    and the file's col_dry."""

    xs: np.ndarray
    ys_abs: np.ndarray
    ys_ray: np.ndarray
    xmin: np.ndarray
    xmax: np.ndarray
    out_mean: tuple  # (absorption, Rayleigh)
    out_std: tuple
    col_dry: np.ndarray


def sw_training_set(train_nc: str) -> SWTrainingSet:
    """Read both SW predictands back through the training loader (the
    on-disk round trip between gendata and trainer, ml_train.py:188-195)
    and apply the reference scalings, one set per net: tau ->
    (tau/col_dry)**(1/8), per-g-point mean and global std. The features
    are min-max scaled."""
    x_un, y_abs, col_dry = load_training_data(train_nc, "sw_absorption")
    _, y_ray, _ = load_training_data(train_nc, "sw_rayleigh")
    cd = torch.as_tensor(col_dry)

    def scaled(y):
        ysig = scale_outputs_tau(torch.as_tensor(y), cd).numpy()
        ymean, ystd = standardize_coeffs(ysig)
        return (ysig - ymean) / ystd, ymean.astype(np.float32), ystd.astype(np.float32)

    ys_abs, mean_abs, std_abs = scaled(y_abs)
    ys_ray, mean_ray, std_ray = scaled(y_ray)
    xmin, xmax = x_un.min(axis=0), x_un.max(axis=0)
    xs = (x_un - xmin) / np.where(xmax > xmin, xmax - xmin, 1.0)
    return SWTrainingSet(xs=xs, ys_abs=ys_abs, ys_ray=ys_ray, xmin=xmin, xmax=xmax,
                         out_mean=(mean_abs, mean_ray), out_std=(std_abs, std_ray),
                         col_dry=col_dry)


class PairState:
    """The absorption and Rayleigh nets' TrainStates presented as one to
    the radiation-eval loop: ``model`` is the pair as one module (its
    parameters the absorption net's, then the Rayleigh net's), which the
    loop's EMA and snapshots copy whole."""

    def __init__(self, abs_state: TrainState, ray_state: TrainState):
        self.abs_state, self.ray_state = abs_state, ray_state
        self.model = torch.nn.ModuleList([abs_state.model, ray_state.model])

    @property
    def step(self) -> int:
        return self.abs_state.step


def pair_train_step(step_abs, step_ray, pair_idx):
    """One step of both nets on one batch (x, (y_abs, y_ray)), each with
    its own optimizer: ``(state, x, y) -> (state, loss_abs + loss_ray)``."""

    def train_step(st: PairState, x, y):
        ya, yr = y
        _, la = step_abs(st.abs_state, x, ya, pair_idx)
        _, lr = step_ray(st.ray_state, x, yr, pair_idx)
        return st, la + lr

    return train_step


class SWFluxEval:
    """The candidate (absorption, Rayleigh) pair's broadband SW fluxes on
    the training problem, day-masked: ``fluxes(models)`` -> (flux_up,
    flux_dn), (ncol, nlay+1) on ``device``, night columns (sza >= 90 deg)
    zero; ``metrics(models)`` the 8 metrics against the LUT's fluxes masked
    alike (rrtmgp_rfmip_sw.F90 usecol). The boundary conditions are the
    gendata sweep's (training/gendata.generate_sw_training_data: mu0 held
    to [0.01, 1], the albedo on every g-point, the k-distribution's solar
    source); the scaled features and col_dry are the gendata file's."""

    def __init__(self, kd: KDist, data: RFMIPData, ts: SWTrainingSet, ref_up, ref_dn, device,
                 dtype=torch.float32):
        ncol, nlay = np.shape(data.play)
        t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
        self.kd, self.top_at_1, self.nexp = kd, data.top_at_1, data.nexp
        self.col_dry = t(ts.col_dry.reshape(ncol, nlay))
        self.mu0 = t(np.clip(np.cos(np.deg2rad(data.sza)), 0.01, 1.0))
        self.toa = kd.solar_source().to(device, dtype)[None, :].expand(ncol, kd.ngpt)
        self.alb = t(data.sfc_alb)[:, None].expand(ncol, kd.ngpt).contiguous()
        self.x = t(ts.xs.reshape(ncol, nlay, -1))
        self.usecol = torch.as_tensor(np.asarray(data.sza) < 90.0, device=device)[:, None]
        self.ref_up, self.ref_dn = t(ref_up) * self.usecol, t(ref_dn) * self.usecol
        self.plev = t(data.plev)

    def fluxes(self, models):
        a, r = models
        tau, ssa = predict_nn_sw([a, r], self.x, self.col_dry)
        atmos = OpticalProps2str(tau, ssa, torch.zeros_like(tau), self.kd.spectral)
        sol = rte_sw(atmos, self.top_at_1, self.mu0, self.toa, self.alb, self.alb,
                     broadband=True)
        return sol.flux_up * self.usecol, sol.flux_dn * self.usecol

    def metrics(self, models) -> np.ndarray:
        up, dn = self.fluxes(models)
        return eval_metrics(up, dn, self.ref_up, self.ref_dn, self.plev, self.nexp,
                            top_at_1=self.top_at_1)
