"""NN gas optics: column dry amount, input packing and scaling, and the
plain LW/SW prediction with its postprocessing.

Port of rte_rrtmgp_nn_tpu/gasoptics/nn_gas_optics.py. Reference parity:
  - input packing + min-max scaling: ``compute_nn_inputs``
    (mo_gas_optics_rrtmgp.F90:618-798): log(play), h2o**(1/4), o3**(1/4),
    other gases raw; missing gases get zero or a scenario reference VMR
    (config.nn_scenario_index);
  - postprocessing (mod_network_rrtmgp.F90:125-409):
      tau   = (ystd*y + ymean)**8 * col_dry
      pfrac = y**2                      (single "both" model: raw halves)
      SW:   tau_tot = tau_abs + tau_ray; ssa = tau_ray / tau_tot
  - ``get_col_dry`` (mo_gas_optics_rrtmgp.F90:1662-1707).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import config
from ..constants import constants
from ..gas_concs import GasConcs, get_ref_vmr
from ..models.network import NNModel


def _col_dry(vmr_h2o: torch.Tensor, delta_plev: torch.Tensor) -> torch.Tensor:
    fact = 1.0 / (1.0 + vmr_h2o)
    m_air = (constants.m_dry + constants.m_h2o * vmr_h2o) * fact
    return (
        10.0 * delta_plev * constants.avogad * fact
        / (1000.0 * m_air * 100.0 * constants.grav)
    )


def get_col_dry(vmr_h2o: torch.Tensor, plev: torch.Tensor) -> torch.Tensor:
    """Column dry-air amount [molec/cm2] per layer via hydrostatics:
    vmr_h2o (ncol, nlay), plev (ncol, nlay+1) [Pa] -> (ncol, nlay)."""
    return _col_dry(vmr_h2o, torch.abs(plev[:, :-1] - plev[:, 1:]))


def get_col_dry_lay_major(vmr_h2o_t: torch.Tensor, plev_t: torch.Tensor) -> torch.Tensor:
    """get_col_dry on layer-major inputs: vmr_h2o_t (nlay, ncol), plev_t
    (nlay+1, ncol) -> (nlay, ncol)."""
    return _col_dry(vmr_h2o_t, torch.abs(plev_t[:-1] - plev_t[1:]))


def _missing_gas_vmr(name: str) -> float:
    if config.nn_scenario_index == 0:
        return 0.0
    return get_ref_vmr(config.nn_scenario_index, name)


def compute_nn_inputs(
    play: torch.Tensor,
    tlay: torch.Tensor,
    gas_desc: GasConcs,
    model: NNModel,
) -> torch.Tensor:
    """Pack and scale the NN input features -> (d0, d1, n_inputs) for
    play/tlay of shape (d0, d1) (either orientation; 2-D gases must match
    it)."""
    d0, d1 = play.shape
    feats = []
    for name in model.input_names:
        if name == "tlay":
            v = tlay
        elif name == "play":
            v = torch.log(play)
        elif name in ("h2o", "o3"):
            v = torch.sqrt(torch.sqrt(gas_desc.get_vmr(name, d0, d1)))
        elif name in gas_desc:
            v = gas_desc.get_vmr(name, d0, d1)
        else:
            v = torch.full((d0, d1), _missing_gas_vmr(name), dtype=play.dtype,
                           device=play.device)
        feats.append(v.to(play.dtype))
    x = torch.stack(feats, dim=-1)
    return (x - model.input_min) / (model.input_max - model.input_min)


def compute_nn_inputs_split(
    play: torch.Tensor,
    tlay: torch.Tensor,
    gas_desc: GasConcs,
    model: NNModel,
):
    """compute_nn_inputs factored for the fused kernels, on LAYER-MAJOR
    inputs: play/tlay and every 2-D gas VMR are (nlay, ncol); 1-D VMRs are
    per-layer profiles.

    Features that vary per (layer, column) come out as scaled (nlay, ncol)
    lanes; features of missing gases (zero or scenario reference VMRs) come
    out as one scaled (ncol, nc) constant block. Returns
    (lanes, const_feats, perm) where ``perm`` maps [lane order | const
    order] to positions in the model's input_names: apply it to the rows of
    the first-layer weight (w1[perm]). With no missing gas the const block
    is one zero feature, and the caller pairs it with a zero weight row."""
    nlay, ncol = play.shape

    def vmr(name):
        raw = gas_desc.get_raw(name)
        if raw.ndim == 1:
            return raw[:, None].expand(nlay, ncol)
        if raw.ndim == 0:
            return raw.expand(nlay, ncol)
        return raw

    lanes, idx2d, consts, idxc = [], [], [], []
    for i, name in enumerate(model.input_names):
        if name == "tlay":
            v = tlay
        elif name == "play":
            v = torch.log(play)
        elif name in ("h2o", "o3"):
            v = torch.sqrt(torch.sqrt(vmr(name)))
        elif name in gas_desc:
            v = vmr(name)
        else:
            consts.append(_missing_gas_vmr(name))
            idxc.append(i)
            continue
        lanes.append(v.to(play.dtype))
        idx2d.append(i)

    mn, mx = model.input_min, model.input_max
    lanes = [(v - mn[i]) / (mx[i] - mn[i]) for v, i in zip(lanes, idx2d)]
    if consts:
        ic = torch.as_tensor(idxc, device=play.device)
        cf = torch.tensor(consts, dtype=play.dtype, device=play.device)
        cf = cf[None, :].expand(ncol, len(consts))
        cf = (cf - mn[ic]) / (mx[ic] - mn[ic])
    else:
        cf = torch.zeros((ncol, 1), dtype=play.dtype, device=play.device)
    return lanes, cf.contiguous(), idx2d + idxc


def split_first_layer(model: NNModel, perm: Sequence[int], n2d: int):
    """First-layer weight rows for the lanes (w1a) and for the const block
    (w1c, one zero row when there is no const feature)."""
    w1 = model.weights[0]
    idx = torch.as_tensor(list(perm), device=w1.device)
    w1a = w1[idx[:n2d]]
    if len(perm) > n2d:
        w1c = w1[idx[n2d:]]
    else:
        w1c = torch.zeros((1, w1.shape[1]), dtype=w1.dtype, device=w1.device)
    return w1a.contiguous(), w1c.contiguous()


def predict_tau(model: NNModel, nn_inputs: torch.Tensor, col_dry: torch.Tensor) -> torch.Tensor:
    """Optical depth: (ystd*y + ymean)**8 * col_dry."""
    raw = model.apply_raw(nn_inputs)
    y = model.output_std * raw + model.output_mean
    y2 = y * y
    y4 = y2 * y2
    return (y4 * y4) * col_dry[..., None]


def predict_pfrac(model: NNModel, nn_inputs: torch.Tensor) -> torch.Tensor:
    """Planck fraction: final activation, then square."""
    y = model(nn_inputs)
    return y * y


def predict_nn_lw(models: Sequence[NNModel], nn_inputs: torch.Tensor,
                  col_dry: torch.Tensor):
    """LW prediction -> (tau, pfrac), each (..., ngpt): two-model mode
    (absorption + planck_frac nets) or one "lw_both" model predicting
    2*ngpt outputs split into tau || pfrac."""
    if len(models) == 2:
        return predict_tau(models[0], nn_inputs, col_dry), predict_pfrac(models[1], nn_inputs)
    (model,) = models
    raw = model.apply_raw(nn_inputs)
    ngpt = model.n_outputs // 2
    y = model.output_std[:ngpt] * raw[..., :ngpt] + model.output_mean[:ngpt]
    y2 = y * y
    y4 = y2 * y2
    tau = (y4 * y4) * col_dry[..., None]
    pfrac = raw[..., ngpt:] * raw[..., ngpt:]
    return tau, pfrac


def predict_nn_sw(models: Sequence[NNModel], nn_inputs: torch.Tensor,
                  col_dry: torch.Tensor):
    """SW prediction -> (tau_tot, ssa) from the absorption and Rayleigh
    nets; ssa is 0 where tau_tot is 0."""
    tau_abs = predict_tau(models[0], nn_inputs, col_dry)
    tau_ray = predict_tau(models[1], nn_inputs, col_dry)
    tau_tot = tau_abs + tau_ray
    pos = tau_tot > 0
    ssa = torch.where(pos, tau_ray / torch.where(pos, tau_tot, 1.0), 0.0)
    return tau_tot, ssa
