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
  - ``get_col_dry`` (mo_gas_optics_rrtmgp.F90:1662-1707);
  - the LW and SW entry points ``gas_optics_lw_nn`` / ``gas_optics_sw_nn``
    (gas_optics_int / gas_optics_ext NN branches, :371-408, :529-599).

The prediction runs through the MLP kernel on CUDA tensors
(ops/cuda/mlp.py: K3 for a "lw_both" net, K4 for the tau net of two-model
LW, K5 for SW) and through the kernels' plain twins on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import config
from ..constants import constants
from ..gas_concs import GasConcs, get_ref_vmr
from ..models.network import NNModel
from ..ops.cuda import mlp
from ..sources import SourceFuncLW
from ..spectral import SpectralMapping
from ..utils.timing import span
from .planck import PlanckTable, compute_planck_source_nn


def _col_dry(vmr_h2o: torch.Tensor, delta_plev: torch.Tensor, g0=None) -> torch.Tensor:
    fact = 1.0 / (1.0 + vmr_h2o)
    m_air = (constants.m_dry + constants.m_h2o * vmr_h2o) * fact
    return (
        10.0 * delta_plev * constants.avogad * fact
        / (1000.0 * m_air * 100.0 * (constants.grav if g0 is None else g0))
    )


def get_col_dry(vmr_h2o: torch.Tensor, plev: torch.Tensor,
                latitude: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column dry-air amount [molec/cm2] per layer via hydrostatics:
    vmr_h2o (ncol, nlay), plev (ncol, nlay+1) [Pa] -> (ncol, nlay). With
    ``latitude`` (ncol,) [deg] gravity follows Helmert's formula."""
    g0 = None
    if latitude is not None:
        g0 = (constants.helmert1 - constants.helmert2
              * torch.cos(2.0 * torch.pi * latitude / 180.0))[:, None]
    return _col_dry(vmr_h2o, torch.abs(plev[:, :-1] - plev[:, 1:]), g0)


def get_col_dry_lay_major(vmr_h2o_t: torch.Tensor, plev_t: torch.Tensor) -> torch.Tensor:
    """get_col_dry on layer-major inputs: vmr_h2o_t (nlay, ncol), plev_t
    (nlay+1, ncol) -> (nlay, ncol)."""
    return _col_dry(vmr_h2o_t, torch.abs(plev_t[:-1] - plev_t[1:]))


def interp_tlev(tlay: torch.Tensor, play: torch.Tensor, plev: torch.Tensor) -> torch.Tensor:
    """Level temperatures (ncol, nlay+1) from layer ones: pressure-weighted
    interpolation inside, linear extrapolation at both ends (reference
    mo_gas_optics_rrtmgp.F90:326-335)."""
    t_top = tlay[:, 0] + (plev[:, 0] - play[:, 0]) * (tlay[:, 1] - tlay[:, 0]) / (
        play[:, 1] - play[:, 0])
    interior = (
        play[:, :-1] * tlay[:, :-1] * (plev[:, 1:-1] - play[:, 1:])
        + play[:, 1:] * tlay[:, 1:] * (play[:, :-1] - plev[:, 1:-1])
    ) / (plev[:, 1:-1] * (play[:, :-1] - play[:, 1:]))
    t_bot = tlay[:, -1] + (plev[:, -1] - play[:, -1]) * (tlay[:, -1] - tlay[:, -2]) / (
        play[:, -1] - play[:, -2])
    return torch.cat([t_top[:, None], interior, t_bot[:, None]], dim=1)


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
    raw_lanes: bool = False,
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
    is one zero feature, and the caller pairs it with a zero weight row.

    ``raw_lanes=True`` (the fused LW kernel's raw-lane mode): the lanes stay
    RAW, before the transform, and two more values come back: the per-lane
    transform codes (0 identity, 1 log, 2 fourth root) and ``scale_rows``
    (2, n2d) = [input_min; 1 / (input_max - input_min)] of the lanes. The
    kernel computes (transform(x) - min) * inv, at most 1 ulp from the
    division here."""
    nlay, ncol = play.shape

    def vmr(name):
        raw = gas_desc.get_raw(name)
        if raw.ndim == 1:
            return raw[:, None].expand(nlay, ncol)
        if raw.ndim == 0:
            return raw.expand(nlay, ncol)
        return raw

    lanes, codes, idx2d, consts, idxc = [], [], [], [], []
    for i, name in enumerate(model.input_names):
        if name == "tlay":
            v, code = tlay, 0
        elif name == "play":
            v, code = play, 1
        elif name in ("h2o", "o3"):
            v, code = vmr(name), 2
        elif name in gas_desc:
            v, code = vmr(name), 0
        else:
            consts.append(_missing_gas_vmr(name))
            idxc.append(i)
            continue
        lanes.append(v.to(play.dtype))
        codes.append(code)
        idx2d.append(i)

    mn, mx = model.input_min, model.input_max
    if not raw_lanes:
        transform = (lambda v: v, torch.log, lambda v: torch.sqrt(torch.sqrt(v)))
        lanes = [(transform[c](v) - mn[i]) / (mx[i] - mn[i])
                 for v, c, i in zip(lanes, codes, idx2d)]
    if consts:
        ic = torch.as_tensor(idxc, device=play.device)
        cf = torch.tensor(consts, dtype=play.dtype, device=play.device)
        cf = cf[None, :].expand(ncol, len(consts))
        cf = (cf - mn[ic]) / (mx[ic] - mn[ic])
    else:
        cf = torch.zeros((ncol, 1), dtype=play.dtype, device=play.device)
    if raw_lanes:
        ii = torch.as_tensor(idx2d, dtype=torch.long, device=play.device)
        scale_rows = torch.stack([mn[ii], 1.0 / (mx[ii] - mn[ii])], dim=0)
        return lanes, cf.contiguous(), idx2d + idxc, tuple(codes), scale_rows
    return lanes, cf.contiguous(), idx2d + idxc


def split_first_layer(model: NNModel, perm: Sequence[int], n2d: int):
    """First-layer weight rows for the lanes (w1a) and for the const block
    (w1c, one zero row when there is no const feature), made at the first
    call for a (perm, n2d) and kept with the model: a fused-kernel call then
    copies no index from the host, which would make it wait for the card to
    drain, and gathers nothing.

    The kept splits are copies, so they follow the weight they were cut
    from: when ``model.weights[0]`` is another tensor (its data pointer) or
    was changed in place (its version counter: an optimizer step,
    ``load_state_dict``, an EMA update, any in-place op) every kept split is
    dropped and cut again. The alias kept in ``first_layer_source`` holds the
    old tensor's memory, so a new tensor cannot take its address. A change
    through ``weights[0].data``, which bypasses the version counter, is not
    seen: change the parameter itself. NNModel drops the splits when its
    tensors move (to(), double(), copies). With grad enabled and a weight
    that requires grad the split is cut anew and not kept."""
    w1 = model.weights[0]
    if torch.is_grad_enabled() and w1.requires_grad:
        # a split for autograd (the plain twins on the CPU): cut at every
        # call, so that each backward reaches the weight; never kept
        return _cut_first_layer(w1, perm, n2d)
    src = model.first_layer_source
    if src is None or src[0].data_ptr() != w1.data_ptr() or src[1] != w1._version:
        model.first_layer_splits.clear()
        model.first_layer_source = (w1.detach(), w1._version)
    key = (tuple(perm), n2d)
    split = model.first_layer_splits.get(key)
    if split is None:
        with span("rte.first_layer.miss"):
            split = model.first_layer_splits[key] = _cut_first_layer(w1, key[0], n2d)
    return split


def _cut_first_layer(w1: torch.Tensor, perm: Sequence[int], n2d: int):
    idx = torch.as_tensor(tuple(perm), dtype=torch.long, device=w1.device)
    w1a = w1[idx[:n2d]]
    if len(perm) > n2d:
        w1c = w1[idx[n2d:]]
    else:
        w1c = torch.zeros((1, w1.shape[1]), dtype=w1.dtype, device=w1.device)
    return w1a.contiguous(), w1c.contiguous()


def predict_tau(model: NNModel, nn_inputs: torch.Tensor, col_dry: torch.Tensor) -> torch.Tensor:
    """Optical depth: (ystd*y + ymean)**8 * col_dry (K4 on CUDA tensors)."""
    return mlp.fused_predict_tau(model, nn_inputs.contiguous(), col_dry.contiguous())


def predict_pfrac(model: NNModel, nn_inputs: torch.Tensor) -> torch.Tensor:
    """Planck fraction: final activation, then square."""
    y = model(nn_inputs)
    return y * y


def predict_nn_lw(models: Sequence[NNModel], nn_inputs: torch.Tensor, col_dry: torch.Tensor):
    """LW prediction -> (tau, pfrac), each (..., ngpt): two-model mode
    (absorption + planck_frac nets) or one "lw_both" model predicting
    2*ngpt outputs split into tau || pfrac. The tau net is the MLP kernel
    on CUDA tensors (K4, or K3 for a "lw_both" net); the second net of
    two-model LW (pfrac, with its final activation) is plain, as in the
    JAX package."""
    if len(models) == 2:
        return predict_tau(models[0], nn_inputs, col_dry), predict_pfrac(models[1], nn_inputs)
    (model,) = models
    # the kernel reads contiguous rows
    return mlp.fused_predict_lw_both(model, nn_inputs.contiguous(), col_dry.contiguous())


def predict_nn_sw(models: Sequence[NNModel], nn_inputs: torch.Tensor,
                  col_dry: torch.Tensor, with_rayleigh: bool = True):
    """SW prediction -> (tau_tot, ssa) from the absorption and Rayleigh
    nets (ssa 0 where tau_tot is 0), or (tau_abs, None) without Rayleigh.
    The MLP kernel on CUDA tensors (K5, or K4 without Rayleigh)."""
    if not with_rayleigh:
        return predict_tau(models[0], nn_inputs, col_dry), None
    return mlp.fused_predict_sw(models[0], models[1], nn_inputs.contiguous(),
                                col_dry.contiguous())


def gas_optics_lw_nn(
    models: Sequence[NNModel],
    play: torch.Tensor,
    plev: torch.Tensor,
    tlay: torch.Tensor,
    tsfc: torch.Tensor,
    gas_desc: GasConcs,
    spectral: SpectralMapping,
    planck_table: PlanckTable,
    col_dry: Optional[torch.Tensor] = None,
    tlev: Optional[torch.Tensor] = None,
    top_at_1: bool = True,
    save_pfrac: bool = False,
):
    """LW NN gas optics, column-major: play/tlay (ncol, nlay), plev/tlev
    (ncol, nlay+1), tsfc (ncol,). Returns (tau (ncol, nlay, ngpt),
    SourceFuncLW). tlev defaults to ``interp_tlev``, col_dry to
    ``get_col_dry``."""
    ncol, nlay = play.shape
    if tlev is None:
        tlev = interp_tlev(tlay, play, plev)
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)
    nn_inputs = compute_nn_inputs(play, tlay, gas_desc, models[0])
    tau, pfrac = predict_nn_lw(models, nn_inputs, col_dry)
    lay_src, lev_src, sfc_src, sfc_jac = compute_planck_source_nn(
        pfrac, tlay, tlev, tsfc, spectral, planck_table, top_at_1=top_at_1)
    return tau, SourceFuncLW(lay_source=lay_src, lev_source=lev_src, sfc_source=sfc_src,
                             sfc_source_jac=sfc_jac, spectral=spectral,
                             planck_frac=pfrac if save_pfrac else None)


def gas_optics_sw_nn(
    models: Sequence[NNModel],
    play: torch.Tensor,
    plev: torch.Tensor,
    tlay: torch.Tensor,
    gas_desc: GasConcs,
    spectral: SpectralMapping,
    solar_source: torch.Tensor,
    col_dry: Optional[torch.Tensor] = None,
    with_rayleigh: bool = True,
):
    """SW NN gas optics, column-major. Returns (tau, ssa or None, toa_src)
    with toa_src the per-g-point solar source (ngpt,) broadcast to (ncol,
    ngpt)."""
    ncol, nlay = play.shape
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)
    nn_inputs = compute_nn_inputs(play, tlay, gas_desc, models[0])
    tau, ssa = predict_nn_sw(models, nn_inputs, col_dry, with_rayleigh)
    return tau, ssa, solar_source[None, :].expand(ncol, spectral.ngpt)
