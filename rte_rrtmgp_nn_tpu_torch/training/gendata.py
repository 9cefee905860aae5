"""Training-data generation: run the LUT gas optics and the solver over an
RFMIP-style problem and save the NN inputs and targets.

Port of rte_rrtmgp_nn_tpu/training/gendata.py. Reference parity:
``examples/rrtmgp-nn-training/rrtmgp_lw_gendata_rfmipstyle.F90`` /
``rrtmgp_sw_gendata_rfmipstyle.F90`` -- saves the packed NN input features
(``rrtmgp_lw_input``), per-g-point targets (``tau_lw_gas``,
``planck_fraction`` captured via sources%planck_frac), ``col_dry``, level
fluxes (rsu/rsd) and ``pres_level``, in a netCDF read back by the training
loader (ml_load_save_preproc.load_rrtmgp:173-280). The file has the JAX
package's names, dimensions and dtypes, so either package reads the
other's.

Everything runs on the k-distribution's device. On CUDA the LW solve is the
transport kernel (K7, one launch); the lookup-table gas optics and the SW
solve are plain PyTorch there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..drivers.rfmip_io import RFMIPData
from ..gas_concs import GasConcs
from ..gasoptics.kdist import KDist
from ..gasoptics.lut_gas_optics import gas_optics_lw_lut, gas_optics_sw_lut
from ..gasoptics.nn_gas_optics import get_col_dry
from ..rte import rte_lw, rte_sw
from ..utils import ncio


def pack_features(play, tlay, gas_desc: GasConcs, gas_order: Sequence[str]) -> torch.Tensor:
    """The NN input features, UNSCALED (scaling coefficients are chosen at
    training time): tlay, log play, h2o**(1/4), o3**(1/4), then the raw
    VMRs in ``gas_order`` (reference compute_nn_inputs) -> (ncol, nlay,
    nfeat)."""
    ncol, nlay = play.shape
    feats = [tlay, torch.log(play)]
    for g in gas_order:
        v = gas_desc.get_vmr(g, ncol, nlay)
        if g in ("h2o", "o3"):
            v = torch.sqrt(torch.sqrt(v))
        feats.append(v)
    return torch.stack(feats, dim=-1)


def _inputs(kd: KDist, data: RFMIPData):
    """A converter of the problem's arrays to tensors on the
    k-distribution's device in its dtype, and the problem's gases there (in
    their own dtype, which promotes as in the JAX package)."""
    dev, dtype = kd.kmajor.device, kd.kmajor.dtype
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    gases = GasConcs({k: v.to(dev) for k, v in data.gas_concs.concs.items()})
    return t, gases


def _write(out_path, out, kind, nexp, nsite, nlay, nfeat, ngpt, targets, save_input_vectors,
           gas_order, fluxes):
    dims = {"expt": nexp, "site": nsite, "layer": nlay, "level": nlay + 1,
            "feature": nfeat, "gpt": ngpt}
    lev = ("expt", "site", "level")
    variables = {"pres_level": (lev, out["pres_level"].astype(np.float64))}
    for name in fluxes:
        variables[name] = (lev, out[name].astype(np.float32))
    variables[f"rrtmgp_{kind}_input"] = (("expt", "site", "layer", "feature"),
                                        out[f"rrtmgp_{kind}_input"].astype(np.float32))
    variables["col_dry"] = (("expt", "site", "layer"), out["col_dry"].astype(np.float64))
    if save_input_vectors:
        for name in targets:
            variables[name] = (("expt", "site", "layer", "gpt"), out[name].astype(np.float32))
    ncio.write_nc(out_path, dims, variables,
                  attrs={"features": " ".join(["tlay", "play"] + list(gas_order))})


def generate_lw_training_data(
    out_path: str,
    kd: KDist,
    data: RFMIPData,
    gas_order: Optional[Sequence[str]] = None,
    save_input_vectors: bool = True,
) -> dict:
    """Run the LW LUT path with pfrac capture over all columns (on the
    device of ``kd``) and write the training netCDF. Returns the arrays
    as a dict of numpy arrays as well, each (nexp, nsites, ...)."""
    gas_order = list(gas_order or kd.gas_names)
    ncol, nlay = np.shape(data.play)
    t, gases = _inputs(kd, data)
    play, plev, tlay, tlev, tsfc = (t(a) for a in (data.play, data.plev, data.tlay,
                                                   data.tlev, data.tsfc))
    col_dry = get_col_dry(gases.get_vmr("h2o", ncol, nlay), plev)
    props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gases, col_dry=col_dry,
                                       tlev=tlev, top_at_1=data.top_at_1, save_pfrac=True)
    emis = t(data.sfc_emis)[:, None].expand(ncol, kd.nband)
    sol = rte_lw(props, data.top_at_1, sources, emis, broadband=True)
    x = pack_features(play, tlay, gases, gas_order)
    nexp, nsite = data.nexp, data.nsites
    blk = lambda a, *shape: a.detach().cpu().numpy().reshape(nexp, nsite, *shape)
    out = {
        "rrtmgp_lw_input": blk(x, nlay, x.shape[-1]),
        "tau_lw_gas": blk(props.tau, nlay, kd.ngpt),
        "planck_fraction": blk(sources.planck_frac, nlay, kd.ngpt),
        "col_dry": blk(col_dry, nlay),
        "rsu": blk(sol.flux_up, nlay + 1),
        "rsd": blk(sol.flux_dn, nlay + 1),
        "pres_level": blk(plev, nlay + 1),
    }
    _write(out_path, out, "lw", nexp, nsite, nlay, x.shape[-1], kd.ngpt,
           ("tau_lw_gas", "planck_fraction"), save_input_vectors, gas_order, ("rsu", "rsd"))
    return out


def generate_sw_training_data(
    out_path: str,
    kd: KDist,
    data: RFMIPData,
    gas_order: Optional[Sequence[str]] = None,
    save_input_vectors: bool = True,
) -> dict:
    """SW analogue (reference rrtmgp_sw_gendata_rfmipstyle.F90): saves
    tau_sw_gas (total tau) and ssa_sw_gas, from which the training targets
    are tau_abs = tau*(1-ssa) and tau_ray = tau*ssa (the y_rayleigh =
    tau*ssa/N note at :12), plus fluxes rsu/rsd/rsd_dir. mu0 is the cosine
    of the zenith angle held to [0.01, 1]."""
    gas_order = list(gas_order or kd.gas_names)
    ncol, nlay = np.shape(data.play)
    t, gases = _inputs(kd, data)
    play, plev, tlay = (t(a) for a in (data.play, data.plev, data.tlay))
    col_dry = get_col_dry(gases.get_vmr("h2o", ncol, nlay), plev)
    props, src = gas_optics_sw_lut(kd, play, plev, tlay, gases, col_dry=col_dry)
    mu0 = t(np.clip(np.cos(np.deg2rad(data.sza)), 0.01, 1.0))
    alb = t(data.sfc_alb)[:, None].expand(ncol, kd.ngpt)
    sol = rte_sw(props, data.top_at_1, mu0, src.toa_source, alb, alb, broadband=True)
    x = pack_features(play, tlay, gases, gas_order)
    nexp, nsite = data.nexp, data.nsites
    blk = lambda a, *shape: a.detach().cpu().numpy().reshape(nexp, nsite, *shape)
    out = {
        "rrtmgp_sw_input": blk(x, nlay, x.shape[-1]),
        "tau_sw_gas": blk(props.tau, nlay, kd.ngpt),
        "ssa_sw_gas": blk(props.ssa, nlay, kd.ngpt),
        "col_dry": blk(col_dry, nlay),
        "rsu": blk(sol.flux_up, nlay + 1),
        "rsd": blk(sol.flux_dn, nlay + 1),
        "rsd_dir": blk(sol.flux_dn_dir, nlay + 1),
        "pres_level": blk(plev, nlay + 1),
    }
    _write(out_path, out, "sw", nexp, nsite, nlay, x.shape[-1], kd.ngpt,
           ("tau_sw_gas", "ssa_sw_gas"), save_input_vectors, gas_order,
           ("rsu", "rsd", "rsd_dir"))
    return out


def load_training_data(path: str, predictand: str = "lw_absorption"):
    """Read a gendata file back into (x, y, col_dry) training arrays, numpy,
    rows (nexp * nsites * nlay) first (reference load_rrtmgp, all
    predictand modes of ml_train.py:188-195: lw_absorption, lw_planck_frac,
    lw_both, sw_absorption, sw_rayleigh)."""
    with ncio.NCFile(path) as f:
        col_dry = f.read("col_dry", np.float64)
        if predictand == "lw_absorption":
            x = f.read("rrtmgp_lw_input", np.float32)
            y = f.read("tau_lw_gas", np.float32)
        elif predictand == "lw_planck_frac":
            x = f.read("rrtmgp_lw_input", np.float32)
            y = f.read("planck_fraction", np.float32)
        elif predictand == "lw_both":
            x = f.read("rrtmgp_lw_input", np.float32)
            y = np.concatenate(
                [f.read("tau_lw_gas", np.float32), f.read("planck_fraction", np.float32)],
                axis=-1,
            )
        elif predictand in ("sw_absorption", "sw_rayleigh"):
            x = f.read("rrtmgp_sw_input", np.float32)
            tau = f.read("tau_sw_gas", np.float64)
            ssa = f.read("ssa_sw_gas", np.float64)
            y = (tau * (1.0 - ssa) if predictand == "sw_absorption" else tau * ssa).astype(
                np.float32
            )
        else:
            raise ValueError(f"unknown predictand {predictand!r}")
    return (
        x.reshape(-1, x.shape[-1]),
        y.reshape(-1, y.shape[-1]),
        col_dry.reshape(-1),
    )
