"""The RFMIP clear-sky driver calls: ``rfmip_clear_sky_lw`` then
``rfmip_clear_sky_sw`` of the port on host arrays, as
``scripts/torch_run_rfmip.py`` calls them, with the fluxes back on the
host.

Set-up loads the nets and makes the workload's input states from the seed
(``inputs.synthesize_rfmip_experiments``: ``experiments`` x ``sites``
columns each); everything else the drivers do per call stays in the call.
The output check holds the LW and SW flux profiles (up and down, every
level of every column) of every call in the window against the plain
reference (``reference.physics``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from radbench import counts, inputs
from radbench.reference import physics as P

class Cell:
    # numbers the check compares: each the largest |program - reference|
    # over these outputs, W/m2
    CHECKS = {"lw_flux": ("lw_up", "lw_dn"), "sw_flux": ("sw_up", "sw_dn")}

    def __init__(self, config: dict, workload: dict, seed: int, device, root: str):
        from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
        from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

        self.device = torch.device(device)
        self.nlay = config["nlay"]
        paths = {k: os.path.join(root, config[k]) for k in ("lw_net", "sw_net")}
        self.nets = {k: P.read_net(p) for k, p in paths.items()}  # the reference's copy
        self.lw = load_model_netcdf(paths["lw_net"], device=self.device)
        self.sw = load_model_netcdf(paths["sw_net"], device=self.device)
        nexp, nsites = workload["experiments"], workload["sites"]
        self.arrays = [inputs.synthesize_rfmip_experiments(
            nexp, nsites, self.nlay, inputs.state_seed(seed, k))
            for k in range(workload["states"])]
        self.data = [rfmip_data_from_arrays(a) for a in self.arrays]
        self.columns_per_call = nexp * nsites
        self.n_states = len(self.arrays)

    def call(self, k: int) -> dict:
        """One LW + SW radiation call on state k, fluxes on the host."""
        from torch.profiler import record_function

        from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw

        data = self.data[k]
        with record_function("radbench.lw"):
            lw = rfmip_clear_sky_lw(data, [self.lw], device=self.device)
        with record_function("radbench.sw"):
            sw = rfmip_clear_sky_sw(data, [self.sw, self.sw], device=self.device)
        with record_function("radbench.fetch"):
            return {"lw_up": lw.flux_up.cpu().numpy(), "lw_dn": lw.flux_dn.cpu().numpy(),
                    "sw_up": sw.flux_up.cpu().numpy(), "sw_dn": sw.flux_dn.cpu().numpy()}

    def work(self, k: int) -> dict:
        """(operations, bytes) of one call on state k, by part."""
        lw, sw, n = self.nets["lw_net"].dims, self.nets["sw_net"].dims, self.columns_per_call
        return {"lw": counts.lw_work(n, self.nlay, lw, len(P.LW_G128)),
                "sw": counts.sw_work(n, self.nlay, sw, sw, len(P.SW_G112))}

    def free_program(self) -> None:
        self.lw = self.sw = self.data = None

    def reference(self, k: int, prec: P.Precision, device, block: int = 8192) -> dict:
        """The plain reference's outputs on state k, in ``prec``, computed
        on ``device`` in blocks of columns."""
        a = self.arrays[k]
        lw, sw = (P.NetOn(self.nets[k], device, prec) for k in ("lw_net", "sw_net"))
        table = P.planck_table(P.LW_BAND_LIMS, prec.dtype, device)
        solar = torch.as_tensor(P.solar_source(), dtype=prec.dtype, device=device)
        n = self.columns_per_call
        out = {name: np.zeros((n, self.nlay + 1)) for c in self.CHECKS.values() for name in c}
        t = lambda x, s: torch.as_tensor(np.asarray(x)[s], dtype=prec.dtype, device=device)
        for s0 in range(0, n, block):
            s = slice(s0, min(n, s0 + block))
            play, plev, tlay, tlev = (t(a[f], s) for f in ("play", "plev", "tlay", "tlev"))
            gases = {}
            for g, v in a["gases"].items():
                v = np.asarray(v)
                gases[g] = t(v, s) if v.ndim == 2 else torch.as_tensor(
                    v, dtype=prec.dtype, device=device)
            up, dn = P.lw_fluxes(lw, table, play, plev, tlay, tlev, t(a["tsfc"], s),
                                 t(a["sfc_emis"], s), gases)
            out["lw_up"][s], out["lw_dn"][s] = up.double().cpu().numpy(), dn.double().cpu().numpy()
            sza = t(a["sza"], s)
            day = sza < 90.0
            mu0 = torch.where(day, torch.cos(sza * (np.pi / 180.0)), 1.0)
            toa = solar[None, :] * (t(a["tsi"], s) / solar.sum())[:, None]
            up, dn, _ = P.sw_fluxes(sw, sw, play, plev, tlay, gases, mu0, toa * mu0[:, None],
                                    t(a["sfc_alb"], s))
            night = ~day[:, None]
            out["sw_up"][s] = up.masked_fill(night, 0.0).double().cpu().numpy()
            out["sw_dn"][s] = dn.masked_fill(night, 0.0).double().cpu().numpy()
        return out


def setup(config: dict, workload: dict, seed: int, device, root: str) -> Cell:
    return Cell(config, workload, seed, device, root)
