"""A GCM all-sky radiation step: ``drivers.gcm.gcm_sweep_allsky`` of the
port on one card's share of the grid's columns, streamed from host arrays
in blocks, ``precision="f32"``; the per-column diagnostics come back on the
host.

Set-up loads the nets, writes the seed's lookup-table cloud-optics files
under TMPDIR and loads them as a user would, and makes the workload's
input states (``inputs.synthesize_gcm_columns`` on a
``synthesize_rfmip`` atmosphere of ``base_columns`` columns). The output
check holds the diagnostics (OLR, surface LW down, surface SW down) of every
column of every call in the window against the plain reference.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from radbench import counts, inputs
from radbench.reference import physics as P

MU0_MIN = 0.05  # the sweep's day columns take cos(sza) clipped to [0.05, 1]


class Cell:
    # numbers the check compares: each the largest |program - reference|
    # over these outputs, W/m2
    CHECKS = {"olr": ("olr",), "lw_sfc_dn": ("lw_sfc_dn",), "sw_sfc_dn": ("sw_sfc_dn",)}

    def __init__(self, config: dict, workload: dict, seed: int, device, root: str):
        from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked
        from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

        self.device = torch.device(device)
        self.nlay = config["nlay"]
        self.block = workload["block_columns"]
        paths = {k: os.path.join(root, config[k]) for k in ("lw_net", "sw_net")}
        self.nets = {k: P.read_net(p) for k, p in paths.items()}  # the reference's copy
        self.lw = load_model_netcdf(paths["lw_net"], device=self.device)
        self.sw = load_model_netcdf(paths["sw_net"], device=self.device)
        self.luts = {"lw": inputs.synthesize_cloud_lut(P.LW_BAND_LIMS, seed),
                     "sw": inputs.synthesize_cloud_lut(P.SW_BAND_LIMS, seed)}
        with tempfile.TemporaryDirectory() as tmp:
            self.co = {}
            for band, lut in self.luts.items():
                path = os.path.join(tmp, f"cloud-optics-{band}-lut.nc")
                inputs.write_cloud_file(path, lut)
                self.co[band] = load_cloud_optics_checked(path, device=self.device)
        ncol = config["columns"]
        self.hosts = []
        for k in range(workload["states"]):
            s = inputs.state_seed(seed, k)
            base = inputs.synthesize_rfmip(config["base_columns"], self.nlay, s)
            self.hosts.append(inputs.synthesize_gcm_columns(base, ncol, s))
        self.columns_per_call = ncol
        self.n_states = len(self.hosts)

    def call(self, k: int) -> dict:
        """One all-sky LW + SW step on state k, diagnostics on the host."""
        from torch.profiler import record_function

        from rte_rrtmgp_nn_tpu_torch.drivers.gcm import gcm_sweep_allsky

        with record_function("radbench.sweep"):
            r = gcm_sweep_allsky(self.hosts[k], [self.lw], [self.sw, self.sw], self.co["lw"],
                                 self.co["sw"], block_size=self.block, precision="f32",
                                 device=self.device)
        d = r["diagnostics"]
        return {"olr": d[:, 0], "lw_sfc_dn": d[:, 1], "sw_sfc_dn": d[:, 2]}

    def cloud_cells(self, k: int) -> tuple:
        """(liquid, ice, either) cells of state k under the sweep's placement."""
        h = self.hosts[k]
        col = ((np.arange(self.columns_per_call) + 1) % 3 != 0)[:, None]
        m = (h["play"] > P.CLOUD_P[0]) & (h["play"] < P.CLOUD_P[1]) & col
        liq, ice = m & (h["tlay"] > P.CLOUD_T_LIQ), m & (h["tlay"] < P.CLOUD_T_ICE)
        return int(liq.sum()), int(ice.sum()), int((liq | ice).sum())

    def work(self, k: int) -> dict:
        lw, sw, n = self.nets["lw_net"].dims, self.nets["sw_net"].dims, self.columns_per_call
        cl = self.cloud_cells(k)
        return {"lw": counts.lw_work(n, self.nlay, lw, len(P.LW_G128), cl),
                "sw": counts.sw_work(n, self.nlay, sw, sw, len(P.SW_G112), cl)}

    def free_program(self) -> None:
        self.lw = self.sw = self.co = None

    def reference(self, k: int, prec: P.Precision, device, block: int = 8192) -> dict:
        """The plain reference's diagnostics on state k, in ``prec``, on
        ``device`` in blocks of columns."""
        h = self.hosts[k]
        lw, sw = (P.NetOn(self.nets[k], device, prec) for k in ("lw_net", "sw_net"))
        table = P.planck_table(P.LW_BAND_LIMS, prec.dtype, device)
        solar = torch.as_tensor(P.solar_source(), dtype=prec.dtype, device=device)
        radii = {b: (0.5 * (lut["radliq_lwr"] + lut["radliq_upr"]),
                     0.5 * (lut["radice_lwr"] + lut["radice_upr"]))
                 for b, lut in self.luts.items()}
        n = self.columns_per_call
        out = {name: np.zeros(n) for name in self.CHECKS}
        t = lambda x, s: torch.as_tensor(np.asarray(x)[s], dtype=prec.dtype, device=device)
        for s0 in range(0, n, block):
            s = slice(s0, min(n, s0 + block))
            play, plev, tlay, tlev = (t(h[f], s) for f in ("play", "plev", "tlay", "tlev"))
            gases = {}
            for key, v in h.items():
                if key.startswith("gas:"):
                    v = t(v, s)
                    gases[key[4:]] = v if v.ndim == 2 else v[:, None]
            cloud_col = torch.as_tensor((np.arange(n)[s] + 1) % 3 != 0, device=device)
            # LW: the clouds' absorption added to the gases'
            fields = P.cloud_fields(play, tlay, cloud_col, radii["lw"])
            tau, ssa, _ = P.cloud_optics(fields, self.luts["lw"], prec, device)
            up, dn = P.lw_fluxes(lw, table, play, plev, tlay, tlev, t(h["tsfc"], s),
                                 t(h["sfc_emis"], s), gases, cloud_tau_abs=tau * (1.0 - ssa))
            out["olr"][s] = up[:, 0].double().cpu().numpy()
            out["lw_sfc_dn"][s] = dn[:, -1].double().cpu().numpy()
            # SW: delta-scaled clouds; night columns give no flux
            fields = P.cloud_fields(play, tlay, cloud_col, radii["sw"])
            cloud = P.delta_scale(*P.cloud_optics(fields, self.luts["sw"], prec, device))
            sza = t(h["sza"], s)
            mu0 = torch.clamp(torch.cos(sza * (np.pi / 180.0)), MU0_MIN, 1.0)
            _, dn, _ = P.sw_fluxes(sw, sw, play, plev, tlay, gases, mu0,
                                   solar[None, :] * mu0[:, None], t(h["sfc_alb"], s), cloud)
            out["sw_sfc_dn"][s] = torch.where(sza < 90.0, dn[:, -1], 0.0).double().cpu().numpy()
        return out


def setup(config: dict, workload: dict, seed: int, device, root: str) -> Cell:
    return Cell(config, workload, seed, device, root)
