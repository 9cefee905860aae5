"""The RFMIP clear-sky driver calls on RRTMGP's lookup-table gas optics:
``rfmip_clear_sky_lw`` then ``rfmip_clear_sky_sw`` of the port, each handed
a k-distribution in place of the nets, as the upstream
``rrtmgp_rfmip_lw.F90`` runs without its NN files, on host arrays, with the
fluxes back on the host.

Set-up writes the seed's synthetic LW and SW k-distribution files
(``gasoptics.synthetic.generate_kdist_nc`` at the configuration's g-points
a band and gases) under TMPDIR, loads them as a user would, and makes the
workload's input states (``inputs.synthesize_rfmip_experiments``: the same
atmospheres as ``rfmip-clearsky`` from the same seed). The entry calls no
gas-optics function itself. The output check holds the LW and SW flux
profiles (up and down, every level of every column) of every call in the
window against the plain reference (``reference.lut``, which reads the
files itself).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from radbench import counts_lut, inputs
from radbench.reference import lut as L
from radbench.reference import physics as P

BANDS = ("lw", "sw")


class Cell:
    # numbers the check compares: each the largest |program - reference|
    # over these outputs, W/m2
    CHECKS = {"lw_flux": ("lw_up", "lw_dn"), "sw_flux": ("sw_up", "sw_dn")}

    def __init__(self, config: dict, workload: dict, seed: int, device, root: str):
        from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import lut_kdist
        from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
        from rte_rrtmgp_nn_tpu_torch.gasoptics.kdist import load_kdist
        from rte_rrtmgp_nn_tpu_torch.gasoptics.synthetic import generate_kdist_nc

        self.device = torch.device(device)
        self.nlay = config["nlay"]
        gases = tuple(config["gases"])
        self.files, self.kd = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for i, band in enumerate(BANDS):
                path = os.path.join(tmp, f"kdist-{band}.nc")
                # the k-distributions from the seed, apart from the input states
                generate_kdist_nc(path, kind=band, gases=gases,
                                  gpts_per_band=config["gpts_per_band"],
                                  seed=inputs.state_seed(seed, 1000 + i))
                self.files[band] = L.read_kdist(path)  # the reference's copy
                self.kd[band] = load_kdist(path, gases, torch.float32, device=self.device)
        nexp, nsites = workload["experiments"], workload["sites"]
        self.arrays = [inputs.synthesize_rfmip_experiments(
            nexp, nsites, self.nlay, inputs.state_seed(seed, k))
            for k in range(workload["states"])]
        self.data = [rfmip_data_from_arrays(a) for a in self.arrays]
        # the drivers' own check that they take these k-distributions on
        # these data: a program without the lookup-table route fails at set-up
        for band in BANDS:
            lut_kdist("radbench", band, self.kd[band], self.data[0], self.device, torch.float32)
        self.columns_per_call = nexp * nsites
        self.n_states = len(self.arrays)

    def call(self, k: int) -> dict:
        """One LW + SW radiation call on state k, fluxes on the host."""
        from torch.profiler import record_function

        from rte_rrtmgp_nn_tpu_torch.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw

        data = self.data[k]
        with record_function("radbench.lw"):
            lw = rfmip_clear_sky_lw(data, self.kd["lw"], device=self.device)
        with record_function("radbench.sw"):
            sw = rfmip_clear_sky_sw(data, self.kd["sw"], device=self.device)
        with record_function("radbench.fetch"):
            return {"lw_up": lw.flux_up.cpu().numpy(), "lw_dn": lw.flux_dn.cpu().numpy(),
                    "sw_up": sw.flux_up.cpu().numpy(), "sw_dn": sw.flux_dn.cpu().numpy()}

    def work(self, k: int) -> dict:
        """(operations, bytes) of one call on state k, by part: the gas
        optics (``lut_lw``, ``lut_sw``) and the transports."""
        n, nlay = self.columns_per_call, self.nlay
        lw, sw = self.files["lw"], self.files["sw"]
        play = self.arrays[k]["play"]
        return {"lut_lw": counts_lut.lw_gas_work(lw, n, nlay, counts_lut.upper_rows(lw, play)),
                "lut_sw": counts_lut.sw_gas_work(sw, n, nlay, counts_lut.upper_rows(sw, play)),
                "lut_lw_rte": counts_lut.lw_rte_work(lw.ngpt, len(lw.band_gpts), n, nlay),
                "lut_sw_rte": counts_lut.sw_rte_work(sw.ngpt, n, nlay)}

    def free_program(self) -> None:
        self.kd = self.data = None

    def reference(self, k: int, prec: P.Precision, device, block: int = 600) -> dict:
        """The plain reference's outputs on state k, in ``prec``, computed
        on ``device`` in blocks of columns; the troposphere decided in
        float32, the program's precision."""
        a = self.arrays[k]
        kd = {b: L.KDistOn(self.files[b], device, prec) for b in BANDS}
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
            up, dn = L.lw_fluxes(kd["lw"], play, plev, tlay, tlev, t(a["tsfc"], s),
                                 t(a["sfc_emis"], s), gases, torch.float32)
            out["lw_up"][s], out["lw_dn"][s] = up.double().cpu().numpy(), dn.double().cpu().numpy()
            sza = t(a["sza"], s)
            day = sza < 90.0
            mu0 = torch.where(day, torch.cos(sza * (np.pi / 180.0)), 1.0)
            up, dn, _ = L.sw_fluxes(kd["sw"], play, plev, tlay, gases, mu0, t(a["tsi"], s),
                                    t(a["sfc_alb"], s), torch.float32)
            night = ~day[:, None]
            out["sw_up"][s] = up.masked_fill(night, 0.0).double().cpu().numpy()
            out["sw_dn"][s] = dn.masked_fill(night, 0.0).double().cpu().numpy()
        return out


def setup(config: dict, workload: dict, seed: int, device, root: str) -> Cell:
    return Cell(config, workload, seed, device, root)
