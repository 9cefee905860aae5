"""A GCM host's radiation step on its ranks at once: ``ranks`` ranks of the
port's ``parallel.distributed.RankGroup`` on one host, one a card, each
running ``drivers.gcm.gcm_sweep_allsky`` of the port (``precision="f32"``,
``mesh=None``) on its own columns, the step ended at the group's host-side
barrier once every rank's diagnostics are in host memory.

This process is rank 0, so the profiled window sees one whole rank and its
card. Each rank's set-up is that of ``entries/gcm.py`` (nets, the seed's
lookup-table cloud optics, the input states), with rank r's state k from
its own seed (``inputs.state_seed`` of ``r * states + k``; rank 0's states
are those of the one-card cell on the same seed). A call returns every
rank's diagnostics in rank order, and the output check holds every column
of every rank against the plain reference, each rank's part computed on
its own card after the group has closed.

The harness's device report names its own process's card alone; while
the group lives, this entry has it count the cards of every rank
(``counting_cards``), since the run uses one card a rank.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from radbench import harness, inputs
from radbench.entries import gcm
from radbench.reference import physics as P


class Share(gcm.Cell):
    """One rank's share: its input states and the reference's copies of
    the nets and cloud tables; ``load`` puts the program (nets, cloud
    optics) on the rank's device. ``entries/gcm.py``'s call, work and
    reference then run on it."""

    def __init__(self, config: dict, workload: dict, seed: int, rank: int, root: str):
        self.nlay = config["nlay"]
        self.block = workload["block_columns"]
        self.paths = {k: os.path.join(root, config[k]) for k in ("lw_net", "sw_net")}
        self.nets = {k: P.read_net(p) for k, p in self.paths.items()}
        self.luts = {"lw": inputs.synthesize_cloud_lut(P.LW_BAND_LIMS, seed),
                     "sw": inputs.synthesize_cloud_lut(P.SW_BAND_LIMS, seed)}
        n_states = workload["states"]
        self.hosts = []
        for k in range(n_states):
            s = inputs.state_seed(seed, rank * n_states + k)
            base = inputs.synthesize_rfmip(config["base_columns"], self.nlay, s)
            self.hosts.append(inputs.synthesize_gcm_columns(base, config["columns"], s))
        self.columns_per_call = config["columns"]
        self.n_states = n_states
        self.rank = rank

    def load(self, device) -> "Share":
        from rte_rrtmgp_nn_tpu_torch.drivers.allsky import load_cloud_optics_checked
        from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

        self.device = torch.device(device)
        self.lw = load_model_netcdf(self.paths["lw_net"], device=self.device)
        self.sw = load_model_netcdf(self.paths["sw_net"], device=self.device)
        with tempfile.TemporaryDirectory() as tmp:
            self.co = {}
            for band, lut in self.luts.items():
                path = os.path.join(tmp, f"cloud-optics-{band}-lut.nc")
                inputs.write_cloud_file(path, lut)
                self.co[band] = load_cloud_optics_checked(path, device=self.device)
        return self


def make_rank(rank: int, device, config: dict, workload: dict, seed: int, root: str) -> Share:
    """A rank's set-up, once: its share with the program on its card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Share(config, workload, seed, rank, root).load(device)


def rank_step(share: Share, k: int) -> np.ndarray:
    """A rank's part of a step: its sweep on state k, (columns, 3) OLR,
    surface LW down, surface SW down."""
    with torch.no_grad():
        d = share.call(k)
    return np.stack([d["olr"], d["lw_sfc_dn"], d["sw_sfc_dn"]], axis=1)


def counting_cards(device_kind, devices):
    """``device_kind`` with ``count`` the number of distinct cards among
    ``devices`` where it reports a card: the run's cards, one a rank."""
    cards = len({d for d in devices if d.type == "cuda"})

    def report(device) -> dict:
        d = device_kind(device)
        if d["platform"] == "gpu":
            d["count"] = cards
        return d

    return report


def _summary(stats: dict) -> dict:
    """The group's counters over every step, warm-up included: each rank's
    step ms (median, p95, max), how often each rank was the slowest, the
    skew's median, p95 and max, each card's peak bytes allocated."""
    ms = np.asarray(stats["step_ms"], np.float64).reshape(-1, len(stats["peak_bytes"]))
    skew = np.asarray(stats["skew_ms"], np.float64)
    q = lambda a: ([float(np.median(a)), float(np.percentile(a, 95)), float(np.max(a))]
                   if len(a) else [])
    return {"steps": len(ms), "step_ms_median_p95_max": [q(ms[:, r]) for r in range(ms.shape[1])],
            "slowest_rank_count": np.bincount(stats["slowest_rank"],
                                              minlength=ms.shape[1]).tolist(),
            "skew_ms_median_p95_max": q(skew), "peak_bytes": stats["peak_bytes"]}


class Cell:
    CHECKS = gcm.Cell.CHECKS

    def __init__(self, config: dict, workload: dict, seed: int, device, root: str):
        # the program's rank group first: without it the run ends here,
        # having started nothing
        from rte_rrtmgp_nn_tpu_torch.parallel.distributed import RankGroup

        self.config, self.workload, self.seed, self.root = config, workload, seed, root
        self.device = torch.device(device)
        self.ranks = config["ranks"]
        make = partial(make_rank, config=config, workload=workload, seed=seed, root=root)
        self.group = RankGroup(make, rank_step, self.ranks, (config["columns"], 3),
                               device=None if self.device.type == "cuda" else "cpu")
        self.shares = {0: self.group.state}
        self.columns_per_call = self.ranks * config["columns"]
        self.n_states = workload["states"]
        self._device_kind = harness.device_kind
        harness.device_kind = counting_cards(harness.device_kind, self.group.devices)

    def call(self, k: int) -> dict:
        """One step of every rank on its state k: the diagnostics of every
        column, in rank order, on the host."""
        d = self.group.step(k).reshape(-1, 3)
        return {"olr": d[:, 0], "lw_sfc_dn": d[:, 1], "sw_sfc_dn": d[:, 2]}

    def work(self, k: int) -> dict:
        """Rank 0's work alone: the profiled window sees its card only."""
        return self.shares[0].work(k)

    def free_program(self) -> None:
        stats = self.group.stats()
        self.group.close()
        harness.device_kind = self._device_kind
        self.shares[0].free_program()
        print("ranks " + json.dumps(_summary(stats)), file=sys.stderr)

    def reference(self, k: int, prec: P.Precision, device) -> dict:
        """The plain reference on state k of every rank, each rank's part on
        its own card (threads, after the group has closed), in rank order."""
        t0 = time.perf_counter()

        def one(r):
            if r not in self.shares:
                self.shares[r] = Share(self.config, self.workload, self.seed, r, self.root)
            dev = self.group.devices[r]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return self.shares[r].reference(k, prec, dev)
            return self.shares[r].reference(k, prec, dev)

        with ThreadPoolExecutor(self.ranks) as pool:
            parts = list(pool.map(one, range(self.ranks)))
        print(f"reference of state {k}, {self.ranks} ranks: {time.perf_counter() - t0:.2f} s",
              file=sys.stderr)
        return {name: np.concatenate([p[name] for p in parts]) for name in self.CHECKS}


def setup(config: dict, workload: dict, seed: int, device, root: str) -> Cell:
    return Cell(config, workload, seed, device, root)
