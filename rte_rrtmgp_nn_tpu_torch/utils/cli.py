"""What the command-line entry points (scripts/torch_*.py) share: the
files they take from the reference checkout, and the rule of their
``--device`` flag.

The JAX package's scripts default to files of the reference checkout
(rte-rrtmgp-nn: its examples/, extensions/ and neural/data/ directories)
at a fixed location. The port's scripts assume no location: a flag that
names such a file or directory is required, and its help names the file
within the reference checkout (the *_IN_REFERENCE paths below).
"""
from __future__ import annotations

import argparse

import torch

RFMIP_INPUT_IN_REFERENCE = ("examples/rfmip-clear-sky/"
                            "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc")
GARAND_IN_REFERENCE = "examples/all-sky/garand-atmos-1.nc"
CLOUD_COEFFS_IN_REFERENCE = "extensions/cloud_optics/rrtmgp-cloud-optics-coeffs-{}.nc"
MODELS_DIR_IN_REFERENCE = "neural/data"
# the nets the reference's RFMIP and all-sky examples load from its models dir
LW_MODEL_FILE = "lw-g128-210809_both_BEST.nc"
SW_MODEL_FILES = ("sw-g112-210809_absorption_BEST.nc", "sw-g112-210809_rayleigh_BEST.nc")
# the unreduced SW absorption net (16 g-points a band) the g-112 quadrature
# weights are fitted against (scripts/torch_calibrate_sw_g112.py)
SW_G224_MODEL_FILE = "sw-g224-2018-12-04-absorption_BEST.nc"


def add_reference_argument(ap: argparse.ArgumentParser, flag: str, in_reference: str,
                           what: str = "file") -> None:
    """A required flag naming a file (or directory) of the reference
    checkout; its help says which one."""
    ap.add_argument(flag, required=True,
                    help=f"the reference checkout's {in_reference} (or a {what} of its layout)")


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' "
                         "plain PyTorch versions)")


def resolve_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The device ``--device`` names, with TF32 off for matrix products.
    Exits through ``ap.error`` (status 2) when it names CUDA on a host
    without a CUDA device: a script never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {name}: this host has no CUDA device "
                 "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
