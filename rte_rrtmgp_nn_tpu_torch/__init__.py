"""rte_rrtmgp_nn_tpu_torch: the PyTorch/CUDA port of rte_rrtmgp_nn_tpu.

It sits beside the JAX package, mirrors its module paths, and imports
neither JAX nor the JAX package. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package (``ops/pallas/X.py``) has a hand-written CUDA
counterpart here (``ops/cuda/X.py`` with its source in ``csrc/``), built
with nvcc at first CUDA use.

Layers (bottom-up):
  config/constants      runtime flags, physical constants
  spectral/gas_concs/fluxes   core data model
  models/               NN model format (reference-compatible netCDF)
  gasoptics/            NN gas optics and the Planck table
  ops/                  staged LW/SW broadband solvers (plain PyTorch)
  ops/cuda/             the fused clear-sky kernels and their plain twins
  drivers/              RFMIP clear-sky entry points

Importing the package loads no kernel and needs no CUDA toolkit.
"""

from .config import config, config_override
from .constants import constants
from .fluxes import FluxesBroadband
from .gas_concs import GasConcs, get_ref_vmr
from .spectral import SpectralMapping

__version__ = "0.1.0"
