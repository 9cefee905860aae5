"""rte_rrtmgp_nn_tpu_torch: the PyTorch/CUDA port of rte_rrtmgp_nn_tpu.

It sits beside the JAX package, mirrors its module paths, and imports
neither JAX nor the JAX package. Plain tensor code is PyTorch; each Pallas
kernel of the JAX package (``ops/pallas/X.py``) has a hand-written CUDA
counterpart here (``ops/cuda/X.py`` with its source in ``csrc/``), built
with nvcc at first CUDA use.

Layers (bottom-up):
  config/constants      runtime flags and the drivers' dispatch, physical constants
  spectral/gas_concs/fluxes/optical_props/sources   core data model
  models/               NN model format (reference-compatible netCDF)
  gasoptics/            NN gas optics and the Planck table
  ops/                  LW/SW solvers, scans and adding (plain PyTorch)
  ops/cuda/             the CUDA kernels (fused clear-sky, MLP, LW transport)
                        and their plain twins
  rte                   the RTE interface: rte_lw, rte_sw
  extensions/           cloud optics, McICA sampling, heating rates, BCs
  parallel/             column splitting over devices and processes, host -> device streaming
  drivers/              RFMIP clear-sky, all-sky and GCM-sweep entry points

The package exports what the JAX package's ``__init__`` exports. Importing
it loads no kernel and needs no CUDA toolkit.
"""

from .config import config, config_override, set_checks
from .constants import constants
from .fluxes import (
    FluxesBroadband,
    FluxesByband,
    FluxesBygpoint,
    reduce_broadband,
    reduce_byband,
)
from .gas_concs import GasConcs, get_ref_vmr
from .optical_props import (
    OpticalProps1scl,
    OpticalProps2str,
    OpticalPropsNstr,
    delta_scale,
    increment,
    subset,
    validate,
    zeros_1scl,
    zeros_2str,
    zeros_nstr,
)
from .rte import rte_lw, rte_sw
from .sources import SourceFuncLW, SourceFuncSW
from .spectral import SpectralMapping

# gas optics
from .gasoptics.kdist import KDist, load_kdist
from .gasoptics.lut_gas_optics import (
    compute_optimal_angles,
    gas_optics_lw_lut,
    gas_optics_sw_lut,
)
from .gasoptics.nn_gas_optics import (
    gas_optics_lw_nn,
    gas_optics_sw_nn,
    get_col_dry,
    interp_tlev,
)
from .gasoptics.planck import (
    PlanckTable,
    lw_spectral_g128,
    lw_spectral_g256,
    sw_spectral_g112,
    sw_spectral_g224,
)

# NN models
from .models.network import NNModel, load_model_netcdf, save_model_netcdf

# extensions
from .extensions.cloud_optics import CloudOptics, cloud_optics, load_cloud_optics
from .extensions.cloud_sampling import (
    draw_samples_to,
    sampled_mask_exp_ran,
    sampled_mask_max_ran,
)
from .extensions.compute_bc import compute_bc
from .extensions.heating_rates import compute_heating_rate, compute_heating_rate_kday
from .extensions.solar_variability import SolarVar

__version__ = "0.1.0"
