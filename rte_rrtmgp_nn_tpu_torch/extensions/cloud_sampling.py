"""McICA cloud sampling.

Port of rte_rrtmgp_nn_tpu/extensions/cloud_sampling.py (reference
extensions/cloud_optics/mo_cloud_sampling.F90: ``sampled_mask_max_ran``
:125-192, maximum-random overlap; ``sampled_mask_exp_ran`` :200-285,
exponential-random overlap with a correlation per interface;
``draw_samples`` :36-120, band -> g-point cloud placement by a boolean
mask). The random deviates are an argument, so the caller decides where
they come from. The layer sweep that keeps or redraws each g-point's
deviate is a loop over layers.
"""
from __future__ import annotations

import torch

from ..optical_props import OpticalProps1scl, OpticalProps2str


def sampled_mask_max_ran(randoms: torch.Tensor, cloud_frac: torch.Tensor) -> torch.Tensor:
    """Maximum-random overlap cloud mask.

    randoms: (ncol, nlay, ngpt) uniform deviates; cloud_frac: (ncol, nlay).
    Returns a bool mask (ncol, nlay, ngpt): the cloudy g-points per layer.
    """
    local = randoms[:, 0]
    masks = []
    for lay in range(randoms.shape[1]):
        cf = cloud_frac[:, lay, None]
        if lay > 0:
            # the deviates of the layer above where it is cloudy, fresh ones below clear sky
            local = torch.where(cloud_frac[:, lay - 1, None] > 0.0, local, randoms[:, lay])
        masks.append((local > 1.0 - cf) & (cf > 0.0))
    return torch.stack(masks, dim=1)


def sampled_mask_exp_ran(randoms: torch.Tensor, cloud_frac: torch.Tensor,
                         overlap_param: torch.Tensor) -> torch.Tensor:
    """Exponential-random overlap cloud mask.

    overlap_param: (ncol, nlay-1), the correlation rho between the
    deviates of adjacent layers; rho = 1 is maximum overlap.
    """
    local = randoms[:, 0]
    masks = []
    for lay in range(randoms.shape[1]):
        cf = cloud_frac[:, lay, None]
        rnd = randoms[:, lay]
        if lay > 0:
            rho = overlap_param[:, lay - 1, None]
            corr = rho * (local - 0.5) + torch.sqrt(1.0 - rho ** 2) * (rnd - 0.5) + 0.5
            local = torch.where(cloud_frac[:, lay - 1, None] > 0.0, corr, rnd)
        masks.append((local > 1.0 - cf) & (cf > 0.0))
    return torch.stack(masks, dim=1)


def _sampled(target_spectral, cloud_mask, clouds, expand):
    tau = torch.where(cloud_mask, expand(clouds.tau), 0.0)
    if isinstance(clouds, OpticalProps2str):
        ssa = torch.where(cloud_mask, expand(clouds.ssa), 0.0)
        g = torch.where(cloud_mask, expand(clouds.g), 0.0)
        return OpticalProps2str(tau, ssa, g, target_spectral)
    return OpticalProps1scl(tau, target_spectral)


def draw_samples(cloud_mask: torch.Tensor, clouds):
    """McICA-sampled cloud properties on the clouds' own g-point grid:
    cloudy g-points keep their value, clear ones get zero (reference
    apply_cloud_mask :291-307). For band-resolved clouds onto a
    k-distribution's grid, use ``draw_samples_to``."""
    if cloud_mask.shape[-1] != clouds.spectral.ngpt:
        raise ValueError(
            "draw_samples: build the mask on the target g-point grid and "
            "expand cloud bands with draw_samples_to(spectral, ...)")
    return _sampled(clouds.spectral, cloud_mask, clouds, lambda x: x)


def draw_samples_to(target_spectral, cloud_mask: torch.Tensor, clouds):
    """draw_samples with the band -> g-point expansion onto
    ``target_spectral`` (the usual McICA use: band cloud optics onto the
    k-distribution's grid)."""
    if clouds.spectral.ngpt != target_spectral.nband:
        raise ValueError("draw_samples_to: clouds must be band-resolved")
    return _sampled(target_spectral, cloud_mask, clouds, target_spectral.expand)
