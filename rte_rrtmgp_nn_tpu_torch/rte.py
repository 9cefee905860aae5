"""Top-level RTE drivers: ``rte_lw`` and ``rte_sw``.

Port of rte_rrtmgp_nn_tpu/rte.py (reference rte/mo_rte_lw.F90: argument
consistency and value checks, band-emissivity expansion, dispatch by
optical-properties type; rte/mo_rte_sw.F90: 1scl -> direct beam only,
2str -> two-stream + adding, with per-g-point albedos from the caller).
Arrays are (ncol, nlay, ngpt). On CUDA both take float32 only, like the
drivers (the kernels are float32). The solves, after the checks, run in the
``utils/timing.span`` ranges ``rte.solve.lw`` and ``rte.solve.sw``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import config, cuda_dtype_refusal
from .ops.lw_solver import LWSolution, lw_solver_2stream, lw_solver_noscat
from .ops.sw_solver import SWSolution, sw_solver_2stream, sw_solver_noscat
from .optical_props import OpticalProps1scl, OpticalProps2str, OpticalPropsNstr, validate
from .sources import SourceFuncLW
from .utils.timing import span
from .utils.validation import any_vals_less_than, any_vals_outside


def _check_values_lw(optical_props, sfc_emis, inc_flux, lw_ds, n_gauss_angles):
    """Reference mo_rte_lw.F90:190-205,266 value checks."""
    errs = validate(optical_props)
    if any_vals_outside(sfc_emis, 0.0, 1.0):
        errs.append("rte_lw: sfc_emis has values < 0 or > 1")
    if inc_flux is not None and any_vals_less_than(inc_flux, 0.0):
        errs.append("rte_lw: inc_flux has values < 0")
    if not 1 <= n_gauss_angles <= 4:
        errs.append("rte_lw: n_gauss_angles must be in 1..4")
    if lw_ds is not None and any_vals_less_than(lw_ds, 1.0):
        errs.append("rte_lw: one or more values of lw_ds < 1.")
    if errs:
        raise ValueError("; ".join(errs))


def _check_values_sw(optical_props, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif, inc_flux_dif):
    """Reference mo_rte_sw.F90:120-133 value checks."""
    errs = validate(optical_props)
    if any_vals_outside(mu0, 0.0, 1.0):
        errs.append("rte_sw: one or more mu0 <= 0 or > 1")
    if any_vals_less_than(inc_flux, 0.0):
        errs.append("rte_sw: inc_flux has values < 0")
    if any_vals_outside(sfc_alb_dir, 0.0, 1.0):
        errs.append("rte_sw: sfc_alb_dir out of range [0,1]")
    if any_vals_outside(sfc_alb_dif, 0.0, 1.0):
        errs.append("rte_sw: sfc_alb_dif out of range [0,1]")
    if inc_flux_dif is not None and any_vals_less_than(inc_flux_dif, 0.0):
        errs.append("rte_sw: inc_flux_dif has values < 0")
    if errs:
        raise ValueError("; ".join(errs))


def _refuse_on_cuda(name: str, optical_props) -> None:
    """NotImplementedError for a non-float32 request on CUDA: the kernels
    are float32 and their plain twins never run on the card."""
    why = cuda_dtype_refusal(optical_props.tau.device, optical_props.tau.dtype)
    if why:
        raise NotImplementedError(f"{name}: {why}")


def rte_lw(
    optical_props,
    top_at_1: bool,
    sources: SourceFuncLW,
    sfc_emis: torch.Tensor,
    inc_flux: Optional[torch.Tensor] = None,
    n_gauss_angles: int = 1,
    use_2stream: bool = False,
    lw_ds: Optional[torch.Tensor] = None,
    compute_jac: bool = False,
    scan_mode: str = "sequential",
    broadband: bool = False,
) -> LWSolution:
    """Longwave transport. sfc_emis is per band (ncol, nband), expanded to
    g-points here (reference mo_rte_lw.F90:295-303). Returns spectral
    fluxes, or broadband ones with ``broadband=True``; with the Jacobian
    (``compute_jac`` or config.compute_jac) flux_up_jac and a zero
    flux_dn_jac."""
    _refuse_on_cuda("rte_lw", optical_props)
    spectral = optical_props.spectral
    ncol, nlay, ngpt = optical_props.tau.shape
    want_jac = compute_jac or config.compute_jac

    # argument-consistency errors are unconditional, like the reference's
    # select-type block (mo_rte_lw.F90:235-259)
    if use_2stream and isinstance(optical_props, OpticalProps1scl):
        raise ValueError("rte_lw: can't use two-stream methods with only absorption "
                         "optical depth")
    if lw_ds is not None:
        if not isinstance(optical_props, OpticalProps1scl):
            raise ValueError("rte_lw: lw_ds not valid input for 2str optical props")
        if n_gauss_angles != 1:
            raise ValueError("rte_lw: providing lw_ds incompatible with specifying "
                             "n_gauss_angles")
    if use_2stream and n_gauss_angles != 1:
        raise ValueError("rte_lw: use_2stream incompatible with specifying n_gauss_angles")
    if use_2stream and want_jac:
        raise ValueError("rte_lw: can't provide Jacobian of fluxes w.r.t surface "
                         "temperature with 2-stream")

    if config.check_extents:
        if tuple(sources.lay_source.shape) != (ncol, nlay, ngpt):
            raise ValueError("rte_lw: sources inconsistently sized")
        if tuple(sources.lev_source.shape) != (ncol, nlay + 1, ngpt):
            raise ValueError("rte_lw: lev_source must be (ncol, nlay+1, ngpt)")
        if tuple(sources.sfc_source.shape) != (ncol, ngpt):
            raise ValueError("rte_lw: sfc_source must be (ncol, ngpt)")
        if tuple(sfc_emis.shape) != (ncol, spectral.nband):
            raise ValueError("rte_lw: sfc_emis must be (ncol, nband)")
        if lw_ds is not None and tuple(lw_ds.shape) != (ncol, ngpt):
            raise ValueError("rte_lw: lw_ds inconsistently sized")
        if inc_flux is not None and tuple(inc_flux.shape) != (ncol, ngpt):
            raise ValueError("rte_lw: inc_flux must be (ncol, ngpt)")
    if config.check_values:
        _check_values_lw(optical_props, sfc_emis, inc_flux, lw_ds, n_gauss_angles)

    with span("rte.solve.lw"):
        sfc_emis_gpt = spectral.expand(sfc_emis)
        jac = sources.sfc_source_jac if want_jac else None

        def with_dn_jac(sol: LWSolution) -> LWSolution:
            # the reference accepts flux_dn_Jac but never computes it
            # (mo_rte_lw.F90:85); in the no-scattering solver it is exactly 0
            if jac is None or sol.flux_up_jac is None:
                return sol
            return sol._replace(flux_dn_jac=torch.zeros_like(sol.flux_dn))

        if isinstance(optical_props, OpticalProps1scl):
            return with_dn_jac(lw_solver_noscat(
                optical_props.tau, sources.lay_source, sources.lev_source,
                sfc_emis_gpt, sources.sfc_source, inc_flux=inc_flux,
                top_at_1=top_at_1, n_gauss_angles=n_gauss_angles, lw_ds=lw_ds,
                sfc_source_jac=jac, scan_mode=scan_mode, broadband=broadband))
        if isinstance(optical_props, OpticalProps2str):
            if use_2stream:
                return lw_solver_2stream(
                    optical_props.tau, optical_props.ssa, optical_props.g, sources.lay_source,
                    sources.lev_source, sfc_emis_gpt, sources.sfc_source, inc_flux=inc_flux,
                    top_at_1=top_at_1, scan_mode=scan_mode)
            # Tang-2018 rescaled no-scattering solution (reference :357-389)
            return with_dn_jac(lw_solver_noscat(
                optical_props.tau, sources.lay_source, sources.lev_source,
                sfc_emis_gpt, sources.sfc_source, inc_flux=inc_flux,
                top_at_1=top_at_1, n_gauss_angles=n_gauss_angles, sfc_source_jac=jac,
                ssa=optical_props.ssa, g=optical_props.g, do_rescaling=True,
                scan_mode=scan_mode))
        if isinstance(optical_props, OpticalPropsNstr):
            # parity: the reference raises the same (mo_rte_lw.F90:391-395)
            raise NotImplementedError("rte_lw(...nstr...) not yet implemented")
        raise TypeError(f"rte_lw: unknown optical props {type(optical_props)}")


def rte_sw(
    optical_props,
    top_at_1: bool,
    mu0: torch.Tensor,
    inc_flux: torch.Tensor,
    sfc_alb_dir: torch.Tensor,
    sfc_alb_dif: torch.Tensor,
    inc_flux_dif: Optional[torch.Tensor] = None,
    scan_mode: str = "sequential",
    broadband: bool = False,
) -> SWSolution:
    """Shortwave transport (reference mo_rte_sw.F90:48-242): mu0 (ncol,)
    cosine of the solar zenith angle, inc_flux (ncol, ngpt) TOA direct
    flux, surface albedos (ncol, ngpt) already per g-point. Spectral
    fluxes, or broadband ones with ``broadband=True``."""
    _refuse_on_cuda("rte_sw", optical_props)
    if config.check_extents:
        ncol, _, ngpt = optical_props.tau.shape
        for nm, a, shp in (("mu0", mu0, (ncol,)), ("inc_flux", inc_flux, (ncol, ngpt)),
                           ("sfc_alb_dir", sfc_alb_dir, (ncol, ngpt)),
                           ("sfc_alb_dif", sfc_alb_dif, (ncol, ngpt))):
            if tuple(a.shape) != shp:
                raise ValueError(f"rte_sw: {nm} has shape {tuple(a.shape)}, want {shp}")
    if config.check_values:
        _check_values_sw(optical_props, mu0, inc_flux, sfc_alb_dir, sfc_alb_dif, inc_flux_dif)

    with span("rte.solve.sw"):
        if isinstance(optical_props, OpticalProps1scl):
            flux_dir = sw_solver_noscat(optical_props.tau, mu0, inc_flux, top_at_1=top_at_1)
            if broadband:
                flux_dir = flux_dir.sum(-1)
            return SWSolution(torch.zeros_like(flux_dir), flux_dir, flux_dir)
        if isinstance(optical_props, OpticalProps2str):
            return sw_solver_2stream(
                optical_props.tau, optical_props.ssa, optical_props.g, mu0, inc_flux,
                sfc_alb_dir, sfc_alb_dif, inc_flux_dif=inc_flux_dif, top_at_1=top_at_1,
                scan_mode=scan_mode, broadband=broadband)
        raise TypeError(f"rte_sw: unsupported optical props {type(optical_props)}")
