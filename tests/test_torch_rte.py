"""PyTorch port against the JAX package: the RTE interface (rte_lw with 1-4
Gauss angles or per-g-point secants, incident flux, the surface-
temperature Jacobian, both orientations, broadband and spectral output;
rte_sw with two-stream and absorption-only optical properties), the
optical-property validation, the host-side value checks, the broadband
reduction, and every rte_lw argument error. Same seeded numpy inputs on
both sides; fluxes to LW atol 2e-3 and SW atol 2e-2 W/m2 (the JAX
package's kernel-vs-staged bounds)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu import fluxes as jfl
from rte_rrtmgp_nn_tpu import optical_props as jop
from rte_rrtmgp_nn_tpu import rte as jrte
from rte_rrtmgp_nn_tpu import sources as jsrc
from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.spectral import SpectralMapping as JSM
from rte_rrtmgp_nn_tpu.utils import validation as jval
from rte_rrtmgp_nn_tpu_torch import fluxes as pfl
from rte_rrtmgp_nn_tpu_torch import optical_props as pop
from rte_rrtmgp_nn_tpu_torch import rte as prte
from rte_rrtmgp_nn_tpu_torch import sources as psrc
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.ops.scan import affine_scan, affine_scan_reverse
from rte_rrtmgp_nn_tpu_torch.spectral import SpectralMapping as PSM
from rte_rrtmgp_nn_tpu_torch.utils import validation as pval

NCOL, NLAY = 5, 7
BANDS_GPT, BANDS_WVN = [[0, 6], [6, 16]], [[10.0, 350.0], [350.0, 1000.0]]
NGPT = 16
LW_ATOL, SW_ATOL = 2e-3, 2e-2


def _f32(rng, lo, hi, *shape):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _lw_case(rng):
    """(JAX args, port args) of one LW problem: optical depths, sources,
    band emissivity, incident flux and per-g-point secants."""
    arrs = dict(tau=_f32(rng, 1e-4, 3.0, NCOL, NLAY, NGPT),
                lay=_f32(rng, 0.1, 1.0, NCOL, NLAY, NGPT),
                lev=_f32(rng, 0.1, 1.0, NCOL, NLAY + 1, NGPT),
                sfc=_f32(rng, 0.1, 1.0, NCOL, NGPT), jac=_f32(rng, 0.001, 0.01, NCOL, NGPT),
                emis=_f32(rng, 0.8, 1.0, NCOL, 2), inc=_f32(rng, 0.0, 3.0, NCOL, NGPT),
                ds=_f32(rng, 1.2, 2.5, NCOL, NGPT))
    out = []
    for SM, OP, SRC, conv in ((JSM, jop, jsrc, jnp.asarray), (PSM, pop, psrc, torch.from_numpy)):
        spec = SM.create(BANDS_GPT, BANDS_WVN)
        a = {k: conv(v) for k, v in arrs.items()}
        out.append((OP.OpticalProps1scl(a["tau"], spec),
                    SRC.SourceFuncLW(a["lay"], a["lev"], a["sfc"], a["jac"], spec), a))
    return out


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("broadband", [True, False], ids=["broadband", "spectral"])
@pytest.mark.parametrize("angles", [1, 2, 3, 4, "lw_ds"])
def test_rte_lw_matches_jax(rng, angles, broadband, top_at_1):
    (jo, js, ja), (po, ps, pa) = _lw_case(rng)
    n = 1 if angles == "lw_ds" else angles
    ref, got = (rte.rte_lw(o, top_at_1, src, a["emis"], inc_flux=a["inc"], n_gauss_angles=n,
                           lw_ds=a["ds"] if angles == "lw_ds" else None, compute_jac=True,
                           broadband=broadband)
                for rte, o, src, a in ((jrte, jo, js, ja), (prte, po, ps, pa)))
    shape = (NCOL, NLAY + 1) if broadband else (NCOL, NLAY + 1, NGPT)
    for n in ("flux_up", "flux_dn", "flux_up_jac", "flux_dn_jac"):
        g, r = getattr(got, n), np.asarray(getattr(ref, n))
        assert tuple(g.shape) == shape, n
        np.testing.assert_allclose(g.numpy(), r, atol=LW_ATOL, rtol=1e-5, err_msg=n)
    assert not got.flux_dn_jac.any()
    if not broadband:  # the spectral fluxes reduce as the JAX package's do
        rp = pfl.reduce_broadband(got.flux_up, got.flux_dn, gpt_flux_up_jac=got.flux_up_jac)
        rj = jfl.reduce_broadband(ref.flux_up, ref.flux_dn, gpt_flux_up_jac=ref.flux_up_jac)
        for n in ("flux_up", "flux_dn", "flux_net", "flux_up_jac"):
            np.testing.assert_allclose(getattr(rp, n).numpy(), np.asarray(getattr(rj, n)),
                                       atol=LW_ATOL, err_msg=n)


@pytest.mark.parametrize("broadband", [True, False], ids=["broadband", "spectral"])
@pytest.mark.parametrize("flag", ["fast_exponential", "use_pade_source"])
def test_rte_lw_numerics_flags(rng, flag, broadband):
    """The Pade exponential and source forms move the fluxes as in the JAX
    package (the Jacobian rides the same transmittances)."""
    (jo, js, ja), (po, ps, pa) = _lw_case(rng)
    with jco(**{flag: True}):
        ref = jrte.rte_lw(jo, False, js, ja["emis"], n_gauss_angles=2, compute_jac=True,
                          broadband=broadband)
    with pco(**{flag: True}):
        got = prte.rte_lw(po, False, ps, pa["emis"], n_gauss_angles=2, compute_jac=True,
                          broadband=broadband)
    exact = prte.rte_lw(po, False, ps, pa["emis"], n_gauss_angles=2, broadband=broadband)
    for n in ("flux_up", "flux_dn", "flux_up_jac"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=LW_ATOL, rtol=1e-5, err_msg=n)
    assert float((got.flux_up - exact.flux_up).abs().max()) > 1e-5


def _sw_case(rng, kind):
    tau = _f32(rng, 1e-5, 3.0, NCOL, NLAY, NGPT)
    tau[0, 0, 0] = 0.0  # a transparent layer
    arrs = dict(tau=tau, ssa=_f32(rng, 0.0, 1.0, NCOL, NLAY, NGPT),
                g=_f32(rng, 0.0, 0.8, NCOL, NLAY, NGPT), mu0=_f32(rng, 0.05, 1.0, NCOL),
                inc=_f32(rng, 0.0, 30.0, NCOL, NGPT), alb_dir=_f32(rng, 0.05, 0.5, NCOL, NGPT),
                alb_dif=_f32(rng, 0.05, 0.5, NCOL, NGPT), inc_dif=_f32(rng, 0.0, 2.0, NCOL, NGPT))
    out = []
    for SM, OP, conv in ((JSM, jop, jnp.asarray), (PSM, pop, torch.from_numpy)):
        spec = SM.create(BANDS_GPT, BANDS_WVN)
        a = {k: conv(v) for k, v in arrs.items()}
        props = (OP.OpticalProps2str(a["tau"], a["ssa"], a["g"], spec) if kind == "2str"
                 else OP.OpticalProps1scl(a["tau"], spec))
        out.append((props, a))
    return out, arrs


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("broadband", [True, False], ids=["broadband", "spectral"])
@pytest.mark.parametrize("kind", ["2str", "1scl"])
def test_rte_sw_matches_jax(rng, kind, broadband, top_at_1):
    ((jo, ja), (po, pa)), arrs = _sw_case(rng, kind)
    ref = jrte.rte_sw(jo, top_at_1, ja["mu0"], ja["inc"], ja["alb_dir"], ja["alb_dif"],
                      inc_flux_dif=ja["inc_dif"], broadband=broadband)
    got = prte.rte_sw(po, top_at_1, pa["mu0"], pa["inc"], pa["alb_dir"], pa["alb_dif"],
                      inc_flux_dif=pa["inc_dif"], broadband=broadband)
    for n in ("flux_up", "flux_dn", "flux_dn_dir"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=SW_ATOL, err_msg=n)
    top = 0 if top_at_1 else NLAY
    toa = got.flux_dn_dir[:, top]
    expect = arrs["inc"] * arrs["mu0"][:, None]
    np.testing.assert_allclose(toa.numpy(), expect.sum(-1) if broadband else expect, rtol=1e-6)


@pytest.mark.parametrize("case", ["tau", "ssa", "g"])
def test_validate(case):
    tau = np.full((2, 3, NGPT), 0.5, np.float32)
    ssa, g = np.full_like(tau, 0.5), np.full_like(tau, 0.2)
    bad = {"tau": (tau, -1e-3), "ssa": (ssa, 1.01), "g": (g, -1.5)}[case]
    bad[0][1, 2, 3] = bad[1]
    errs = []
    for SM, OP, conv in ((JSM, jop, jnp.asarray), (PSM, pop, torch.from_numpy)):
        spec = SM.create(BANDS_GPT, BANDS_WVN)
        props = OP.OpticalProps2str(conv(tau), conv(ssa), conv(g), spec)
        errs.append((OP.validate(props), OP.validate(OP.OpticalProps1scl(conv(tau), spec))))
    assert errs[0] == errs[1] and len(errs[1][0]) == 1
    assert pop.validate(pop.zeros_2str(2, 3, PSM.create(BANDS_GPT, BANDS_WVN))) == []
    assert pop.zeros_1scl(2, 3, PSM.create(BANDS_GPT, BANDS_WVN)).tau.shape == (2, 3, NGPT)


@pytest.mark.parametrize("mask", [None, "some", "none"])
def test_value_checks(rng, mask):
    a = rng.uniform(-1.0, 2.0, (4, 6)).astype(np.float32)
    a[0, 0] = np.nan
    m = {None: None, "some": rng.uniform(size=a.shape) > 0.5,
         "none": np.zeros(a.shape, bool)}[mask]
    pm = None if m is None else torch.from_numpy(m)
    for lim in (-0.5, 0.0, -2.0):
        assert pval.any_vals_less_than(torch.from_numpy(a), lim, pm) == \
            jval.any_vals_less_than(a, lim, m)
    for lo, hi in ((-2.0, 3.0), (0.0, 1.0), (-1.0, 1.5)):
        assert pval.any_vals_outside(torch.from_numpy(a), lo, hi, pm) == \
            jval.any_vals_outside(a, lo, hi, m)
    t = torch.from_numpy(a)
    assert pval.extents_are(t, 4, 6) and not pval.extents_are(t, 6, 4)


def _lw_error_case(rng, name):
    """(kwargs for rte_lw, config overrides, expected exception, message
    pattern, whether the JAX package raises the same) of one error."""
    (jo, js, ja), (po, ps, pa) = _lw_case(rng)
    tau = pa["tau"]
    two = pop.OpticalProps2str(tau, torch.zeros_like(tau), torch.zeros_like(tau), po.spectral)
    jtwo = jop.OpticalProps2str(ja["tau"], jnp.zeros_like(ja["tau"]), jnp.zeros_like(ja["tau"]),
                                jo.spectral)
    bad_ssa = torch.full_like(tau, 1.5)
    bad = pop.OpticalProps2str(tau, bad_ssa, torch.zeros_like(tau), po.spectral)
    jbad = jop.OpticalProps2str(ja["tau"], jnp.asarray(bad_ssa.numpy()), jnp.zeros_like(ja["tau"]),
                                jo.spectral)
    cases = {
        "2stream_1scl": (dict(use_2stream=True), {}, ValueError, "two-stream methods", True),
        "lw_ds_2str": (dict(props=(jtwo, two), lw_ds=True), {}, ValueError, "lw_ds not valid", True),
        "lw_ds_angles": (dict(lw_ds=True, n_gauss_angles=2), {}, ValueError,
                         "lw_ds incompatible", True),
        "2stream_angles": (dict(props=(jtwo, two), use_2stream=True, n_gauss_angles=2), {},
                           ValueError, "use_2stream incompatible", True),
        "2stream_jac": (dict(props=(jtwo, two), use_2stream=True, compute_jac=True), {},
                        ValueError, "Jacobian", True),
        "extents_sources": (dict(bad="lay"), dict(check_extents=True), ValueError,
                            "sources inconsistently sized", True),
        "extents_emis": (dict(bad="emis"), dict(check_extents=True), ValueError,
                         "sfc_emis must be", True),
        "values_emis": (dict(bad="emis_value"), dict(check_values=True), ValueError,
                        "sfc_emis has values", True),
        "values_lw_ds": (dict(lw_ds="small"), dict(check_values=True), ValueError,
                         "lw_ds < 1", True),
        "values_angles": (dict(n_gauss_angles=5), dict(check_values=True), ValueError,
                          "n_gauss_angles must be in 1..4", True),
        "angles": (dict(n_gauss_angles=5), {}, ValueError, "n_gauss_angles must be in 1..4", True),
        "nstr": (dict(props=(jop.OpticalPropsNstr(ja["tau"], ja["tau"], ja["tau"][None],
                                                  jo.spectral),
                             pop.OpticalPropsNstr(tau, tau, tau[None], po.spectral))), {},
                 NotImplementedError, r"rte_lw\(\.\.\.nstr\.\.\.\) not yet implemented", True),
        "unknown_props": (dict(props=(SimpleNamespace(tau=ja["tau"], spectral=jo.spectral),
                                      SimpleNamespace(tau=tau, spectral=po.spectral))), {},
                          TypeError, "unknown optical props", True),
        "values_2str": (dict(props=(jbad, bad)), dict(check_values=True), ValueError,
                        "ssa", True),
        "extents_lev": (dict(bad="lev"), dict(check_extents=True), ValueError,
                        "lev_source must be", True),
        "extents_inc": (dict(bad="inc"), dict(check_extents=True), ValueError,
                        "inc_flux must be", True),
    }
    kw, cfg, exc, match, jax_too = cases[name]
    calls = []
    for props, src, a in (((jo, js, ja)), ((po, ps, pa))):
        k = dict(kw)
        props = k.pop("props", (jo, po))[0 if a is ja else 1]
        emis = a["emis"]
        bad = k.pop("bad", None)
        if bad == "lay":
            src = type(src)(a["lay"][:, :-1], a["lev"], a["sfc"], a["jac"], src.spectral)
        elif bad == "lev":
            src = type(src)(a["lay"], a["lev"][:, :-1], a["sfc"], a["jac"], src.spectral)
        elif bad == "inc":
            k["inc_flux"] = a["inc"][:, :-1]
        elif bad == "emis":
            emis = a["emis"][:, :1]
        elif bad == "emis_value":
            emis = a["emis"] * 2.0
        if k.get("lw_ds") is True:
            k["lw_ds"] = a["ds"]
        elif k.get("lw_ds") == "small":
            k["lw_ds"] = a["ds"] * 0.5
        calls.append((props, src, emis, k))
    return calls, cfg, exc, match, jax_too


@pytest.mark.parametrize("name", [
    "2stream_1scl", "lw_ds_2str", "lw_ds_angles", "2stream_angles", "2stream_jac",
    "extents_sources", "extents_emis", "values_emis", "values_lw_ds", "values_angles", "angles",
    "nstr", "unknown_props", "values_2str", "extents_lev", "extents_inc"])
def test_rte_lw_argument_errors(rng, name):
    """Each argument error rte_lw raises; where the JAX package raises it
    too, with the same message."""
    (jcall, pcall), cfg, exc, match, jax_too = _lw_error_case(rng, name)
    with pco(**cfg), pytest.raises(exc, match=match):
        props, src, emis, k = pcall
        prte.rte_lw(props, True, src, emis, **k)
    if jax_too:
        with jco(**cfg), pytest.raises(exc, match=match):
            props, src, emis, k = jcall
            jrte.rte_lw(props, True, src, emis, **k)


@pytest.mark.parametrize("which", ["rte_lw", "rte_sw"])
def test_rte_refuses_float64_on_cuda(which):
    """On CUDA rte_lw and rte_sw take float32 only, as the drivers do: the
    kernels are float32 and their plain twins never run on the card. The
    CUDA tensors are fake (shape, dtype and device without data), so no
    card is needed; float64 on the CPU is the arbiter and runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = PSM.create(BANDS_GPT, BANDS_WVN)
    with FakeTensorMode():
        z = lambda *shape: torch.ones(shape, dtype=torch.float64, device="cuda")
        tau = z(NCOL, NLAY, NGPT)
        with pytest.raises(NotImplementedError, match=f"{which}: torch.float64 runs only on the CPU"):
            if which == "rte_lw":
                prte.rte_lw(pop.OpticalProps1scl(tau, spec), True,
                            psrc.SourceFuncLW(tau, z(NCOL, NLAY + 1, NGPT), z(NCOL, NGPT),
                                              z(NCOL, NGPT), spec),
                            z(NCOL, 2), n_gauss_angles=3, broadband=True)
            else:
                prte.rte_sw(pop.OpticalProps2str(tau, 0.5 * tau, 0.0 * tau, spec), True, z(NCOL),
                            z(NCOL, NGPT), z(NCOL, NGPT), z(NCOL, NGPT), broadband=True)


@pytest.mark.parametrize("broadband", [False, True], ids=["spectral", "broadband"])
def test_adding_matches_jax(rng, broadband):
    """The adding sweeps on their own (SH08), spectral and broadband."""
    from rte_rrtmgp_nn_tpu.ops.adding import adding as jadding
    from rte_rrtmgp_nn_tpu_torch.ops.adding import adding as padding

    rdif, tdif = _f32(rng, 0.0, 0.4, NCOL, NLAY, NGPT), _f32(rng, 0.3, 0.6, NCOL, NLAY, NGPT)
    arrs = (_f32(rng, 0.05, 0.5, NCOL, NGPT), rdif, tdif, _f32(rng, 0.0, 5.0, NCOL, NLAY, NGPT),
            _f32(rng, 0.0, 5.0, NCOL, NLAY, NGPT), _f32(rng, 0.0, 5.0, NCOL, NGPT),
            _f32(rng, 0.0, 2.0, NCOL, NGPT))
    ref = jadding(*map(jnp.asarray, arrs), broadband=broadband)
    got = padding(*map(torch.from_numpy, arrs), broadband=broadband)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (NCOL, NLAY + 1) + (() if broadband else (NGPT,))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _lw_2str_case(rng):
    """_lw_case with scattering: two-stream optical properties on the same
    optical depths and sources."""
    (jo, js, ja), (po, ps, pa) = _lw_case(rng)
    ssa, g = _f32(rng, 0.0, 0.9, NCOL, NLAY, NGPT), _f32(rng, 0.0, 0.85, NCOL, NLAY, NGPT)
    return ((jop.OpticalProps2str(ja["tau"], jnp.asarray(ssa), jnp.asarray(g), jo.spectral), js, ja),
            (pop.OpticalProps2str(pa["tau"], torch.from_numpy(ssa), torch.from_numpy(g),
                                  po.spectral), ps, pa))


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("scan_mode", ["sequential", "parallel"])
@pytest.mark.parametrize("solver", ["2stream", "rescaled_1", "rescaled_3", "rescaled_jac"])
def test_rte_lw_2str_matches_jax(rng, solver, scan_mode, top_at_1):
    """rte_lw on two-stream optical properties: the two-stream solver with
    scattering (``use_2stream``) and the Tang-rescaled no-scattering solve
    (1 and 3 angles, with the Jacobian), both scan modes, both
    orientations. A broadband request of the rescaled solve comes back
    spectral, as in the JAX package."""
    (jo, js, ja), (po, ps, pa) = _lw_2str_case(rng)
    kw = {"2stream": dict(use_2stream=True), "rescaled_1": dict(broadband=True),
          "rescaled_3": dict(n_gauss_angles=3), "rescaled_jac": dict(compute_jac=True)}[solver]
    ref, got = (rte.rte_lw(o, top_at_1, src, a["emis"], inc_flux=a["inc"], scan_mode=scan_mode,
                           **kw)
                for rte, o, src, a in ((jrte, jo, js, ja), (prte, po, ps, pa)))
    names = ("flux_up", "flux_dn") + (("flux_up_jac", "flux_dn_jac") if solver == "rescaled_jac"
                                      else ())
    for n in names:
        g, r = getattr(got, n), np.asarray(getattr(ref, n))
        assert tuple(g.shape) == (NCOL, NLAY + 1, NGPT), n
        np.testing.assert_allclose(g.numpy(), r, atol=LW_ATOL, rtol=1e-5, err_msg=n)
    if solver != "rescaled_jac":
        assert got.flux_up_jac is None and got.flux_dn_jac is None
    # scattering moves the answer: not the plain no-scattering solve
    plain = prte.rte_lw(pop.OpticalProps1scl(po.tau, po.spectral), top_at_1, ps, pa["emis"],
                        inc_flux=pa["inc"])
    assert float((got.flux_up - plain.flux_up).abs().max()) > 1e-3


@pytest.mark.parametrize("which", ["lw_two_stream", "lw_source_2str", "lw_solver_2stream"])
def test_lw_two_stream_pieces_match_jax(rng, which):
    """The pieces of the two-stream LW solver, elementwise to rtol 1e-5
    (sources: plus 1e-5 absolute, they are differences of Planck terms)."""
    from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw

    (jo, js, ja), (po, ps, pa) = _lw_2str_case(rng)
    jemis, pemis = jo.spectral.expand(ja["emis"]), po.spectral.expand(pa["emis"])
    jco_, pco_ = jlw.lw_two_stream(jo.tau, jo.ssa, jo.g), plw.lw_two_stream(po.tau, po.ssa, po.g)
    if which == "lw_two_stream":
        ref, got = jco_, pco_
    elif which == "lw_source_2str":
        ref = jlw.lw_source_2str(jemis, ja["sfc"], ja["lay"], ja["lev"], *jco_, jo.tau)
        got = plw.lw_source_2str(pemis, pa["sfc"], pa["lay"], pa["lev"], *pco_, po.tau)
    else:
        ref = jlw.lw_solver_2stream(jo.tau, jo.ssa, jo.g, ja["lay"], ja["lev"], jemis, ja["sfc"])[:2]
        got = plw.lw_solver_2stream(po.tau, po.ssa, po.g, pa["lay"], pa["lev"], pemis, pa["sfc"])[:2]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_lw_two_stream_float32_thin_layer_gap(rng):
    """The known float32 weakness of the two-stream LW source (ROADMAP
    Queue 3, F3): lw_source_2str divides the level-source difference by
    tau * (gamma1 + gamma2) and then cancels it, so layers with 1e-8 < tau
    << 1e-4 lose every digit in float32. Both packages compute the same
    formula and are off the float64 solve by W/m2 there, by the same order;
    with layers of tau >= 1e-3 both are within 2e-3."""
    from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw

    ncol, nlay, ngpt = 4, 12, 64
    lev = rng.uniform(0.5, 1.0, (ncol, nlay + 1, ngpt))
    arrs = dict(ssa=np.full((ncol, nlay, ngpt), 0.3), g=np.full((ncol, nlay, ngpt), 0.5),
                lay=0.5 * (lev[:, 1:] + lev[:, :-1]), lev=lev,
                emis=np.full((ncol, ngpt), 0.97), sfc=rng.uniform(0.9, 1.1, (ncol, ngpt)))
    err = {}
    for tag, lo, hi in (("thin", 1e-7, 1e-5), ("thick", 1e-3, 1.0)):
        tau = np.exp(rng.uniform(np.log(lo), np.log(hi), (ncol, nlay, ngpt)))
        order = ("ssa", "g", "lay", "lev", "emis", "sfc")
        f64 = plw.lw_solver_2stream(torch.from_numpy(tau), *(torch.from_numpy(arrs[k])
                                                             for k in order))
        p32 = plw.lw_solver_2stream(torch.from_numpy(tau).float(),
                                    *(torch.from_numpy(arrs[k]).float() for k in order))
        j32 = jlw.lw_solver_2stream(jnp.asarray(tau, jnp.float32),
                                    *(jnp.asarray(arrs[k], jnp.float32) for k in order))
        bb = lambda a: np.asarray(a, np.float64).sum(-1)
        err[tag] = (np.abs(bb(p32.flux_up.numpy()) - bb(f64.flux_up.numpy())).max(),
                    np.abs(bb(j32.flux_up) - bb(f64.flux_up.numpy())).max())
    assert max(err["thick"]) <= LW_ATOL
    assert min(err["thin"]) > 10 * LW_ATOL  # both packages, not a fault of the port
    assert err["thin"][0] <= 5.0 * err["thin"][1] and err["thin"][1] <= 5.0 * err["thin"][0]


def test_heating_rate_sign_convention_is_the_jax_package_s():
    """A column that loses 200 W/m2 (net downward flux -250 at the top, -50
    at the surface) has a POSITIVE rate in both packages: they compute
    +g/cp d(F_dn - F_up)/dp, where the energy budget (and the reference's
    mo_heating_rates.F90) gives the opposite sign. The port keeps the JAX
    package's convention (ROADMAP Queue 3, F4)."""
    from rte_rrtmgp_nn_tpu.extensions.heating_rates import compute_heating_rate_kday as jhr
    from rte_rrtmgp_nn_tpu_torch.extensions.heating_rates import compute_heating_rate_kday as phr

    plev = np.array([[100.0, 300e2, 700e2, 1000e2]])
    up, dn = np.array([[250.0, 240.0, 220.0, 200.0]]), np.array([[0.0, 30.0, 90.0, 150.0]])
    got = phr(*map(torch.from_numpy, (up, dn, plev))).numpy()
    np.testing.assert_allclose(got, np.asarray(jhr(*map(jnp.asarray, (up, dn, plev)))), rtol=1e-12)
    assert (got > 0).all()


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("compute_jac", [False, True], ids=["fluxes", "jacobian"])
def test_lw_noscat_broadband_from_pfrac_matches_jax(rng, compute_jac, top_at_1):
    """The broadband solve straight from the Planck fraction and band
    Planck values, with per-g-point secants and an incident flux."""
    from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
    from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw

    spec = PSM.create(BANDS_GPT, BANDS_WVN)
    arrs = dict(tau=_f32(rng, 1e-4, 3.0, NCOL, NLAY, NGPT), pf=_f32(rng, 0.0, 0.3, NCOL, NLAY, NGPT),
                b_lay=_f32(rng, 5.0, 20.0, NCOL, NLAY, 2), b_lev=_f32(rng, 5.0, 20.0, NCOL, NLAY + 1, 2),
                b_sfc=_f32(rng, 5.0, 20.0, NCOL, 2), b_jac=_f32(rng, 5.0, 20.0, NCOL, 2),
                emis=_f32(rng, 0.8, 1.0, NCOL, NGPT), inc=_f32(rng, 0.0, 3.0, NCOL, NGPT),
                ds=_f32(rng, 1.2, 2.5, NCOL, NGPT))
    one_hot = jnp.asarray(spec.gpt2band[None, :] == np.arange(2)[:, None], jnp.float32)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    p = {k: torch.from_numpy(v) for k, v in arrs.items()}
    ref = jlw.lw_noscat_broadband_from_pfrac(
        j["tau"], j["pf"], j["b_lay"], j["b_lev"], j["b_sfc"], j["b_jac"], one_hot, j["emis"],
        inc_flux=j["inc"], D=j["ds"], top_at_1=top_at_1, compute_jac=compute_jac)
    got = plw.lw_noscat_broadband_from_pfrac(
        p["tau"], p["pf"], p["b_lay"], p["b_lev"], p["b_sfc"], p["b_jac"],
        spec.gpt2band_tensor("cpu"), p["emis"], inc_flux=p["inc"], D=p["ds"], top_at_1=top_at_1,
        compute_jac=compute_jac)
    for n in ("flux_up", "flux_dn") + (("flux_up_jac",) if compute_jac else ()):
        g = getattr(got, n)
        assert tuple(g.shape) == (NCOL, NLAY + 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, n)), atol=LW_ATOL,
                                   rtol=1e-5, err_msg=n)
    if not compute_jac:
        assert got.flux_up_jac is None
        default = plw.lw_noscat_broadband_from_pfrac(
            p["tau"], p["pf"], p["b_lay"], p["b_lev"], p["b_sfc"], p["b_jac"],
            spec.gpt2band_tensor("cpu"), p["emis"], top_at_1=top_at_1)
        refd = jlw.lw_noscat_broadband_from_pfrac(
            j["tau"], j["pf"], j["b_lay"], j["b_lev"], j["b_sfc"], j["b_jac"], one_hot, j["emis"],
            top_at_1=top_at_1)
        np.testing.assert_allclose(default.flux_up.numpy(), np.asarray(refd.flux_up), atol=LW_ATOL)


@pytest.mark.parametrize("with_dir", [True, False], ids=["with_dir", "without_dir"])
def test_byband_and_bygpoint_reductions_match_jax(rng, with_dir):
    """sum_byband, net_byband, net_broadband_full and reduce_byband against
    the JAX package's (the one-hot contraction there is a sum over each
    band's contiguous g-points here)."""
    jspec, pspec = JSM.create(BANDS_GPT, BANDS_WVN), PSM.create(BANDS_GPT, BANDS_WVN)
    up, dn, dr = (_f32(rng, 0.0, 30.0, NCOL, NLAY + 1, NGPT) for _ in range(3))
    t = torch.from_numpy
    np.testing.assert_allclose(pspec.reduce_sum(t(up)).numpy(), np.asarray(jspec.reduce_sum(jnp.asarray(up))),
                               rtol=1e-6)
    np.testing.assert_allclose(pfl.sum_byband(t(up), pspec).numpy(),
                               np.asarray(jfl.sum_byband(jnp.asarray(up), jspec)), rtol=1e-6)
    np.testing.assert_allclose(pfl.net_broadband_full(t(dn), t(up)).numpy(),
                               np.asarray(jfl.net_broadband_full(jnp.asarray(dn), jnp.asarray(up))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pfl.net_byband(t(dn), t(up)).numpy(),
                                  np.asarray(jfl.net_byband(jnp.asarray(dn), jnp.asarray(up))))
    kw = dict(gpt_flux_dn_dir=dr) if with_dir else {}
    ref = jfl.reduce_byband(jspec, jnp.asarray(up), jnp.asarray(dn),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    got = pfl.reduce_byband(pspec, t(up), t(dn), **{k: t(v) for k, v in kw.items()})
    for n in ("bnd_flux_up", "bnd_flux_dn", "bnd_flux_net", "bnd_flux_dn_dir"):
        g, r = getattr(got, n), getattr(ref, n)
        assert (g is None) == (r is None) == (n == "bnd_flux_dn_dir" and not with_dir), n
        if g is not None:
            assert tuple(g.shape) == (NCOL, NLAY + 1, 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4, err_msg=n)
    for n in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        g, r = getattr(got.broadband, n), getattr(ref.broadband, n)
        assert (g is None) == (r is None), n
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4, err_msg=n)
    no_net = pfl.reduce_byband(pspec, t(up), t(dn), with_net=False)
    assert no_net.bnd_flux_net is None and no_net.broadband.flux_net is None
    by_g = pfl.FluxesBygpoint(t(up), t(dn), t(dn - up))
    assert by_g.gpt_flux_dn_dir is None and tuple(by_g.gpt_flux_net.shape) == (NCOL, NLAY + 1, NGPT)


@pytest.mark.parametrize("broadband", [False, True], ids=["spectral", "broadband"])
def test_parallel_adding_matches_jax_and_sequential(rng, broadband):
    """adding(mode="parallel"): the log-depth slab combination against the
    JAX package's (rtol 1e-5: the products are grouped as there) and
    against the sequential sweeps (rtol 1e-4: another grouping)."""
    from rte_rrtmgp_nn_tpu.ops.adding import adding as jadding
    from rte_rrtmgp_nn_tpu_torch.ops.adding import adding as padding

    for nlay in (NLAY, 8, 1):  # odd, a power of two, a single layer
        rdif, tdif = _f32(rng, 0.0, 0.4, NCOL, nlay, NGPT), _f32(rng, 0.3, 0.6, NCOL, nlay, NGPT)
        arrs = (_f32(rng, 0.05, 0.5, NCOL, NGPT), rdif, tdif, _f32(rng, 0.0, 5.0, NCOL, nlay, NGPT),
                _f32(rng, 0.0, 5.0, NCOL, nlay, NGPT), _f32(rng, 0.0, 5.0, NCOL, NGPT),
                _f32(rng, 0.0, 2.0, NCOL, NGPT))
        ref = jadding(*map(jnp.asarray, arrs), mode="parallel", broadband=broadband)
        got = padding(*map(torch.from_numpy, arrs), mode="parallel", broadband=broadband)
        seq = padding(*map(torch.from_numpy, arrs), broadband=broadband)
        for g, r, s in zip(got, ref, seq):
            assert tuple(g.shape) == (NCOL, nlay + 1) + (() if broadband else (NGPT,))
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="unknown scan mode"):
        padding(*map(torch.from_numpy, arrs), mode="bogus")


@pytest.mark.parametrize("nlay", [1, 2, 5, 8, 13])
def test_parallel_affine_scans_match_jax_and_sequential(rng, nlay):
    """affine_scan / affine_scan_reverse with mode="parallel" against the
    JAX package's associative scans (rtol 1e-5) and against the sequential
    mode, along both axes the solvers use."""
    from rte_rrtmgp_nn_tpu.ops.scan import affine_scan as jscan
    from rte_rrtmgp_nn_tpu.ops.scan import affine_scan_reverse as jscan_rev

    t, s = _f32(rng, 0.0, 1.0, 3, nlay, 4), _f32(rng, 0.0, 1.0, 3, nlay, 4)
    r0 = _f32(rng, 0.0, 1.0, 3, 4)
    tt, ts, tr = map(torch.from_numpy, (t, s, r0))
    for pfn, jfn in ((affine_scan, jscan), (affine_scan_reverse, jscan_rev)):
        got = pfn(tt, ts, tr, mode="parallel")
        ref = jfn(jnp.asarray(t), jnp.asarray(s), jnp.asarray(r0), mode="parallel")
        assert tuple(got.shape) == (3, nlay + 1, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), pfn(tt, ts, tr).numpy(), rtol=1e-5, atol=1e-6)
        lay_major = pfn(tt.transpose(0, 1), ts.transpose(0, 1), tr, axis=0, mode="parallel")
        np.testing.assert_allclose(lay_major.transpose(0, 1).numpy(), got.numpy(), rtol=1e-6)


def test_associative_scan_groups_as_jax(rng):
    """The generic helper under a non-commutative combine (2x2 matrix
    products), forward and reverse: equal to a running product, and to
    jax.lax.associative_scan to float32 rounding."""
    import jax

    from rte_rrtmgp_nn_tpu_torch.ops.scan import associative_scan

    m = _f32(rng, -1.0, 1.0, 11, 3, 4)  # 11 elements of 3 matrices [[a, b], [c, d]]

    def combine(x, y):
        a, b, c, d = x
        e, f, g, h = y
        return a * e + b * g, a * f + b * h, c * e + d * g, c * f + d * h

    for reverse in (False, True):
        got = associative_scan(combine, tuple(torch.from_numpy(m[..., i]) for i in range(4)),
                               axis=0, reverse=reverse)
        ref = jax.lax.associative_scan(combine, tuple(jnp.asarray(m[..., i]) for i in range(4)),
                                       axis=0, reverse=reverse)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
        mats = m.reshape(11, 3, 2, 2).astype(np.float64)
        order = range(10, -1, -1) if reverse else range(11)
        acc, want = None, {}
        for i in order:
            acc = mats[i] if acc is None else acc @ mats[i]
            want[i] = acc
        for i in range(11):
            np.testing.assert_allclose(torch.stack([g[i] for g in got], -1).numpy().reshape(3, 2, 2),
                                       want[i], rtol=1e-4, atol=1e-5)


def test_affine_scans(rng):
    t = torch.from_numpy(_f32(rng, 0.0, 1.0, 3, 5, 4))
    s = torch.from_numpy(_f32(rng, 0.0, 1.0, 3, 5, 4))
    r0 = torch.from_numpy(_f32(rng, 0.0, 1.0, 3, 4))
    fwd, rev = affine_scan(t, s, r0), affine_scan_reverse(t, s, r0)
    assert fwd.shape == rev.shape == (3, 6, 4)
    torch.testing.assert_close(fwd[:, 3], t[:, 2] * fwd[:, 2] + s[:, 2])
    torch.testing.assert_close(rev[:, 1], t[:, 1] * rev[:, 2] + s[:, 1])
    assert torch.equal(fwd[:, 0], r0) and torch.equal(rev[:, -1], r0)
    with pytest.raises(ValueError, match="unknown scan mode"):
        affine_scan(t, s, r0, mode="bogus")
