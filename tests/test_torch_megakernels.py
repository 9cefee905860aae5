"""The plain twins of the port's fused kernels against the JAX package's
Pallas kernels run in interpret mode, on the same inputs: K1
(lw_clearsky_mega4) to 2e-3 W/m2 and K2 (sw_clearsky_megakernel) to 2e-2
W/m2, the JAX package's own kernel-vs-staged bounds, clear-sky, in both
cloud modes (lookup tables inside the kernel; band lanes) and in the lane
input modes (K8 lw_clearsky_mega5 on raw lanes, K9 input_mode="lanes"). The
column count is not a multiple of the Pallas tile, and the SW columns
include night ones.

The CUDA kernels themselves are tested on the card by
test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.ops.pallas.lw_megakernel import lw_clearsky_mega4 as jax_lw_mega4
from rte_rrtmgp_nn_tpu.ops.pallas.sw_megakernel import sw_clearsky_megakernel as jax_sw_mega
from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, SW_MODEL, model_pair, rfmip_pair

NCOL, NLAY = 13, 8
LW_ATOL, SW_ATOL = 2e-3, 2e-2


def _lw_case(device, ncol=NCOL, nlay=NLAY, seed=11):
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    _, data = rfmip_pair(synthesize_rfmip(ncol, nlay, seed))
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=device)
    model = load_model_netcdf(LW_MODEL, device=device)
    return fused.lw_args([model], table, spec, *rfmip.lw_canonical_inputs(data, spec, device))[0]


def _sw_case(device, ncol=NCOL, nlay=NLAY, seed=12):
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    d = synthesize_rfmip(ncol, nlay, seed)
    _, data = rfmip_pair(d)
    spec = pplanck.sw_spectral_g112()
    model = load_model_netcdf(SW_MODEL, device=device)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32, device=device)
    sw_in = rfmip.sw_canonical_inputs(data, device)
    return fused.sw_args([model, model], None, *rfmip.sw_fused_inputs(solar, *sw_in))[0], sw_in, d


def test_lw_twin_matches_jax_kernel():
    args = _lw_case(CPU)
    (_, x2d, cf, w1a, w1c, col_dry, tlay, tlev, tsfc, table, g2b, emis) = args
    jm, _ = model_pair(LW_MODEL)
    spec = jplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(spec.band_lims_wvn_array, dtype=jnp.float32)
    one_hot = jnp.asarray(spec.gpt2band[None, :] == np.arange(spec.nband)[:, None], jnp.float32)
    j = lambda t: jnp.asarray(t.numpy())
    lanes = [j(x2d[..., i]) for i in range(x2d.shape[-1])]
    ref_up, ref_dn = jax_lw_mega4(jm, lanes, j(cf), j(w1a), j(w1c), j(col_dry), j(tlay),
                                  j(tlev), j(tsfc), jt, one_hot, j(emis), tile_c=8,
                                  interpret=True)
    up, dn = k1.lw_clearsky_mega4_plain(*args)
    assert tuple(up.shape) == (NCOL, NLAY + 1)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up), atol=LW_ATOL)
    np.testing.assert_allclose(dn.numpy(), np.asarray(ref_dn), atol=LW_ATOL)
    assert cf.shape[1] == 9  # the missing gases ride the const block


def test_sw_twin_matches_jax_kernel():
    args, sw_in, d = _sw_case(CPU)
    (_, _, x2d, cf, perm, col_dry, mu0, inc, alb_dir, alb_dif) = args
    night = d["sza"] >= 90.0
    assert night.any() and not night.all()
    js, _ = model_pair(SW_MODEL)
    j = lambda t: jnp.asarray(t.numpy())
    lanes = [j(x2d[..., i]) for i in range(x2d.shape[-1])]
    ref = jax_sw_mega(js, js, lanes, j(col_dry), j(mu0), j(inc), j(alb_dir), j(alb_dif),
                      tile_c=8, interpret=True, const_feats=j(cf), perm=perm)
    got = k2.sw_clearsky_megakernel_plain(*args)
    for name, g, r in zip(("up", "dn", "dn_dir"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SW_ATOL, err_msg=name)
    # the core zeroes the night columns exactly
    spec = pplanck.sw_spectral_g112()
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32)
    fb = rfmip._sw_core_mega_canon([args[0], args[1]], solar, *sw_in, top_at_1=True)
    for name in ("flux_up", "flux_dn", "flux_net", "flux_dn_dir"):
        assert (getattr(fb, name).numpy()[night] == 0.0).all(), name
    assert (fb.flux_dn.numpy()[~night, 0] > 0.0).all()


def test_wrappers_run_the_twins_on_cpu():
    """CPU tensors take the plain twin (bit-identical) and launch nothing."""
    before = (k1.LAUNCHES, k2.LAUNCHES)
    args = _lw_case(CPU, ncol=5, nlay=4)
    for a, b in zip(k1.lw_clearsky_mega4(*args), k1.lw_clearsky_mega4_plain(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    sargs, _, _ = _sw_case(CPU, ncol=5, nlay=4)
    for a, b in zip(k2.sw_clearsky_megakernel(*sargs), k2.sw_clearsky_megakernel_plain(*sargs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (k1.LAUNCHES, k2.LAUNCHES) == before


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA raises: nothing falls back."""
    args = list(_lw_case(CPU, ncol=3, nlay=4))
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.lw_clearsky_mega4(*args)
    sargs, _, _ = _sw_case(CPU, ncol=3, nlay=4)
    sargs = list(sargs)
    sargs[2] = sargs[2].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.sw_clearsky_megakernel(*sargs)


def _resonance_case(spread):
    """SW kernel arguments with mu0 within +-spread of the resonance, the
    twin's output and the float64 twin's. ssa is 0.5 everywhere when one net
    stands in for both SW nets, which puts k*mu0 = 1 at mu0 = 1/sqrt(1.75)
    (sza ~41 deg) in every layer."""
    from rte_rrtmgp_nn_tpu_torch.models.network import NNModel

    args, _, _ = _sw_case(CPU, ncol=6, nlay=20, seed=3)
    args = list(args)
    args[6] = (1.0 / np.sqrt(1.75) + torch.linspace(-spread, spread, 6)).float()
    got = k2.sw_clearsky_megakernel_plain(*args)
    m = args[0]
    m64 = NNModel([w.double() for w in m.weights], [b.double() for b in m.biases],
                  m.activations, m.input_names, m.input_min.double(), m.input_max.double(),
                  m.output_mean.double(), m.output_std.double())
    a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    a64[0] = a64[1] = m64
    return args, got, k2.sw_clearsky_megakernel_plain(*a64)


def test_sw_twin_resonance_is_float64_accurate():
    """At the resonance float32 two-stream coefficients lose up to ~10
    W/m2. The twin evaluates them in float64 and stays within 1e-3 W/m2 of
    a float64 run there."""
    _, got, ref = _resonance_case(2e-3)
    for g, r in zip(got, ref):
        assert float((g.double() - r).abs().max()) < 1e-3


def test_sw_resonance_gap_to_jax_kernel():
    """The known gap to the JAX kernel at the resonance (ROADMAP Queue 3,
    F1): the Pallas kernel computes the coefficients in float32 and is off
    the float64 run by more than the 2e-2 W/m2 bound there, while the twin
    (float64 coefficients) is within 1e-3. The whole gap between the two is
    the JAX kernel's own float32 error, and the direct beam, which does not
    use the coefficients, still agrees to the bound."""
    args, got, ref = _resonance_case(2e-4)
    (_, _, x2d, cf, perm, col_dry, mu0, inc, alb_dir, alb_dif) = args
    js, _ = model_pair(SW_MODEL)
    j = lambda t: jnp.asarray(t.numpy())
    lanes = [j(x2d[..., i]) for i in range(x2d.shape[-1])]
    jax_out = jax_sw_mega(js, js, lanes, j(col_dry), j(mu0), j(inc), j(alb_dir), j(alb_dif),
                          tile_c=8, interpret=True, const_feats=j(cf), perm=perm)
    err = lambda a, b: float((a.double() - b.double()).abs().max())
    for name, g, q, r in zip(("up", "dn", "dn_dir"), got, jax_out, ref):
        q = torch.from_numpy(np.array(q))
        port_err, jax_err, gap = err(g, r), err(q, r), err(g, q)
        assert port_err < 1e-3, name
        assert gap <= jax_err + 1e-3, name
        if name == "dn_dir":
            assert gap <= SW_ATOL
        else:
            assert jax_err > SW_ATOL, name


def test_ctypes_declarations_match_the_c_entry_points():
    """build._declare gives every extern "C" function of csrc/*.cu the
    ctypes types of its C parameters (a pointer declared as an int would be
    cut to 32 bits), so the library binds as written without a compiler."""
    import ctypes
    import re
    import types

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    sigs = {}
    for src in build._sources():
        text = src.read_text()
        for ret, name, params in re.findall(r'extern "C"\s+([\w\s\*]+?)\s*(\w+)\(([^)]*)\)', text):
            types_ = []
            for p in params.split(","):
                p = p.strip()
                types_.append(kinds["ptr" if "*" in p else p.split()[0]])
            sigs[name] = (ret.strip(), types_)
    assert set(sigs) == {"lw_clearsky_mega4_launch", "sw_clearsky_megakernel_launch",
                         "lw_clearsky_mega4_blocks_per_sm",
                         "sw_clearsky_megakernel_blocks_per_sm", "lw_prep_launch",
                         "lw_prep_blocks_per_sm", "mlp_predict_launch",
                         "mlp_predict_blocks_per_sm", "lw_noscat_broadband_launch",
                         "lw_noscat_broadband_blocks_per_sm", "lut_gas_optics_launch",
                         "sw_2stream_launch", "rte_cuda_error_string"}
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in sigs})
    build._declare(lib)
    restypes = {"int": ctypes.c_int, "size_t": ctypes.c_size_t, "const char*": ctypes.c_char_p}
    for name, (ret, argtypes) in sigs.items():
        fn = getattr(lib, name)
        assert list(fn.argtypes) == argtypes, name
        assert fn.restype is restypes[ret], name


def _c_struct_fields(name):
    """[(field, ctypes type)] of ``struct name`` as csrc/ declares it."""
    import ctypes
    import re

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    text = "".join(p.read_text() for p in sorted(build.CSRC_DIR.glob("*.cu*")))
    (body,) = re.findall(r"struct %s \{(.*?)\n\};" % name, text, re.S)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if not decl.strip():
            continue
        base, star, names = re.fullmatch(r"(?:const\s+)?(float|int|double)(\*?)\s+(.*)",
                                         decl.strip(), re.S).groups()
        ctype = ctypes.c_void_p if star else {"float": ctypes.c_float, "int": ctypes.c_int,
                                              "double": ctypes.c_double}[base]
        sizes = {"kMaxLanes": build.MAX_LANES, "kMaxLayers": build.MAX_LAYERS,
                 "kMaxDims": build.MAX_LAYERS + 1, "kMaxAngles": build.MAX_ANGLES}
        for n in names.split(","):
            n, _, size = n.strip().rstrip("]").partition("[")
            fields.append((n, ctype * sizes[size]) if size else (n, ctype))
    return fields


@pytest.mark.parametrize("name", ["Mlp3", "PlanckTab", "CloudLut", "LaneList", "LwArgs", "SwArgs",
                                  "LwPrepArgs", "MegaPlan", "MlpNet", "MlpPlan", "NoscatArgs",
                                  "NoscatPlan", "LutArgs", "Sw2StreamArgs"])
def test_ctypes_structs_mirror_the_c_structs(name):
    """The fused kernels' launch entries read their arguments from structs;
    build.py's ctypes mirror of each has the C declaration's fields, in its
    order and with its types, so a wrapper that fills a field by name fills
    the field the kernel reads."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    want = _c_struct_fields(name)
    assert len(want) >= 2
    assert list(getattr(build, name)._fields_) == want


def test_ctypes_struct_helpers_fill_by_name():
    """mlp3 and lane_list put each tensor's address and each width into the
    field of that name."""
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    m = load_model_netcdf(LW_MODEL, device=CPU)
    w1a, w1c = m.weights[0][:5].contiguous(), m.weights[0][5:].contiguous()
    net = build.mlp3(w1a, w1c, m)
    assert (net.w1a, net.w1c, net.w2, net.b3, net.ostd) == (
        w1a.data_ptr(), w1c.data_ptr(), m.weights[1].data_ptr(), m.biases[2].data_ptr(),
        m.output_std.data_ptr())
    assert (net.h1, net.h2, net.nout) == (128, 128, 256)
    lanes = [torch.zeros(3), torch.ones(3)]
    ll = build.lane_list(lanes, (2, 1))
    assert (ll.p[0], ll.p[1], ll.p[2]) == (lanes[0].data_ptr(), lanes[1].data_ptr(), None)
    assert list(ll.code[:3]) == [2, 1, 0]
    assert list(build.lane_list(lanes).code[:2]) == [0, 0]



# -- the cloud modes of K1 and K2 ------------------------------------------------------

def _one_hot(spec):
    return jnp.asarray(spec.gpt2band[None, :] == np.arange(spec.nband)[:, None], jnp.float32)


def _cloud_case(tmp_path, which, flavour, ncol=NCOL, nlay=NLAY, seed=13):
    """(JAX cloud optics, port cloud optics, the four (nlay, ncol) cloud
    fields, the synthesized atmosphere) with the all-sky driver's cloud
    placement; a few columns hold liquid, ice and mixed cells."""
    from rte_rrtmgp_nn_tpu_torch.drivers.allsky import cloud_fields_lay_major
    from test_torch_cloud_optics import cloud_optics_pair

    jco_, pco_ = cloud_optics_pair(tmp_path, which, seed, flavour)
    d = synthesize_rfmip(ncol, nlay, seed)
    cld = cloud_fields_lay_major(d["play"], d["tlay"], pco_, True, CPU)
    assert float((cld[0] > 0).float().mean()) > 0.02 and float((cld[1] > 0).float().mean()) > 0.02
    return jco_, pco_, cld, d


@pytest.mark.parametrize("flavour", ["lut", "pade"])
def test_lw_twin_cloud_modes_match_jax_kernel(tmp_path, flavour):
    """K1's twin with lookup-table cloud optics (the four cloud fields, the
    table interpolation in the kernel) and with Pade cloud optics (band
    lanes of absorption tau) against the Pallas kernel's cld_fields +
    cld_lut and cld_tau_band options; the clouds move the fluxes."""
    from rte_rrtmgp_nn_tpu.ops.pallas.lw_megakernel import cloud_lut_pack as jax_lut_pack
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    jco_, pco_, cld, d = _cloud_case(tmp_path, "lw", flavour)
    _, data = rfmip_pair(d)
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    lw_in = rfmip.lw_canonical_inputs(data, spec, CPU)
    args, kw = fused.lw_args([load_model_netcdf(LW_MODEL, device=CPU)], table, spec, *lw_in,
                             (pco_, cld))
    assert set(kw) == ({"cld_fields", "cld_lut"} if flavour == "lut" else {"cld_tau_band"})
    (_, x2d, cf, w1a, w1c, col_dry, tlay, tlev, tsfc, _, _, emis) = args
    jm, _ = model_pair(LW_MODEL)
    jspec = jplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(jspec.band_lims_wvn_array, dtype=jnp.float32)
    j = lambda t: jnp.asarray(t.numpy())
    lanes = [j(x2d[..., i]) for i in range(x2d.shape[-1])]
    if flavour == "lut":
        jkw = dict(cld_fields=tuple(j(c) for c in cld), cld_lut=jax_lut_pack(jco_))
    else:
        jkw = dict(cld_tau_band=j(kw["cld_tau_band"]))
    ref_up, ref_dn = jax_lw_mega4(jm, lanes, j(cf), j(w1a), j(w1c), j(col_dry), j(tlay),
                                  j(tlev), j(tsfc), jt, _one_hot(jspec), j(emis), tile_c=8,
                                  interpret=True, **jkw)
    up, dn = k1.lw_clearsky_mega4_plain(*args, **kw)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref_up), atol=LW_ATOL)
    np.testing.assert_allclose(dn.numpy(), np.asarray(ref_dn), atol=LW_ATOL)
    _, clear_dn = k1.lw_clearsky_mega4_plain(*args)
    assert float((dn - clear_dn).abs().max()) > 1.0
    # the wrapper takes the same twin on CPU tensors
    for a, b in zip(k1.lw_clearsky_mega4(*args, **kw), (up, dn)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("flavour", ["lut", "pade"])
def test_sw_twin_cloud_modes_match_jax_kernel(tmp_path, flavour):
    """K2's twin with lookup-table cloud optics (delta scaling in the
    subtraction form, in the kernel) and with Pade cloud optics (band lanes
    of the classic delta_scale chain's products) against the Pallas
    kernel's cld_fields + cld_lut and cld_bands options, with the all-sky
    driver's mu0 = 0.86 and albedo 0.06."""
    from rte_rrtmgp_nn_tpu.ops.pallas.lw_megakernel import cloud_lut_pack as jax_lut_pack
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    jco_, pco_, cld, d = _cloud_case(tmp_path, "sw", flavour, seed=14)
    _, data = rfmip_pair(d)
    spec = pplanck.sw_spectral_g112()
    model = load_model_netcdf(SW_MODEL, device=CPU)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32)
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = rfmip.sw_canonical_inputs(data, CPU)
    mu0, alb = torch.full((NCOL,), 0.86), torch.full((NCOL, spec.nband), 0.06)
    args, kw = fused.sw_args([model, model], spec, play_t, plev_t, tlay_t, mu0,
                             *fused.sw_boundary(spec, solar, alb, alb), concs_t, (pco_, cld))
    assert set(kw) == {"gpt2band"} | ({"cld_fields", "cld_lut"} if flavour == "lut"
                                      else {"cld_bands"})
    (_, _, x2d, cf, perm, col_dry, _, inc, alb_dir, alb_dif) = args
    js, _ = model_pair(SW_MODEL)
    j = lambda t: jnp.asarray(t.numpy())
    lanes = [j(x2d[..., i]) for i in range(x2d.shape[-1])]
    if flavour == "lut":
        jkw = dict(cld_fields=tuple(j(c) for c in cld), cld_lut=jax_lut_pack(jco_))
    else:
        jkw = dict(cld_bands=tuple(j(c) for c in kw["cld_bands"]))
    ref = jax_sw_mega(js, js, lanes, j(col_dry), j(mu0), j(inc), j(alb_dir), j(alb_dif),
                      tile_c=8, interpret=True, const_feats=j(cf), perm=perm,
                      one_hot=_one_hot(jplanck.sw_spectral_g112()), **jkw)
    got = k2.sw_clearsky_megakernel_plain(*args, **kw)
    for name, g, r in zip(("up", "dn", "dn_dir"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SW_ATOL, err_msg=name)
    clear = k2.sw_clearsky_megakernel_plain(*args)
    assert float((got[2] - clear[2]).abs().max()) > 1.0
    for a, b in zip(k2.sw_clearsky_megakernel(*args, **kw), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sw_twin_delta_scalings_agree(tmp_path):
    """The lookup-table mode delta-scales in the subtraction form inside
    the kernel, the band mode takes the classic chain of delta_scale from
    outside: on the same tables the two differ by float32 rounding only."""
    from rte_rrtmgp_nn_tpu_torch.extensions.cloud_optics import cloud_optics
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.optical_props import delta_scale

    _, pco_, cld, d = _cloud_case(tmp_path, "sw", "lut", seed=15)
    _, data = rfmip_pair(d)
    spec = pplanck.sw_spectral_g112()
    model = load_model_netcdf(SW_MODEL, device=CPU)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32)
    play_t, plev_t, tlay_t, _, _, _, _, concs_t = rfmip.sw_canonical_inputs(data, CPU)
    mu0, alb = torch.full((NCOL,), 0.86), torch.full((NCOL, spec.nband), 0.06)
    args, kw = fused.sw_args([model, model], spec, play_t, plev_t, tlay_t, mu0,
                             *fused.sw_boundary(spec, solar, alb, alb), concs_t, (pco_, cld))
    c = delta_scale(cloud_optics(pco_, *cld, as_2str=True))
    ts = c.tau * c.ssa
    in_kernel = k2.sw_clearsky_megakernel_plain(*args, **kw)
    outside = k2.sw_clearsky_megakernel_plain(*args, gpt2band=kw["gpt2band"],
                                              cld_bands=(c.tau, ts, ts * c.g))
    for a, b in zip(in_kernel, outside):
        assert float((a - b).abs().max()) <= 2e-3  # W/m2, a tenth of the SW bound


# -- the lane input modes: K8 (raw lanes into K1) and K9 (lanes into K2) ------------------

@pytest.mark.parametrize("top_at_1", [True, False])
def test_lw_raw_lane_twin_matches_jax_core(top_at_1):
    """The port's raw-lane cores (lw_clearsky_mega5's twin on CPU tensors)
    against the JAX package's _lw_core_mega5_canon (the Pallas mega5 kernel
    in interpret mode), and against the port's stacked-input core."""
    from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip

    jd, pd = rfmip_pair(synthesize_rfmip(NCOL, NLAY, seed=16, top_at_1=top_at_1))
    jm, pm = model_pair(LW_MODEL)
    jspec, pspec = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(jspec.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(pspec.band_lims_wvn_array, device=CPU)
    lw_in = rfmip.lw_canonical_inputs(pd, pspec, CPU)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jrfmip._lw_core_mega5_canon(
        [jm], jt, jspec, *(j(a) for a in lw_in[:6]), {k: j(v) for k, v in lw_in[6].items()},
        top_at_1=top_at_1, tile_c=8)
    got = rfmip._lw_core_mega5_canon([pm], pt, pspec, *lw_in, top_at_1=top_at_1)
    col = rfmip._lw_core_mega5([pm], pt, pspec, *rfmip.lw_staged_inputs(pd, pspec, CPU),
                               top_at_1=top_at_1)
    stacked = fused.lw_core([pm], pt, pspec, *lw_in, top_at_1=top_at_1)
    for n in ("flux_up", "flux_dn", "flux_net"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=LW_ATOL, err_msg=n)
        np.testing.assert_allclose(getattr(col, n).numpy(), getattr(got, n).numpy(), atol=1e-4)
        np.testing.assert_allclose(getattr(stacked, n).numpy(), getattr(got, n).numpy(),
                                   atol=LW_ATOL)
    args = rfmip.lw_mega5_args([pm], pt, pspec, *lw_in)
    assert args[2][:4] == (0, 1, 2, 2) and tuple(args[3].shape) == (2, len(args[1]))
    with pytest.raises(ValueError, match="first 2-D lane"):
        names = list(pm.input_names)
        names[0], names[1] = names[1], names[0]
        rfmip.lw_mega5_args([type(pm)(pm.weights, pm.biases, pm.activations, tuple(names),
                                      pm.input_min, pm.input_max, pm.output_mean,
                                      pm.output_std)], pt, pspec, *lw_in)


def test_sw_lane_input_mode_matches_jax_kernel():
    """K9: the twin with one array per feature against the Pallas kernel's
    input_mode="lanes"; bit-identical to the stacked input; clouds and a
    stacked tensor are refused in this mode, as the JAX kernel refuses
    them."""
    args, _, _ = _sw_case(CPU)
    (ma, mr, x2d, cf, perm, col_dry, mu0, inc, alb_dir, alb_dif) = args
    lanes = [l.contiguous() for l in x2d.unbind(-1)]
    js, _ = model_pair(SW_MODEL)
    j = lambda t: jnp.asarray(t.numpy())
    ref = jax_sw_mega(js, js, [j(l) for l in lanes], j(col_dry), j(mu0), j(inc), j(alb_dir),
                      j(alb_dif), tile_c=8, interpret=True, const_feats=j(cf), perm=perm,
                      input_mode="lanes")
    largs = (ma, mr, lanes) + tuple(args[3:])
    got = k2.sw_clearsky_megakernel(*largs, input_mode="lanes")
    for name, g, r, st in zip(("up", "dn", "dn_dir"), got, ref,
                              k2.sw_clearsky_megakernel_plain(*args)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SW_ATOL, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), st.numpy())
    with pytest.raises(ValueError, match="clear-sky lane list"):
        k2.sw_clearsky_megakernel(*args, input_mode="lanes")
    with pytest.raises(ValueError, match="clear-sky lane list"):
        k2.sw_clearsky_megakernel(*largs, input_mode="lanes", gpt2band=torch.zeros(112),
                                  cld_bands=(col_dry,) * 3)
    with pytest.raises(ValueError, match="input_mode"):
        k2.sw_clearsky_megakernel(*args, input_mode="refs")


def test_cloud_and_lane_wrappers_refuse_other_devices(tmp_path):
    """Every mode's wrapper raises for a tensor on neither the CPU nor CUDA
    and launches nothing: no mode falls back."""
    before = (k1.LAUNCHES, k2.LAUNCHES, dict(k1.MODE_LAUNCHES), dict(k2.MODE_LAUNCHES))
    args = list(_lw_case(CPU, ncol=3, nlay=4))
    args[1] = args[1].to("meta")
    band = torch.zeros((4, 3, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        k1.lw_clearsky_mega4(*args, cld_tau_band=band)
    with pytest.raises(ValueError, match="requires cld_lut"):
        k1.lw_clearsky_mega4(*args, cld_fields=(band,) * 4)
    _, pd = rfmip_pair(synthesize_rfmip(3, 4, seed=17))
    spec = pplanck.lw_spectral_g128()
    table = pplanck.PlanckTable.compute(spec.band_lims_wvn_array, device=CPU)
    a5 = list(rfmip.lw_mega5_args([args[0]], table, spec, *rfmip.lw_canonical_inputs(pd, spec, CPU)))
    a5[1] = [l.to("meta") for l in a5[1]]
    with pytest.raises(ValueError, match="unsupported device"):
        k1.lw_clearsky_mega5(*a5)
    sargs, _, _ = _sw_case(CPU, ncol=3, nlay=4)
    sargs = list(sargs)
    with pytest.raises(ValueError, match="require gpt2band"):
        k2.sw_clearsky_megakernel(*sargs, cld_bands=(band,) * 3)
    sargs[2] = [l.to("meta") for l in sargs[2].unbind(-1)]
    with pytest.raises(ValueError, match="unsupported device"):
        k2.sw_clearsky_megakernel(*sargs, input_mode="lanes")
    assert before == (k1.LAUNCHES, k2.LAUNCHES, k1.MODE_LAUNCHES, k2.MODE_LAUNCHES)


# -- the fused kernels' launch geometry -----------------------------------------------------

PLAN_SIZES = [(60, 128), (60, 112), (13, 100), (61, 128), (1, 8)]
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90


def _plan(kernel, nlay, ngpt, **kw):
    """The LW kernel's plan for the g-128 demo net's widths (18 -> 128 -> 128)
    or the SW kernel's for the g-112 demo nets' (7 -> 48 -> 48)."""
    if kernel == "lw":
        return k1.launch_plan(nlay, 18, 128, 128, ngpt, **kw)
    return k2.launch_plan(nlay, 7, 48, 48, ngpt, **kw)


@pytest.mark.parametrize("nlay,ngpt", PLAN_SIZES)
@pytest.mark.parametrize("kernel", ["lw", "sw"])
def test_launch_plan_covers_every_layer_once(kernel, nlay, ngpt):
    """The layer groups of a plan are contiguous, cover every layer exactly
    once, and the geometry is one the card can launch: whole groups of 128
    threads, at most 1024 threads, shared memory within the 227 KB of sm_90,
    and (the kernel's compile-time constant) 16 layers per MLP pass."""
    plan = _plan(kernel, nlay, ngpt)
    covered = []
    for grp in range(plan.groups):
        lbeg = min(grp * plan.layers_per_group, nlay)
        covered += range(lbeg, min(lbeg + plan.layers_per_group, nlay))
    assert covered == list(range(nlay))
    assert plan.groups in (1, 2, 4) and plan.groups <= max(nlay, 1)
    assert plan.threads == 128 * plan.groups <= 1024
    assert plan.rows_per_pass == k1.ROWS_PER_PASS == 16
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # the LW kernel streams its weights through two slabs of whole rows of
    # its widest layer, in 16-byte pieces; the SW kernel reads them cached
    if kernel == "lw":
        assert plan.slab_floats % 4 == 0 and plan.slab_floats >= 4 * max(128, 2 * ngpt)
    else:
        assert plan.slab_floats == 0


@pytest.mark.parametrize("kernel", ["lw", "sw"])
def test_launch_plan_shared_memory_is_the_sum_of_the_kernel_s_regions(kernel):
    """The plan's bytes are what the kernel lays out (the launch entry
    recomputes them and refuses a plan that differs): per group the k-major
    MLP scratch with 20 floats per k, the constant features' share of the
    first layer, the weights' two slabs, the column's per-layer scalars and
    the per-layer fields."""
    nlay, ngpt, stride = 60, 112, k1.ROWS_PER_PASS + k1.ROW_PAD
    plan = _plan(kernel, nlay, ngpt)
    if kernel == "lw":
        floats = (plan.groups * stride * (18 + 128 + 128) + 128 + 2 * plan.slab_floats
                  + ((7 * nlay + 1 + 3) & ~3) + 3 * nlay * ngpt + ngpt)
    else:
        floats = (plan.groups * stride * (7 + 4 * 48) + 2 * 48 + 5 * nlay
                  + 5 * nlay * ngpt + 3 * ngpt + nlay + 1)
    assert plan.smem_bytes == 4 * floats
    assert tuple(plan) == tuple(_plan(kernel, nlay, ngpt, smem_limit=SMEM_LIMIT))


def test_launch_plan_takes_fewer_groups_when_the_scratch_is_wide():
    """Four groups' scratch of two 128-wide SW nets does not fit beside the
    fields of 60 x 56: the plan takes two groups of 30 layers (two MLP
    passes each) instead of refusing; an unequal pair of nets counts each
    net's widths."""
    plan = k2.launch_plan(60, 7, 128, 128, 56)
    assert (plan.groups, plan.threads, plan.layers_per_group) == (2, 256, 30)
    assert plan.smem_bytes <= SMEM_LIMIT < k2.launch_plan(60, 7, 128, 128, 56,
                                                          smem_limit=10**6).smem_bytes
    mixed = k2.launch_plan(60, 7, (48, 128), (48, 128), 56)
    assert mixed.groups == 4
    assert k2.launch_plan(60, 7, 48, 48, 56).smem_bytes < mixed.smem_bytes <= SMEM_LIMIT
    # a smaller card limit costs the weights' slabs their size, then groups,
    # then raises
    assert _plan("lw", 60, 128, smem_limit=200_000).slab_floats < _plan("lw", 60, 128).slab_floats
    assert _plan("lw", 60, 128, smem_limit=180_000).groups == 2
    with pytest.raises(ValueError, match="shared memory"):
        _plan("lw", 60, 128, smem_limit=100_000)


@pytest.mark.parametrize("kernel", ["lw", "sw"])
@pytest.mark.parametrize("case,match", [
    (dict(nlay=400, ngpt=128), "too many layers"),
    (dict(nlay=60, ngpt=129), "ngpt 129 > 128"),
    (dict(nlay=60, ngpt=112, wide=2048), "net is too wide"),
    (dict(nlay=0, ngpt=112), "must be positive"),
])
def test_launch_plan_refuses_in_words(kernel, case, match):
    """What does not fit is refused with the reason: the fields of too many
    layers, more g-points than a group has threads, a net so wide that its
    scratch no longer fits beside the fields."""
    wide = case.get("wide")
    with pytest.raises(ValueError, match=match):
        if kernel == "lw":
            k1.launch_plan(case["nlay"], 18, wide or 128, wide or 128, case["ngpt"])
        else:
            k2.launch_plan(case["nlay"], 7, wide or 48, wide or 48, case["ngpt"])


def test_mega_plan_struct_takes_the_plan_field_by_field():
    """build.MegaPlan(*plan) fills the C struct's fields in the named
    tuple's order."""
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    plan = k1.launch_plan(60, 18, 128, 128, 128)
    c = build.MegaPlan(*plan)
    assert [n for n, _ in build.MegaPlan._fields_] == list(plan._fields)
    assert all(getattr(c, n) == v for n, v in plan._asdict().items())


@pytest.mark.parametrize("mode", ["clear", "cld_lut", "cld_bands", "lanes"])
def test_wrappers_off_the_cpu_reach_the_launch_in_every_mode(monkeypatch, mode):
    """A tensor that is not on the CPU takes the kernel's launch, in the mode
    the arguments select, and never a plain twin (each twin raises here)."""
    calls = []

    def twin(*a, **k):
        raise AssertionError("a plain twin ran for a tensor that is not on the CPU")

    for mod in (k1, k2):
        monkeypatch.setattr(mod, "_launch", lambda m, *a, _mod=mod.__name__, **k: calls.append((_mod, m)) or ())
    for name in ("lw_clearsky_mega4_plain", "lw_clearsky_mega5_plain"):
        monkeypatch.setattr(k1, name, twin)
    monkeypatch.setattr(k2, "sw_clearsky_megakernel_plain", twin)
    args = list(_lw_case(CPU, ncol=3, nlay=4))
    sargs = list(_sw_case(CPU, ncol=3, nlay=4)[0])
    x, sx = args[1].to("meta"), sargs[2].to("meta")
    band = torch.zeros((4, 3, 16), device="meta")
    lut = (band, band, (0.0, 1.0, 0.0, 1.0))
    if mode == "lanes":
        k1.lw_clearsky_mega5(args[0], list(x.unbind(-1)), (0,) * 9, None, *args[2:5], args[5],
                             *args[7:])
        sargs[2] = list(sx.unbind(-1))
        k2.sw_clearsky_megakernel(*sargs, input_mode="lanes")
    else:
        kw = {"clear": {}, "cld_bands": dict(cld_tau_band=band),
              "cld_lut": dict(cld_fields=(band,) * 4, cld_lut=lut)}[mode]
        k1.lw_clearsky_mega4(args[0], x, *args[2:], **kw)
        skw = {"clear": {}, "cld_bands": dict(cld_bands=(band,) * 3, gpt2band=band),
               "cld_lut": dict(cld_fields=(band,) * 4, cld_lut=lut, gpt2band=band)}[mode]
        sargs[2] = sx
        k2.sw_clearsky_megakernel(*sargs, **skw)
    assert calls == [(k1.__name__, mode), (k2.__name__, mode)]


@pytest.mark.parametrize("constant,value", [
    ("kGroup", k1.GROUP_THREADS), ("kMaxGroups", k1.MAX_GROUPS), ("kMegaRows", k1.ROWS_PER_PASS),
    ("kRowPad", k1.ROW_PAD), ("kMaxSmem", k1.MAX_SMEM),
])
def test_plan_constants_mirror_the_c_header(constant, value):
    """launch_plan reckons with the constants the kernels are compiled with
    (csrc/common.cuh)."""
    import re

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build

    text = (build.CSRC_DIR / "common.cuh").read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", text)
    assert found == [str(value)]


@pytest.mark.parametrize("entry", ["lw_clearsky_mega4", "sw_clearsky_megakernel", "lw_prep",
                                   "mlp_predict"])
def test_blocks_per_sm_asks_the_library(monkeypatch, entry):
    """build.blocks_per_sm hands the plan (as the entry's plan struct), the
    mode and the device to the kernel's occupancy entry and returns the
    count that entry wrote; a CUDA error raises."""
    import types

    from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import mlp

    plan = (mlp.mlp_launch_plan((18, 128, 128, 256)) if entry == "mlp_predict"
            else k1.launch_plan(60, 18, 128, 128, 128))
    seen = []

    def occupancy(plan_ref, mode, device, blocks_ref):
        seen.append((plan_ref._obj.threads, plan_ref._obj.smem_bytes, mode, device))
        blocks_ref._obj.value = 1
        return 0 if mode < 4 else 1

    lib = types.SimpleNamespace(**{f"{entry}_blocks_per_sm": occupancy},
                                rte_cuda_error_string=lambda err: b"invalid argument")
    monkeypatch.setattr(build, "_lib", lib)
    assert build.blocks_per_sm(entry, plan, 2, 0) == 1
    assert seen == [(plan.threads, plan.smem_bytes, 2, 0)]
    with pytest.raises(RuntimeError, match="occupancy: CUDA error 1"):
        build.blocks_per_sm(entry, plan, 4, 0)


def test_split_first_layer_is_made_once_and_kept_with_the_model():
    """The first-layer split is made once per (permutation, n2d) and kept
    with the model: a fused-kernel call then copies no index from the host
    (which would make it wait for the card) and gathers nothing. The rows
    are the weight's in the permutation's order."""
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as g
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    model = load_model_netcdf(SW_MODEL, device=CPU)
    perm = [3, 0, 6, 2, 5, 1, 4]
    w1a, w1c = g.split_first_layer(model, perm, 4)
    again = g.split_first_layer(model, tuple(perm), 4)
    assert again[0] is w1a and again[1] is w1c
    assert list(model.first_layer_splits) == [((3, 0, 6, 2, 5, 1, 4), 4)]
    w1 = model.weights[0]
    assert torch.equal(w1a, w1[[3, 0, 6, 2]]) and torch.equal(w1c, w1[[5, 1, 4]])
    assert w1a.is_contiguous() and w1c.is_contiguous()
    # another split of the same permutation is another entry; no const
    # feature gives one zero row
    w1a7, w1c7 = g.split_first_layer(model, perm, 7)
    assert torch.equal(w1a7, w1[perm]) and torch.equal(w1c7, torch.zeros((1, w1.shape[1])))
    assert len(model.first_layer_splits) == 2


def test_split_first_layer_is_dropped_when_the_model_moves():
    """to() / double() replace the model's tensors, so the kept splits go
    with them and the next call splits the new weight."""
    from rte_rrtmgp_nn_tpu_torch.gasoptics import nn_gas_optics as g
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    model = load_model_netcdf(SW_MODEL, device=CPU)
    perm = [3, 0, 6, 2, 5, 1, 4]
    w1a, _ = g.split_first_layer(model, perm, 4)
    assert w1a.dtype == torch.float32
    model.double()
    assert model.first_layer_splits == {}
    w1a64, w1c64 = g.split_first_layer(model, perm, 4)
    assert w1a64.dtype == w1c64.dtype == torch.float64
    assert torch.equal(w1a64, model.weights[0][[3, 0, 6, 2]])
