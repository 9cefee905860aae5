"""The plain twins of the port's fused kernels against the JAX package's
Pallas kernels run in interpret mode, on the same inputs: K1
(lw_clearsky_mega4) to 2e-3 W/m2 and K2 (sw_clearsky_megakernel) to 2e-2
W/m2, the JAX package's own kernel-vs-staged bounds. The column count is
not a multiple of the Pallas tile, and the SW columns include night ones.

The CUDA kernels themselves are tested on the card by
test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.ops.pallas.lw_megakernel import lw_clearsky_mega4 as jax_lw_mega4
from rte_rrtmgp_nn_tpu.ops.pallas.sw_megakernel import sw_clearsky_megakernel as jax_sw_mega
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip
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
    return rfmip.lw_mega_args([model], table, spec,
                              *rfmip.lw_canonical_inputs(data, spec, device))


def _sw_case(device, ncol=NCOL, nlay=NLAY, seed=12):
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf

    d = synthesize_rfmip(ncol, nlay, seed)
    _, data = rfmip_pair(d)
    spec = pplanck.sw_spectral_g112()
    model = load_model_netcdf(SW_MODEL, device=device)
    solar = torch.as_tensor(rfmip.default_solar_source(spec), dtype=torch.float32, device=device)
    sw_in = rfmip.sw_canonical_inputs(data, device)
    return rfmip.sw_mega_args([model, model], solar, *sw_in), sw_in, d


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
    assert set(sigs) == {"lw_clearsky_mega4_launch", "lw_clearsky_mega4_smem_bytes",
                         "sw_clearsky_megakernel_launch", "sw_clearsky_megakernel_smem_bytes",
                         "rte_cuda_error_string"}
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in sigs})
    build._declare(lib)
    restypes = {"int": ctypes.c_int, "size_t": ctypes.c_size_t, "const char*": ctypes.c_char_p}
    for name, (ret, argtypes) in sigs.items():
        fn = getattr(lib, name)
        assert list(fn.argtypes) == argtypes, name
        assert fn.restype is restypes[ret], name

