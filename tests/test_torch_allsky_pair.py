"""The all-sky path at the net shapes users run, on columns that all
differ: SW on the real absorption + Rayleigh pairs (the in-repo
sw-synth56-lut nets, hidden widths 48_48 and 128_128, on the synthetic
56-g-point k-distribution they were trained on), LW on the 64-wide net of
the reference's shipped LW shape, both under clouds in both cloud-optics
flavours (testing.allsky_pair_setup: a GCM step's recipe on
synthesize_rfmip columns, every third column clear, mu0 clipped to [0.05,
1]).

Each all-sky core of the port is held against the port's float64 run in
every column (LW 2e-3, SW 2e-2 W/m2) and against the JAX package's same
core on the same numpy inputs; the entry points allsky_lw / allsky_sw
against JAX's on the same Garand and coefficient files. The JAX package's
SW routes keep float32 two-stream coefficients: where a JAX SW column is
beyond 2e-2 of the port, float64 decides, and the JAX column is held by
testing.SW_F1_LAW / |k*mu0 - 1| with the clouds' increment in k (ROADMAP
Queue 3 F1). On the CPU the fused cores run the kernels' plain twins; the
JAX fused cores run their Pallas kernels in interpret mode, on
JAX_FUSED_NCOL columns (interpret mode runs a tile at a time in Python).

The CUDA kernels on these shapes are tested on the card by
test_torch_cuda_kernels.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.config import config_override as jco
from rte_rrtmgp_nn_tpu.drivers import allsky as jallsky
from rte_rrtmgp_nn_tpu.extensions import cloud_optics as jcloud
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist as jload_kdist
from rte_rrtmgp_nn_tpu_torch import testing as T
from rte_rrtmgp_nn_tpu_torch.config import config_override as pco
from rte_rrtmgp_nn_tpu_torch.drivers import allsky as pallsky
from rte_rrtmgp_nn_tpu_torch.drivers import fused
from rte_rrtmgp_nn_tpu_torch.drivers import gcm as pgcm
from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
from rte_rrtmgp_nn_tpu_torch.ops import sw_solver as psw
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
from rte_rrtmgp_nn_tpu_torch.utils.ncio import write_nc
from test_torch_core import CPU, model_pair

NCOL, NLAY, SEED = 240, 60, 0
JAX_FUSED_NCOL = 24
ENTRY_NCOL = 12  # the Garand file: 2 profiles under the 3-column cloud pattern
LW_ATOL, SW_ATOL = 2e-3, 2e-2  # W/m2, per column
LW_FIELDS = ("flux_up", "flux_dn", "flux_net")
SW_FIELDS = ("flux_up", "flux_dn", "flux_dn_dir")
FLAVOURS = T.ALLSKY_PAIR_FLAVOURS
WIDTHS = tuple(T.SW_PAIR_TAGS)
F64 = torch.float64


def col_err(got, ref, names) -> np.ndarray:
    """Per column the largest |got - ref| over the fields and levels, in
    float64; flux objects of either package."""
    f = lambda fb, n: np.asarray(getattr(fb, n), np.float64)
    return np.max([np.abs(f(got, n) - f(ref, n)).max(1) for n in names], axis=0)


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """problem(width, ncol, dtype): allsky_pair_setup made once per key in
    one directory; ref64(width, flavour, ncol): the port's float64 LW
    (layer-major core) and SW (staged core) fluxes, likewise once."""
    directory = str(tmp_path_factory.mktemp("allsky_pair"))
    made, refs = {}, {}

    def problem(width="128_128", ncol=NCOL, dtype=torch.float32):
        key = (width, ncol, dtype)
        if key not in made:
            made[key] = T.allsky_pair_setup(directory, width, ncol, NLAY, SEED, CPU, dtype)
        return made[key]

    def ref64(width, flavour, ncol=NCOL):
        key = (width, flavour, ncol)
        if key not in refs:
            cores = T.allsky_pair_cores(problem(width, ncol, F64), flavour)
            refs[key] = {"lw": cores["lw_lay_major"](), "sw": cores["sw_staged"]()}
        return refs[key]

    return problem, ref64


def _hold(name, err, atol):
    worst = int(err.argmax())
    assert err.max() <= atol, (
        f"{name}: {int((err > atol).sum())} columns beyond {atol} W/m2 from float64, "
        f"largest {err.max():.4e} at column {worst}")


def test_problem_spans_what_the_stand_in_bypassed(problems):
    """The problem holds what the all-sky example's two tiled profiles and
    the ssa = 1/2 stand-in cannot: liquid, ice and mixed cells, every third
    column clear, night columns, a gas ssa across [0, 1] and day columns
    near the two-stream resonance k*mu0 = 1 after the clouds' increment."""
    p, p64 = problems[0](), problems[0](dtype=F64)
    lwp, iwp = (c > 0 for c in p["clouds"][:2])
    assert bool((lwp & ~iwp).any() and (iwp & ~lwp).any() and (lwp & iwp).any())
    assert not bool((lwp | iwp)[~torch.as_tensor(p["cloud_col"])].any())
    assert bool(p["day"].any() and (~p["day"]).any())
    assert float(p["mu0"].min()) == pytest.approx(0.05)
    _, ssa, _ = T.rfmip_sw_optics64(rfmip_data_from_arrays(p["data"]), p64["sw"]["models"],
                                    p["sw"]["spectral"])
    assert float(ssa.min()) < 1e-3 and float(ssa.max()) > 0.99
    for flavour in FLAVOURS:
        dist = T.allsky_pair_resonance_distance(p64, flavour)
        assert dist.shape == (NCOL,) and (dist[p["day"].numpy()] < 1e-3).sum() > 0


@pytest.mark.parametrize("core", ["sw_fused", "sw_staged", "sw_parallel"])
@pytest.mark.parametrize("flavour", FLAVOURS)
@pytest.mark.parametrize("width", WIDTHS)
def test_sw_cores_within_bound_of_float64_in_every_column(problems, width, flavour, core):
    """Each float32 SW all-sky core within 2e-2 W/m2 of the port's float64
    run in every column: the fused core (K2's twin in the flavour's cloud
    mode), the staged layer-major core and the log-depth adding."""
    problem, ref64 = problems
    got = T.allsky_pair_cores(problem(width), flavour)[core]()
    _hold(f"{width} {flavour} {core}", col_err(got, ref64(width, flavour)["sw"], SW_FIELDS),
          SW_ATOL)


@pytest.mark.parametrize("core", ["lw_fused", "lw_staged", "lw_lay_major"])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_lw_cores_on_the_64_wide_net_within_bound_of_float64(problems, flavour, core):
    """Each float32 LW all-sky core on the 18 -> 64 -> 64 -> 256 net within
    2e-3 W/m2 of the port's float64 run in every column: the fused core
    (K1's twin in the flavour's cloud mode), the general core (one angle)
    and the layer-major core."""
    problem, ref64 = problems
    got = T.allsky_pair_cores(problem(), flavour)[core]()
    _hold(f"{flavour} {core}", col_err(got, ref64("128_128", flavour)["lw"], LW_FIELDS), LW_ATOL)


def test_fused_and_staged_sw_agree_and_clouds_show(problems):
    """On the 128_128 pair the fused twin and the staged core agree within
    2e-2 W/m2 in every column, and the clouds cut the surface direct beam
    of every cloudy day column below its clear-sky value."""
    p = problems[0]()
    for flavour in FLAVOURS:
        cores = T.allsky_pair_cores(p, flavour)
        fused, staged = cores["sw_fused"](), cores["sw_staged"]()
        _hold(f"{flavour} fused vs staged", col_err(fused, staged, SW_FIELDS), SW_ATOL)
        clear = pallsky._allsky_sw_core_lay_major(
            p["sw"]["models"], p["sw"]["spectral"], p["solar"], p["cloud"][f"sw_{flavour}"],
            *p["sw_staged"][:6], *(torch.zeros_like(c) for c in p["clouds"]),
            p["sw_staged"][-1], top_at_1=True)
        cloudy = (p["clouds"][0] + p["clouds"][1]).amax(1) > 0
        sel = cloudy & p["day"]
        assert bool(sel.any())
        assert bool((staged.flux_dn_dir[sel, -1] < clear.flux_dn_dir[sel, -1]).all())
        assert torch.equal(staged.flux_dn_dir[~cloudy], clear.flux_dn_dir[~cloudy])


def _spy(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        seen.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_staged_coefficients_equal_the_twins_bit_for_bit_under_clouds(problems, monkeypatch,
                                                                     flavour):
    """Under clouds (g > 0) the staged routes' two-stream coefficients still
    equal K2 twin's bit for bit on the same tau, ssa, g and mu0: the
    layer-major broadband route and the column-major spectral route."""
    p = problems[0]()
    args, kw = fused.sw_args(*T.allsky_pair_fused(p, "sw", flavour))
    taken = []
    _spy(monkeypatch, k2, "pifm_coefficients", taken)
    k2.sw_clearsky_megakernel_plain(*args, **kw)
    ((tau, ssa, g, _), twin), = taken
    # delta-scaled cloud asymmetry g / (1 + g), the gas ssa across [0, 1]
    assert float(g.max()) > 0.3 and float(ssa.min()) < 1e-3 and float(ssa.max()) > 0.99
    mu0, inc = args[6], args[7]
    seen = []
    _spy(monkeypatch, psw, "pifm_coefficients", seen)
    psw.sw_solver_2stream_lay_major(tau, ssa, g, mu0, inc / mu0[:, None], args[8], args[9])
    t = lambda a: a.transpose(0, 1)
    psw.sw_solver_2stream(t(tau), t(ssa), t(g), mu0, inc / mu0[:, None], args[8], args[9])
    (_, lay_major), (_, col_major) = seen
    for name, a, b, c in zip(("rdif", "tdif", "rdir", "tdir"), twin, lay_major, col_major):
        assert torch.equal(a, b), f"{name}: lay-major route"
        assert torch.equal(a, t(c)), f"{name}: column-major route"


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_cloud_modes_without_clouds_give_the_clear_sky_fluxes(problems, monkeypatch, flavour):
    """The cloud combine's float32 guard (sw_megakernel.CLD_EPS) on the real
    pair, whose gas ssa spans [0, 1] and whose gas tau falls below the guard
    in some cells: K2's twin in the flavour's cloud mode with every cloud
    field 0 gives the clear mode's fluxes within 1e-3 W/m2 (the combine's
    float32 rounding), and K1's twin on the 64-wide net the same."""
    p = problems[0]()
    sargs, skw = fused.sw_args(*T.allsky_pair_fused(p, "sw", flavour))
    taken = []
    _spy(monkeypatch, k2, "pifm_coefficients", taken)
    clear = k2.sw_clearsky_megakernel_plain(*sargs)
    assert bool((taken[0][0][0] < k2.CLD_EPS).any())  # cells under the guard
    got = k2.sw_clearsky_megakernel_plain(*sargs, **T.without_clouds(skw))
    assert max(float((a - b).abs().max()) for a, b in zip(got, clear)) <= 1e-3
    largs, lkw = fused.lw_args(*T.allsky_pair_fused(p, "lw", flavour))
    got = k1.lw_clearsky_mega4_plain(*largs, **T.without_clouds(lkw))
    clear = k1.lw_clearsky_mega4_plain(*largs)
    assert max(float((a - b).abs().max()) for a, b in zip(got, clear)) <= 1e-3


# -- against the JAX package ----------------------------------------------------------

def _jax_inputs(p, flavour):
    """The JAX package's nets, tables, spectral mappings, cloud optics and
    core inputs of the port problem ``p``, from the same files and the same
    numpy arrays."""
    def j(a):
        if isinstance(a, dict):
            return {k: j(v) for k, v in a.items()}
        return jnp.asarray(np.asarray(a), jnp.float32)

    pair = p["sw"]
    jkd = jload_kdist(pair["kdist_path"], T.LUT_GASES)
    lw_spec = jplanck.lw_spectral_g128()
    lw_head = ([model_pair(T.artifact_path(T.LW_NET_64))[0]],
               jplanck.PlanckTable.compute(lw_spec.band_lims_wvn_array, dtype=jnp.float32),
               lw_spec, jcloud.load_cloud_optics(p["cloud_paths"][f"lw_{flavour}"]))
    sw_head = ([model_pair(path)[0] for path in pair["paths"]], jkd.spectral, j(pair["solar"]),
               jcloud.load_cloud_optics(p["cloud_paths"][f"sw_{flavour}"]))
    return lw_head, sw_head, {k: tuple(map(j, p[k]))
                              for k in ("lw_staged", "sw_staged", "lw_canon", "sw_canon")}


def _jax_core(p, flavour, core):
    """The JAX package's all-sky core ``core`` on the problem ``p``, jitted
    as its drivers take it."""
    lw_head, sw_head, a = _jax_inputs(p, flavour)
    calls = {
        "lw_fused": (jallsky._allsky_lw_core_mega, lw_head, a["lw_canon"], dict(tile_c=8)),
        "lw_staged": (jallsky._allsky_lw_core, lw_head, a["lw_staged"],
                      dict(n_gauss_angles=1, scan_mode="sequential")),
        "lw_lay_major": (jallsky._allsky_lw_core_lay_major, lw_head, a["lw_staged"], {}),
        "sw_fused": (jallsky._allsky_sw_core_mega, sw_head, a["sw_canon"], dict(tile_c=8)),
        "sw_staged": (jallsky._allsky_sw_core_lay_major, sw_head, a["sw_staged"], {}),
        "sw_parallel": (jallsky._allsky_sw_core, sw_head, a["sw_staged"],
                        dict(scan_mode="parallel")),
    }
    fn, head, args, kw = calls[core]
    return jax.jit(functools.partial(fn, *head, top_at_1=True, **kw))(*args)


def _hold_sw_against_jax(got, ref, ref64, dist):
    """The port within 2e-2 W/m2 of float64 in every column; where the JAX
    column is beyond 2e-2 of the port, it is held by SW_F1_LAW / |k*mu0 -
    1| from float64, and the port is the nearer of the two."""
    port = col_err(got, ref64, SW_FIELDS)
    _hold("port", port, SW_ATOL)
    beyond = col_err(got, ref, SW_FIELDS) > SW_ATOL
    if beyond.any():
        jax_err = col_err(ref, ref64, SW_FIELDS)
        limit = np.maximum(SW_ATOL, T.SW_F1_LAW / dist)
        assert np.all(jax_err[beyond] <= limit[beyond]), (jax_err[beyond], dist[beyond])
        assert np.all(port[beyond] < jax_err[beyond])


# the fused cores in both flavours (the flavour is the kernel's cloud mode);
# each staged core in one, since the flavour changes only the cloud optics
# that feed it (held against JAX in both by test_torch_allsky.py)
JAX_CASES = [("lut", "lw_fused"), ("pade", "lw_fused"), ("lut", "sw_fused"), ("pade", "sw_fused"),
             ("lut", "lw_staged"), ("pade", "lw_lay_major"), ("lut", "sw_staged"),
             ("pade", "sw_parallel")]


@pytest.mark.parametrize("flavour,core", JAX_CASES)
def test_port_cores_against_jax(problems, flavour, core):
    """Each all-sky core of the port against the JAX package's same core on
    the same numpy inputs (the 128_128 pair, the 64-wide LW net): LW within
    2e-3 W/m2; SW within 2e-2, float64 deciding beyond (F1). The fused
    cores on JAX_FUSED_NCOL columns of their own problem, the others on
    NCOL."""
    problem, ref64 = problems
    ncol = JAX_FUSED_NCOL if core.endswith("fused") else NCOL
    p = problem(ncol=ncol)
    got = T.allsky_pair_cores(p, flavour)[core]()
    ref = _jax_core(p, flavour, core)
    if core.startswith("lw"):
        _hold(f"{flavour} {core} vs JAX", col_err(got, ref, LW_FIELDS), LW_ATOL)
        return
    dist = T.allsky_pair_resonance_distance(problem(ncol=ncol, dtype=F64), flavour)
    _hold_sw_against_jax(got, ref, ref64("128_128", flavour, ncol)["sw"], dist)


# -- the entry points on a Garand file -------------------------------------------------

@pytest.fixture(scope="module")
def garand(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("garand") / "garand.nc")
    write_nc(path, *T.garand_nc_variables(T.synthesize_garand(NLAY, SEED)))
    return path


@pytest.mark.parametrize("flavour,route", [("lut", "fused"), ("pade", "staged"),
                                            ("lut", "parallel")])
def test_entry_points_on_the_real_nets_match_jax(problems, garand, flavour, route):
    """allsky_lw on the 64-wide net and allsky_sw on the 128_128 pair (its
    spectral mapping and solar source, coefficient files on its 14 bands)
    of both packages on the same Garand and coefficient files, on every
    route: LW within 2e-3 W/m2, SW within 2e-2 (the file's 2 profiles hold
    no column near the resonance); the port's SW TOA flux is sum(solar) *
    0.86, and its float64 run agrees with the float32 one."""
    p = problems[0]()
    pair = p["sw"]
    lw_head, sw_head, _ = _jax_inputs(p, flavour)
    ncol = ENTRY_NCOL
    lw_co, sw_co = (p["cloud_paths"][f"{b}_{flavour}"] for b in ("lw", "sw"))
    kw = dict(ncol=ncol, scan_mode="parallel" if route == "parallel" else "sequential")
    fused = route == "fused"
    with jco(use_megakernel=fused), pco(use_megakernel=fused):
        ref_lw = jallsky.allsky_lw(garand, lw_co, lw_head[0], **kw)
        got_lw = pallsky.allsky_lw(garand, lw_co, p["lw_models"], device=CPU, **kw)
        ref_sw = jallsky.allsky_sw(garand, sw_co, sw_head[0], spectral=sw_head[1],
                                   solar_source=pair["solar"], **kw)
        got_sw = pallsky.allsky_sw(garand, sw_co, pair["models"], spectral=pair["spectral"],
                                   solar_source=pair["solar"], device=CPU, **kw)
    _hold(f"{flavour} {route} allsky_lw vs JAX", col_err(got_lw, ref_lw, LW_FIELDS), LW_ATOL)
    _hold(f"{flavour} {route} allsky_sw vs JAX", col_err(got_sw, ref_sw, SW_FIELDS), SW_ATOL)
    np.testing.assert_allclose(got_sw.flux_dn[:, 0].numpy(), 0.86 * pair["solar"].sum(),
                               rtol=1e-5)
    if route == "staged":
        p64 = problems[0](dtype=F64)
        lw64 = pallsky.allsky_lw(garand, lw_co, p64["lw_models"], device=CPU, dtype=F64, **kw)
        sw64 = pallsky.allsky_sw(garand, sw_co, p64["sw"]["models"], spectral=pair["spectral"],
                                 solar_source=pair["solar"], device=CPU, dtype=F64, **kw)
        _hold("allsky_lw vs float64", col_err(got_lw, lw64, LW_FIELDS), LW_ATOL)
        _hold("allsky_sw vs float64", col_err(got_sw, sw64, SW_FIELDS), SW_ATOL)


# -- the GCM sweep takes the SW mapping from the nets' outputs ----------------------------

def test_gcm_sweep_allsky_refuses_a_sw_net_of_neither_112_nor_224_outputs(problems):
    """gcm_sweep_allsky takes the g-112 or g-224 SW mapping by the nets'
    outputs; a 56-output pair is refused in words before any block runs
    (it would take 224 g-points of solar source and albedo), as
    gcm_sweep_lw refuses LW nets."""
    p = problems[0]()
    host = pgcm.synthesize_gcm_columns(rfmip_data_from_arrays(T.synthesize_rfmip(8, 12, SEED)),
                                       8)
    with pytest.raises(ValueError, match="112 or 224 outputs.*not 56"):
        pgcm.gcm_sweep_allsky(host, p["lw_models"], p["sw"]["models"], p["cloud"]["lw_lut"],
                              p["cloud"]["sw_lut"], block_size=8, device=CPU)
