"""PyTorch port against the JAX package: the LW no-scattering transport
kernel's two modes (K7, ops/cuda/lw_solver.py) on the CPU, where the
wrappers run their plain twins.

- The angles mode (``lw_noscat_broadband_angles``) against the
  angle-weighted sum of JAX ``lw_noscat_broadband_pallas`` in interpret mode,
  for 1-4 Gauss angles with an incident flux, and for one angle with
  per-(column, g-point) secants; column and layer counts that are not
  multiples of the Pallas tile (8) and chunk (5). Bound: rtol 2e-6, atol
  1e-5 W/m2 (tests/test_pallas_lw_solver.py, tests/test_torch_lw_noscat.py).
- The fields mode (``lw_broadband_sweeps_kernel``) against JAX
  ``ops/lw_solver.lw_broadband_sweeps`` on the same layer-major fields; the
  prep LW core (K6 then the fields mode) against the JAX core, end to end.
- The launch plan (``lw_noscat_plan``): pure Python, every shape gets a
  geometry that fits, and the source's C rules are the same rules.

The CUDA kernel itself is tested on the card by test_torch_cuda_kernels.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rte_rrtmgp_nn_tpu.drivers import rfmip as jrfmip
from rte_rrtmgp_nn_tpu.gasoptics import planck as jplanck
from rte_rrtmgp_nn_tpu.ops import lw_solver as jlw
from rte_rrtmgp_nn_tpu.ops.pallas.lw_solver import lw_noscat_broadband_pallas
from rte_rrtmgp_nn_tpu_torch.drivers import rfmip as prfmip
from rte_rrtmgp_nn_tpu_torch.gasoptics import planck as pplanck
from rte_rrtmgp_nn_tpu_torch.ops import lw_solver as plw
from rte_rrtmgp_nn_tpu_torch.ops.cuda import build
from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_solver as k7
from rte_rrtmgp_nn_tpu_torch.testing import synthesize_rfmip
from test_torch_core import CPU, LW_MODEL, model_pair, rfmip_pair

RTOL, ATOL, LW_ATOL = 2e-6, 1e-5, 2e-3
NGPT = 32


def _problem(rng, ncol, nlay, ngpt=NGPT):
    f = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    return (f(1e-4, 3.0, ncol, nlay, ngpt), f(0.1, 1.0, ncol, nlay, ngpt),
            f(0.1, 1.0, ncol, nlay + 1, ngpt), f(0.8, 1.0, ncol, ngpt), f(0.1, 1.0, ncol, ngpt))


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nang", [1, 2, 3, 4])
@pytest.mark.parametrize("ncol,nlay", [(13, 12), (21, 23)])
def test_angles_mode_matches_pallas_sum(rng, ncol, nlay, nang):
    """Gauss angles with an incident flux: each JAX angle starts from the
    flux over 2 pi w, and the angles' fluxes are added in angle order."""
    arrs = _problem(rng, ncol, nlay)
    inc = rng.uniform(0.0, 5.0, (ncol, NGPT)).astype(np.float32)
    secants = [float(d) for d in plw.GAUSS_DS[nang - 1, :nang]]
    weights = [float(w) for w in plw.GAUSS_WTS[nang - 1, :nang]]
    ref_up = ref_dn = 0.0
    for d, w in zip(secants, weights):
        up, dn = lw_noscat_broadband_pallas(
            *map(jnp.asarray, arrs), d_secant=d, weight=w,
            inc_rad=jnp.asarray(inc) / np.float32(2.0 * np.pi * w), tile_c=8, chunk=5,
            interpret=True)
        ref_up, ref_dn = ref_up + np.asarray(up), ref_dn + np.asarray(dn)
    n = k7.LAUNCHES
    got = k7.lw_noscat_broadband_angles(*map(torch.from_numpy, arrs), secants, weights,
                                        torch.from_numpy(inc))
    assert k7.LAUNCHES == n
    assert tuple(got[0].shape) == (ncol, nlay + 1)
    _close(got, (ref_up, ref_dn))
    # the entry on CPU tensors is its twin, bit for bit
    twin = k7.lw_noscat_broadband_angles_plain(*map(torch.from_numpy, arrs), secants, weights,
                                               torch.from_numpy(inc))
    assert all(torch.equal(a, b) for a, b in zip(got, twin))


@pytest.mark.parametrize("with_inc", [False, True])
def test_angles_mode_per_gpoint_secants(rng, with_inc):
    """One angle with per-(column, g-point) secants (the optimal-angle
    path), with and without an incident flux."""
    ncol, nlay = 13, 12
    arrs = _problem(rng, ncol, nlay)
    ds = rng.uniform(1.2, 2.8, (ncol, NGPT)).astype(np.float32)
    inc = rng.uniform(0.0, 5.0, (ncol, NGPT)).astype(np.float32) if with_inc else None
    w = plw.LW_WEIGHT
    ref = lw_noscat_broadband_pallas(
        *map(jnp.asarray, arrs), d_secant=jnp.asarray(ds), weight=w,
        inc_rad=None if inc is None else jnp.asarray(inc) / np.float32(2.0 * np.pi * w),
        tile_c=8, chunk=5, interpret=True)
    got = k7.lw_noscat_broadband_angles(*map(torch.from_numpy, arrs), torch.from_numpy(ds), [w],
                                        None if inc is None else torch.from_numpy(inc))
    _close(got, ref)


def test_angles_mode_refuses_mismatched_angles(rng):
    arrs = [torch.from_numpy(a) for a in _problem(rng, 3, 4)]
    with pytest.raises(ValueError, match="2 secants, 1 weights"):
        k7.lw_noscat_broadband_angles(*arrs, [1.1, 2.8], [0.5])


@pytest.mark.parametrize("ncol,nlay", [(13, 12), (21, 23)])
def test_fields_mode_matches_jax_sweeps(rng, ncol, nlay):
    """The fields mode on seeded layer-major (trans, src_dn, src_up)
    against JAX lw_broadband_sweeps."""
    f = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    arrs = (f(0.0, 1.0, nlay, ncol, NGPT), f(0.0, 1.0, nlay, ncol, NGPT),
            f(0.0, 1.0, nlay, ncol, NGPT), f(0.8, 1.0, ncol, NGPT), f(0.1, 1.0, ncol, NGPT))
    ref = jlw.lw_broadband_sweeps(*map(jnp.asarray, arrs))
    got = k7.lw_broadband_sweeps_kernel(*map(torch.from_numpy, arrs))
    assert tuple(got.flux_up.shape) == (ncol, nlay + 1)
    _close((got.flux_up, got.flux_dn), (ref.flux_up, ref.flux_dn))


@pytest.mark.parametrize("top_at_1", [True, False])
def test_prep_core_goes_through_the_fields_mode(monkeypatch, top_at_1):
    """The port's _lw_core_prep (K6's twin, then the fields entry, called
    once) against the JAX core at 13 x 8."""
    ncol, nlay = 13, 8
    calls = []
    entry = k7.lw_broadband_sweeps_kernel
    monkeypatch.setattr(prfmip, "lw_broadband_sweeps_kernel",
                        lambda *a: calls.append(tuple(a[0].shape)) or entry(*a))
    d = synthesize_rfmip(ncol, nlay, seed=34, top_at_1=top_at_1)
    jd, pd = rfmip_pair(d)
    jm, pm = model_pair(LW_MODEL)
    jspec, pspec = jplanck.lw_spectral_g128(), pplanck.lw_spectral_g128()
    jt = jplanck.PlanckTable.compute(jspec.band_lims_wvn_array, dtype=jnp.float32)
    pt = pplanck.PlanckTable.compute(pspec.band_lims_wvn_array, device=CPU)
    j = lambda a: jnp.asarray(a, jnp.float32)
    emis = np.broadcast_to(np.asarray(d["sfc_emis"], np.float32)[:, None], (ncol, jspec.nband))
    ref = jrfmip._lw_core_prep(
        [jm], jt, jspec, j(jd.play), j(jd.plev), j(jd.tlay), j(jd.tlev), j(jd.tsfc), j(emis),
        {k: j(v) for k, v in jd.gas_concs.concs.items()}, top_at_1=top_at_1, tile_c=8)
    got = prfmip._lw_core_prep([pm], pt, pspec, *prfmip.lw_staged_inputs(pd, pspec, CPU),
                               top_at_1=top_at_1)
    assert calls == [(nlay, ncol, pspec.ngpt)]
    for n in ("flux_up", "flux_dn", "flux_net"):
        np.testing.assert_allclose(getattr(got, n).numpy(), np.asarray(getattr(ref, n)),
                                   atol=LW_ATOL, err_msg=n)


# -- the launch plan ---------------------------------------------------------

def _c_rules() -> dict:
    """The source's one-line ``inline int`` helpers (the plan's rules) as
    Python functions: C's integer division is //."""
    text = (build.CSRC_DIR / "lw_noscat.cu").read_text()
    rules = {}
    for name, params, expr in re.findall(
            r"inline int (\w+)\(([^)]*)\) \{\s*return (.*?);\s*\}", text, re.S):
        args = ", ".join(p.split()[-1] for p in params.split(","))
        body = re.sub(r"\s+", " ", expr).replace(" / ", " // ")
        if "?" in body:  # imax, imin
            continue
        exec(f"def {name}({args}): return {body}", rules)
    rules.update(imax=max, imin=min)
    return rules


def _c_constant(name: str) -> int:
    text = (build.CSRC_DIR / "lw_noscat.cu").read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


def test_plan_constants_are_the_sources():
    assert (_c_constant("kMaxGpt"), _c_constant("kMaxAngles")) == (k7.MAX_NGPT, k7.MAX_ANGLES)
    text = (build.CSRC_DIR / "lw_noscat.cu").read_text()
    assert sorted(int(c) for c in re.findall(r"case (\d+): return pick_angles", text)) == list(
        k7.SEG_LAYERS)


# 60 x 128: the RFMIP width; 60 x 256: the lookup-table width; 37 x 13: a
# ragged warp; 2000 layers: no width's column fits, tiers
@pytest.mark.parametrize("nlay,ngpt", [(60, 128), (60, 256), (37, 13), (2000, 128),
                                       (2000, 256)])
@pytest.mark.parametrize("nang", [1, 2, 3, 4])
def test_plan_fits_and_agrees_with_the_c_rule(nlay, ngpt, nang):
    """Every shape the wrapper takes gets a plan that fits the shared
    memory and the instance's threads; it keeps every layer's rows where
    some plan does, else keeps as many tiers as fit with its segments; its
    shared memory is what the source's rule lays out, and the source's
    checks hold."""
    rules = _c_rules()
    plan = k7.lw_noscat_plan(nlay, ngpt, nang)
    gp = -(-ngpt // 32) * 32
    L, nseg, kept = plan.seg_layers, plan.segments, plan.kept_tiers
    c_floats = rules["noscat_smem_floats"](nlay, gp, nang, L, nseg, kept)
    n_tiers = rules["noscat_tiers"](nlay, L * nseg)
    assert plan.smem_bytes == 4 * c_floats <= k7.MAX_SMEM
    assert c_floats == k7.smem_floats(nlay, gp, nang, L, nseg, kept)
    assert plan.threads == gp * nseg <= rules["noscat_max_threads"](L) == k7.max_threads(L)
    assert plan.angles == nang and (nseg - 1) * L < nlay and 0 <= kept <= n_tiers
    # the segments split the layers: each layer is walked by one thread of a g-point
    owners = [t * L * nseg + s * L + u for t in range(n_tiers) for s in range(nseg)
              for u in range(L) if t * L * nseg + s * L + u < nlay]
    assert owners == list(range(nlay))
    if kept < n_tiers:  # one more kept tier would not fit
        assert 4 * rules["noscat_smem_floats"](nlay, gp, nang, L, nseg, kept + 1) > k7.MAX_SMEM
    for other in range(1, k7.max_threads(L) // gp + 1):
        if (other - 1) * L < nlay:
            try:
                alt = k7.lw_noscat_plan(nlay, ngpt, nang, segments=other)
            except ValueError:  # this many segments fit no tier: not a candidate
                continue
            assert (alt.kept_tiers == k7.tiers(nlay, L * other), *k7.resident(alt)) <= (
                kept == n_tiers, *k7.resident(plan))
    if (nlay, ngpt) in ((60, 128), (37, 13)) and nang <= 3 or (nlay, ngpt, nang) == (60, 256, 1):
        assert kept == n_tiers  # the main shapes read every field once
    if nlay == 2000:
        assert kept < n_tiers


def test_plan_takes_the_tuning_knobs_and_refuses_in_words():
    # two blocks of 4 segments an SM keep as many threads as one of 8, and
    # one column's loads overlap the other's walk
    assert k7.lw_noscat_plan(60, 128, 1).segments == 4
    assert k7.resident(k7.lw_noscat_plan(60, 128, 1)) == (1024, 2)
    assert k7.lw_noscat_plan(60, 128, 1, segments=8).threads == 1024
    assert k7.lw_noscat_plan(60, 128, 1, segments=2).segments == 2
    assert k7.lw_noscat_plan(60, 128, 1, seg_layers=16).threads == 512
    assert k7.lw_noscat_plan(60, 128, 3).seg_layers == 4
    with pytest.raises(ValueError, match="seg_layers"):
        k7.lw_noscat_plan(60, 128, 1, seg_layers=5)
    with pytest.raises(ValueError, match="ngpt 257"):
        k7.lw_noscat_plan(60, 257, 1)
    with pytest.raises(ValueError, match="5 angles"):
        k7.lw_noscat_plan(60, 128, 5)
    with pytest.raises(ValueError, match="no geometry"):
        k7.lw_noscat_plan(60, 128, 1, smem_limit=1000)
