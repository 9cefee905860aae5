#!/usr/bin/env python3
"""Does the float32 exp of the SW direct beam move the fluxes? (ROADMAP
Queue 3 F7, the SW side.)

    python3 scripts/probe_sw_direct_beam_exp.py [--device cpu --ncol 64]

(``--device cpu`` runs every case on the CPU, a dry run of the script.)

The direct beam is inc * exp(-sum(tau / mu0)) at every level: the fused SW
kernel (K2, csrc/sw_megakernel.cu) takes CUDA's float32 ``expf`` of the
float32 path, and the staged routes' ops/sw_solver.direct_beam_lay_major
(K2's plain twin too) take torch.exp of the same float32 path, which on
the card is the same ``expf``. At a GCM block's shape (``--ncol``, default
57,600 columns, x 60 layers x 112 g-points; the g-112 demo net as both SW
nets, testing.synthesize_rfmip from seed 0) this prints:
  - the float32 exp on the device at the run's own paths (the day columns'
    levels) against exp in float64: its mean signed error and its spread,
    in units of float32's spacing at the result, and the share of results
    not correctly rounded;
  - K2's twin with the direct beam's exp as it is, the twin with that exp
    taken in float64 and rounded once (everything else equal), and K2
    itself (on the card), each against the twin in float64: the largest
    |difference| and the mean signed difference of each broadband flux
    over the day columns and levels, W/m2; and the first two against each
    other. A float32 flux near 1000 W/m2 is held to 6.1e-5 W/m2 (half its
    spacing), so a largest difference of a few 1e-4 between any two
    float32 runs is the fluxes' own rounding, not the exp's.
The flux effect of the exp is what taking it in float64 changes in the
distance from the float64 twin: in the largest |difference| and in the
mean signed difference. The repair (exp in double, rounded once, as PR 8
made the LW transmittance) is worth making only if that effect passes
1e-4 W/m2. The twins run ``--chunk`` (default 14,400) columns a call.
Every line ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

NLAY, SEED = 60, 0
SW_MODEL = "sw-g112-demo_absorption_48_48_HR_3.64e-02_FRC_2.14e+00.nc"


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi gave nothing"


@contextlib.contextmanager
def exp_in_float64(psw):
    """ops.sw_solver.direct_beam_lay_major with its exp taken in float64 on
    the float32 path and rounded once; the path and the rest as they are."""
    import torch

    def direct_beam(tau, mu0, inc_flux_dir, *, fast_exp):
        assert not fast_exp
        path = torch.cumsum(tau * (1.0 / mu0)[None, :, None], dim=0)
        atten = torch.exp(-path.double()).to(tau.dtype)
        top = inc_flux_dir[None]
        return torch.cat([top, top * atten], dim=0)

    old = psw.direct_beam_lay_major
    psw.direct_beam_lay_major = direct_beam
    try:
        yield
    finally:
        psw.direct_beam_lay_major = old


def column_slices(args, a: int, b: int) -> list:
    """The SW kernel's arguments (fused.sw_args) for columns [a, b),
    contiguous as the kernel takes them."""
    (am, rm, x2d, cf, perm, col_dry, mu0, inc, alb_dir, alb_dif) = args
    c = lambda t: t.contiguous()
    return [am, rm, c(x2d[:, a:b]), c(cf[a:b]), perm, c(col_dry[:, a:b]), c(mu0[a:b]),
            c(inc[a:b]), c(alb_dir[a:b]), c(alb_dif[a:b])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ncol", type=int, default=57_600)
    ap.add_argument("--chunk", type=int, default=14_400)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probe_sw_direct_beam_exp: no CUDA device (--device cpu for a dry run)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from rte_rrtmgp_nn_tpu_torch import testing
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics.planck import sw_spectral_g112
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops import sw_solver as psw
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import sw_megakernel as k2
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy

    card = card_line(dev)
    f32 = torch.float32
    model = load_model_netcdf(os.path.join(root, "artifacts", SW_MODEL), device=dev)
    solar = torch.as_tensor(rfmip.default_solar_source(sw_spectral_g112()), dtype=f32, device=dev)
    data = rfmip_data_from_arrays(testing.synthesize_rfmip(args.ncol, NLAY, SEED))
    sw_in = rfmip.sw_canonical_inputs(data, dev)
    kargs = fused.sw_args([model, model], None, *rfmip.sw_fused_inputs(solar, *sw_in))[0]
    usecol = sw_in[5]
    print(f"probe_sw_direct_beam_exp: {args.ncol} x {NLAY} x {model.n_outputs}, "
          f"{int(usecol.sum())} day columns | {card}")

    # the float32 exp at the run's own paths against float64
    mean_err = spread = 0.0
    n = wrong = 0
    for a in range(0, args.ncol, args.chunk):
        b = min(a + args.chunk, args.ncol)
        ca = column_slices(kargs, a, b)
        tau = k2._net_tau(ca[0], ca[2], ca[3], ca[4], ca[5]) + k2._net_tau(
            ca[1], ca[2], ca[3], ca[4], ca[5])
        path = torch.cumsum(tau * (1.0 / ca[6])[None, :, None], dim=0)[:, usecol[a:b]]
        e32 = torch.exp(-path)
        e64 = torch.exp(-path.double())
        keep = e32 > torch.finfo(f32).tiny
        e32, e64 = e32[keep], e64[keep]
        ulp = (torch.nextafter(e32, torch.full_like(e32, float("inf"))) - e32).double()
        err = (e32.double() - e64) / ulp
        mean_err += float(err.sum())
        spread += float((err * err).sum())
        wrong += int((e32 != e64.to(f32)).sum())
        n += err.numel()
    mean_err /= n
    spread = (spread / n - mean_err ** 2) ** 0.5
    print(f"float32 exp on {dev.type} at the direct beam's paths, {n} results: mean signed error "
          f"{mean_err:+.4f} ulp, spread {spread:.4f} ulp, {wrong / n:.4e} of them not the "
          f"correctly rounded float64 exp | {card}")

    # the flux effect: the twin as it is and with the exp in float64, K2,
    # each against the twin in float64
    names = ("flux_up", "flux_dn", "flux_dn_dir")
    model64 = float64_copy(model)
    runs = {"twin (exp as is)": [], "twin (exp in float64)": [], "K2": [], "float64 twin": []}
    for a in range(0, args.ncol, args.chunk):
        b = min(a + args.chunk, args.ncol)
        ca = column_slices(kargs, a, b)
        runs["twin (exp as is)"].append(k2.sw_clearsky_megakernel_plain(*ca))
        with exp_in_float64(psw):
            runs["twin (exp in float64)"].append(k2.sw_clearsky_megakernel_plain(*ca))
        if dev.type == "cuda":
            runs["K2"].append(k2.sw_clearsky_megakernel(*ca))
        c64 = [t.double() if torch.is_tensor(t) and t.is_floating_point() else t for t in ca]
        c64[0] = c64[1] = model64
        runs["float64 twin"].append(k2.sw_clearsky_megakernel_plain(*c64))
    cat = lambda parts: [torch.cat([p[i] for p in parts], 0)[usecol].double() for i in range(3)]
    runs = {k: cat(v) for k, v in runs.items() if v}
    ref = runs.pop("float64 twin")
    stats = {}
    for what, got in runs.items():
        stats[what] = [(float((g - r).abs().max()), float((g - r).mean()))
                       for g, r in zip(got, ref)]
        print(f"{what} vs the float64 twin, W/m2 over the day columns and levels: "
              + "; ".join(f"{n} max {m:.3e} mean {b:+.3e}" for n, (m, b) in zip(names, stats[what]))
              + f" | {card}")
    a, b = runs["twin (exp as is)"], runs["twin (exp in float64)"]
    print("twin (exp as is) vs twin (exp in float64), W/m2: "
          + "; ".join(f"{n} max {float((x - y).abs().max()):.3e} mean {float((x - y).mean()):+.3e}"
                      for n, x, y in zip(names, a, b)) + f" | {card}")
    on_max = max(abs(p[0] - q[0]) for p, q in zip(stats["twin (exp as is)"],
                                                  stats["twin (exp in float64)"]))
    on_mean = max(abs(p[1] - q[1]) for p, q in zip(stats["twin (exp as is)"],
                                                   stats["twin (exp in float64)"]))
    worst = max(on_max, on_mean)
    print(f"flux effect of the direct beam's float32 exp on the distance from float64: largest "
          f"|difference| {on_max:.3e}, mean signed difference {on_mean:.3e} W/m2 "
          f"({'beyond' if worst > 1e-4 else 'within'} 1e-4) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
