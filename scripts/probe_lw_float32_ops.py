#!/usr/bin/env python3
"""Which float32 operation puts the LW fluxes on the card further from
float64 than on the CPU?

    python3 scripts/probe_lw_float32_ops.py [--device cpu --ncol 200]

(``--device cpu`` runs every case on the CPU, a dry run of the script.)

On 3000 GCM columns (drivers/gcm.synthesize_gcm_columns over a 64-column
synthetic RFMIP atmosphere) at 20 and at 60 layers, the fused LW kernel (K1,
lw_clearsky_mega4) and its plain twin run in float32 on one NVIDIA GPU, the
twin also in float32 on the CPU, and the twin in float64 decides. Then the
twin runs on the card once per operation class with that class taken in
float64 and rounded back to float32 (exp, the matrix products, the source
factor's division, softsign, the Planck interpolation, the broadband sweeps, the
g-point sums), and once with exp taken on the CPU in float32. The class whose
substitution brings the card's twin to the CPU twin's distance from float64
is the cause. Last, exp(-tl) of the run's own optical depths is compared
element by element on the card and on the CPU against float64: its mean
signed error and its spread in units of float32's spacing at the result.
Prints one line per case: the largest |flux - float64| up and down (W/m2).
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import LW_MODEL, gpu_line  # noqa: E402

NCOL_GCM, NCOL_BASE, LAYERS = 3000, 64, (20, 60)


@contextlib.contextmanager
def patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def in64(fn):
    """fn taken in float64 on float32 tensors, its tensor results rounded to
    float32."""
    import torch

    def up(x):
        if torch.is_tensor(x) and x.dtype == torch.float32:
            return x.double()
        return x

    def down(x):
        if torch.is_tensor(x) and x.dtype == torch.float64:
            return x.float()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(down(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(down(v) for v in x)
        return x

    def wrapped(*a, **kw):
        return down(fn(*(up(x) for x in a), **{k: up(v) for k, v in kw.items()}))

    return wrapped


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ncol", type=int, default=NCOL_GCM)
    opts = ap.parse_args(argv)
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("probe_lw_float32_ops: no CUDA device", file=sys.stderr)
        return 1
    from rte_rrtmgp_nn_tpu_torch.drivers import fused, gcm, rfmip
    from rte_rrtmgp_nn_tpu_torch.drivers.rfmip_io import rfmip_data_from_arrays
    from rte_rrtmgp_nn_tpu_torch.gasoptics import planck
    from rte_rrtmgp_nn_tpu_torch.models.network import load_model_netcdf
    from rte_rrtmgp_nn_tpu_torch.ops.cuda import lw_megakernel as k1
    from rte_rrtmgp_nn_tpu_torch.testing import float64_copy, synthesize_rfmip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda, cpu = torch.device(opts.device), torch.device("cpu")
    print(gpu_line() if cuda.type == "cuda" else "dry run on the CPU")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    spec = planck.lw_spectral_g128()

    def inputs(nlay, dev):
        host = gcm.synthesize_gcm_columns(
            rfmip_data_from_arrays(synthesize_rfmip(NCOL_BASE, nlay, 57)), opts.ncol, seed=58)
        arrays = {k: host[k] for k in ("play", "plev", "tlay", "tlev", "tsfc", "sfc_emis",
                                       "sfc_alb", "sza", "tsi")}
        arrays["gases"] = {k[4:]: v if v.ndim == 2 else np.repeat(v[:, None], nlay, axis=1)
                           for k, v in host.items() if k.startswith("gas:")}
        arrays["top_at_1"] = True
        data = rfmip_data_from_arrays(arrays)
        table = planck.PlanckTable.compute(spec.band_lims_wvn_array, device=dev)
        model = load_model_netcdf(LW_MODEL, device=dev)
        args, _ = fused.lw_args([model], table, spec, *rfmip.lw_canonical_inputs(data, spec, dev))
        return list(args)

    def to64(args):
        a = [x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
        a[0] = float64_copy(args[0])
        t = args[9]
        a[9] = planck.PlanckTable(t.totplnk.double(), t.totplnk_diff.double(), t.temp_ref_min,
                                  t.totplnk_delta)
        return a

    def dist(out, ref):
        return [float((o.double().cpu() - r.cpu()).abs().max()) for o, r in zip(out, ref)]

    twin = k1.lw_clearsky_mega4_plain
    for nlay in LAYERS:
        args = inputs(nlay, cuda)
        ref = twin(*to64(args))
        ref_cpu = twin(*to64(inputs(nlay, cpu)))
        print(f"nlay {nlay}: float64 twin card vs CPU: "
              + " ".join(f"{v:.3e}" for v in dist(ref, ref_cpu)))
        rows = {"kernel (card)": k1.lw_clearsky_mega4(*args), "twin (card)": twin(*args),
                "twin (CPU)": twin(*inputs(nlay, cpu))}
        mm = torch.Tensor.__matmul__
        variants = {
            "exp in float64": [(torch, "exp", in64(torch.exp))],
            "exp on the CPU": [(torch, "exp", lambda x, f=torch.exp: f(x.cpu()).to(x.device))],
            "matmul in float64": [(torch.Tensor, "__matmul__", in64(mm))],
            "softsign in float64": [(k1, "_softsign", in64(k1._softsign))],
            "source factor in float64": [(k1, "source_fact", in64(k1.source_fact))],
            "Planck interpolation in float64": [
                (planck.PlanckTable, "interpolate",
                 lambda self, t, f=planck.PlanckTable.interpolate: f(
                     planck.PlanckTable(self.totplnk.double(), self.totplnk_diff.double(),
                                        self.temp_ref_min, self.totplnk_delta),
                     t.double()).float())],
            "sweeps in float64": [(k1, "lw_broadband_sweeps", in64(k1.lw_broadband_sweeps))],
            "g-point sums in float64": [
                (torch.Tensor, "sum",
                 lambda self, *a, f=torch.Tensor.sum, **kw: f(self.double(), *a, **kw).to(self.dtype))],
        }
        variants["all of them but exp"] = [p for k, v in variants.items() if "exp" not in k
                                           for p in v]
        for name, patches in variants.items():
            with contextlib.ExitStack() as st:
                for obj, attr, fn in patches:
                    st.enter_context(patched(obj, attr, fn))
                rows[f"twin (card), {name}"] = twin(*args)
        for name, out in rows.items():
            up, dn = dist(out, ref)
            print(f"nlay {nlay}: {name:48s} up {up:.3e} dn {dn:.3e} W/m2")

        # exp(-tl) element by element, on the run's own optical depths
        model = args[0]
        ngpt = model.n_outputs // 2
        captured = {}

        def grab(x, f=torch.exp):
            captured["tl"] = -x
            return f(x)

        with patched(torch, "exp", grab):
            twin(*args)
        tl = captured["tl"]
        e64 = torch.exp(-tl.double())
        spacing = torch.abs(torch.nextafter(e64.float(), torch.zeros_like(tl)) - e64.float()).double()
        spacing = torch.where(spacing > 0, spacing, torch.finfo(torch.float32).tiny)
        for dev_name, e32 in (("card", torch.exp(-tl)), ("CPU", torch.exp(-tl.cpu()).to(cuda))):
            ulp = (e32.double() - e64) / spacing
            thin = tl < 0.1
            print(f"nlay {nlay}: exp(-tl) on the {dev_name} vs float64 over {tl.numel()} cells "
                  f"({ngpt} g-points): mean {float(ulp.mean()):+.4f} ulp, mean |.| "
                  f"{float(ulp.abs().mean()):.4f}, max |.| {float(ulp.abs().max()):.2f}; "
                  f"cells with tl < 0.1 ({float(thin.double().mean()):.3f} of them): mean "
                  f"{float(ulp[thin].mean()):+.4f} ulp")
        del args, rows, ref, ref_cpu, tl
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
