"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` (Hopper), one nvcc
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes; the fused
kernels' entries take their arguments as structs, mirrored here. The build runs
at the first CUDA use in a process, into ``build/kernels/`` beside the
package, under a name that hashes the sources, so an edited source is
rebuilt and an unchanged one is loaded as built; the compiler's output
(``-Xptxas -v``: registers and spill of every kernel) is kept beside the
library and read by ``kernel_resources``. No ``--use_fast_math``:
exp, divide and sqrt stay IEEE (float32, except the SW kernel's two-stream
coefficients, which are float64).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# what the last build in this process did: seconds, command, compiler output
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cand = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] if "CUDA_HOME" in os.environ else []
    cand.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cand:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists;
    return its path."""
    out = BUILD_DIR / f"librte_kernels_{_digest()}.so"
    if out.exists():
        BUILD_INFO.setdefault("cached", True)
        BUILD_INFO.setdefault("path", str(out))
        log = out.with_suffix(".log")
        if log.exists():
            BUILD_INFO.setdefault("log", log.read_text())
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                           f"{proc.stdout}{proc.stderr}")
    log = "".join(logs) + proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False, path=str(out),
                      command="\n".join(" ".join(c) for c, _, _ in jobs) + "\n" + " ".join(link),
                      log=log)
    return out


def kernel_resources(kernel: str, mode: int | tuple | None = None) -> dict:
    """{"registers", "spill_bytes"} of a ``__global__`` function as ptxas
    reported them in the build that made the loaded library: ``kernel`` is
    the function's name in the source, ``mode`` the value of its integer
    template parameter, or the tuple of them, if it has any. Empty if the
    build's output is not at hand."""
    args = () if mode is None else (mode,) if isinstance(mode, int) else tuple(mode)
    want = f"{len(kernel)}{kernel}" + ("I" + "".join(f"Li{v}E" for v in args) if args else "")
    blocks = re.split(r"Compiling entry function '", BUILD_INFO.get("log", ""))[1:]
    for block in blocks:
        name, _, rest = block.partition("'")
        regs = re.search(r"Used (\d+) registers", rest)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rest)
        if want in name and regs and spill:
            return {"registers": int(regs.group(1)),
                    "spill_bytes": int(spill.group(1)) + int(spill.group(2))}
    return {}


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_LANES = 32  # csrc/common.cuh kMaxLanes
MAX_LAYERS = 8  # csrc/mlp.cu kMaxLayers
MAX_ANGLES = 4  # csrc/lw_noscat.cu kMaxAngles


def _fields(ctype, names: str) -> list:
    return [(n, ctype) for n in names.split()]


# The structs the fused kernels' launch entries read, field by field as the
# sources declare them (a test holds each against its C declaration). A
# wrapper fills them by field name; fields it leaves out are null or 0.
class Mlp3(ctypes.Structure):  # csrc/common.cuh
    _fields_ = _fields(P, "w1a w1c b1 w2 b2 w3 b3 omean ostd") + _fields(I, "h1 h2 nout")


class PlanckTab(ctypes.Structure):  # csrc/common.cuh
    _fields_ = _fields(P, "tab dtab") + _fields(I, "nband ntab") + _fields(F, "t_min t_delta")


class CloudLut(ctypes.Structure):  # csrc/common.cuh
    _fields_ = (_fields(P, "liq ice") + _fields(I, "n_liq n_ice nband")
                + _fields(F, "liq_off liq_step ice_off ice_step"))


class LaneList(ctypes.Structure):  # csrc/common.cuh
    _fields_ = [("p", P * MAX_LANES), ("code", I * MAX_LANES)]


class MegaPlan(ctypes.Structure):  # csrc/common.cuh
    _fields_ = _fields(I, "threads groups layers_per_group rows_per_pass smem_bytes slab_floats")


class MlpNet(ctypes.Structure):  # csrc/mlp.cu
    _fields_ = [("w", P * MAX_LAYERS), ("b", P * MAX_LAYERS), ("omean", P), ("ostd", P),
                ("nlayers", I), ("dims", I * (MAX_LAYERS + 1)), ("act", I * MAX_LAYERS)]


class MlpPlan(ctypes.Structure):  # csrc/mlp.cu
    _fields_ = _fields(I, "threads rows width smem_bytes slab_floats")


class LwArgs(ctypes.Structure):  # csrc/lw_megakernel.cu
    _fields_ = (_fields(P, "x cf col_dry tlay tlev tsfc emis gpt2band up dn")
                + _fields(I, "ncol nlay n2d nc ngpt")
                + _fields(F, "d_secant two_pi_w tau_thresh")
                + _fields(P, "lwp iwp rel rei cld_band scale"))


class LwPrepArgs(ctypes.Structure):  # csrc/lw_prep.cu
    _fields_ = (_fields(P, "x col_dry b_lay b_lev b_sfc gpt2band trans src_dn src_up sfc_src")
                + _fields(I, "ncol nlay nf ngpt nband") + _fields(F, "d_secant tau_thresh"))


class SwArgs(ctypes.Structure):  # csrc/sw_megakernel.cu
    _fields_ = (_fields(P, "x cf col_dry mu0 inc_dir inc_dif alb_dir alb_dif up dn dir")
                + _fields(I, "ncol nlay n2d nc ngpt") + _fields(F, "k_min eps cld_eps")
                + _fields(P, "gpt2band") + _fields(I, "nband")
                + _fields(P, "lwp iwp rel rei cld_tau cld_ts cld_tsg"))


class NoscatArgs(ctypes.Structure):  # csrc/lw_noscat.cu
    _fields_ = (_fields(P, "f0 f1 f2 emis sfc ds inc up dn")
                + _fields(I, "col_stride0 lay_stride0 col_stride1 lay_stride1 col_stride2 "
                             "lay_stride2 ncol nlay ngpt nang")
                + [(n, F * MAX_ANGLES) for n in ("secant", "two_pi_w", "inc_div")]
                + [("tau_thresh", F)])


class NoscatPlan(ctypes.Structure):  # csrc/lw_noscat.cu
    _fields_ = _fields(I, "threads seg_layers segments kept_tiers angles smem_bytes")


class LutArgs(ctypes.Structure):  # csrc/lut_gas_optics.cu
    _fields_ = (_fields(P, "play tlay col_gas kmajor ktab vmr_ref temp_ref flavor gflav "
                           "kminor_lo kminor_up minor tau out2")
                + _fields(I, "nrow ngpt ncg ntemp npres neta nminor ncontrib_lo ncontrib_up "
                             "idx_h2o")
                + _fields(F, "t_shift t_delta p_log0 p_log_delta p_trop_log mix_min"))


class Sw2StreamArgs(ctypes.Structure):  # csrc/sw_2stream.cu
    _fields_ = (_fields(P, "tau ssa g mu0 inc_flux alb_dir alb_dif inc_dif scratch up dn dir")
                + _fields(I, "ncol nlay ngpt top_at_1")
                + _fields(ctypes.c_double, "k_min eps"))


def mlp3(w1a, w1c, model) -> Mlp3:
    """The Mlp3 of a 3-layer model whose first layer is split into the
    lanes' rows ``w1a`` and the const block's rows ``w1c``."""
    _, w2, w3 = model.weights
    b1, b2, b3 = model.biases
    ptrs = (w1a, w1c, b1, w2, b2, w3, b3, model.output_mean, model.output_std)
    return Mlp3(*(t.data_ptr() for t in ptrs), w1a.shape[1], w2.shape[1], w3.shape[1])


def lane_list(lanes, codes=None) -> LaneList:
    """The LaneList of up to MAX_LANES tensors (and their transform codes)."""
    ll = LaneList()
    for k, t in enumerate(lanes):
        ll.p[k] = t.data_ptr()
        ll.code[k] = int(codes[k]) if codes is not None else 0
    return ll


def _declare(lib) -> None:
    # (args, net, planck, plan, cloud, lanes, mode, device, stream)
    lib.lw_clearsky_mega4_launch.argtypes = [P] * 6 + [I, I, P]
    lib.lw_clearsky_mega4_launch.restype = I
    # (args, abs_net, ray_net, plan, cloud, lanes, mode, device, stream)
    lib.sw_clearsky_megakernel_launch.argtypes = [P] * 6 + [I, I, P]
    lib.sw_clearsky_megakernel_launch.restype = I
    # (plan, mode, device, blocks)
    for entry in PLAN_STRUCTS:
        fn = getattr(lib, f"{entry}_blocks_per_sm")
        fn.argtypes = [P, I, I, P]
        fn.restype = I
    # (args, net, plan, device, stream)
    lib.lw_prep_launch.argtypes = [P, P, P, I, P]
    lib.lw_prep_launch.restype = I
    # (epilogue, x, col_dry, net_a, net_b, plan, out0, out1, rows, device, stream)
    lib.mlp_predict_launch.argtypes = [I] + [P] * 7 + [I, I, P]
    lib.mlp_predict_launch.restype = I
    # (args, plan, mode, device, stream)
    lib.lw_noscat_broadband_launch.argtypes = [P, P, I, I, P]
    lib.lw_noscat_broadband_launch.restype = I
    # (args, mode, device, stream)
    lib.lut_gas_optics_launch.argtypes = [P, I, I, P]
    lib.lut_gas_optics_launch.restype = I
    # (args, device, stream)
    lib.sw_2stream_launch.argtypes = [P, I, P]
    lib.sw_2stream_launch.restype = I
    lib.rte_cuda_error_string.argtypes = [I]
    lib.rte_cuda_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


# the launch entries with an occupancy entry, and the plan struct each takes
PLAN_STRUCTS = {"lw_clearsky_mega4": MegaPlan, "sw_clearsky_megakernel": MegaPlan,
                "lw_prep": MegaPlan, "mlp_predict": MlpPlan, "lw_noscat_broadband": NoscatPlan}


def blocks_per_sm(entry: str, plan, mode: int, device: int) -> int:
    """Blocks of a kernel (``entry``: a key of PLAN_STRUCTS) in ``mode`` (0
    for the kernels with one) that ``device`` keeps resident on one SM at
    ``plan``'s threads and shared memory: the CUDA runtime's occupancy
    reckoning for the loaded function."""
    blocks = I(0)
    err = getattr(library(), f"{entry}_blocks_per_sm")(
        ctypes.byref(PLAN_STRUCTS[entry](*plan)), mode, device, ctypes.byref(blocks))
    check(err, f"{entry} occupancy")
    return blocks.value


def launch_target(what: str, dev) -> tuple[int, int]:
    """(device index, current stream) a kernel on ``dev`` launches on;
    raises ValueError for a device that is not CUDA."""
    import torch

    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error."""
    if err != 0:
        msg = library().rte_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
