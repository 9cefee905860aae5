"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` (Hopper) into one
shared library with a plain C interface, loaded with ctypes. The build runs
at the first CUDA use in a process, into ``build/kernels/`` beside the
package, under a name that hashes the sources, so an edited source is
rebuilt and an unchanged one is loaded as built. No ``--use_fast_math``:
exp, divide and sqrt stay IEEE (float32, except the SW kernel's two-stream
coefficients, which are float64).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=seconds, cached=False, path=str(out),
                      command=" ".join(cmd), log=proc.stdout + proc.stderr)
    return out


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lw_clearsky_mega4_launch.argtypes = (
        [P] * 21 + [I] * 9 + [F] * 5 + [I, P])
    lib.lw_clearsky_mega4_launch.restype = I
    lib.lw_clearsky_mega4_smem_bytes.argtypes = [I] * 5
    lib.lw_clearsky_mega4_smem_bytes.restype = ctypes.c_size_t
    lib.sw_clearsky_megakernel_launch.argtypes = (
        [P] * 29 + [I] * 9 + [F] * 2 + [I, P])
    lib.sw_clearsky_megakernel_launch.restype = I
    lib.sw_clearsky_megakernel_smem_bytes.argtypes = [I] * 7
    lib.sw_clearsky_megakernel_smem_bytes.restype = ctypes.c_size_t
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


def check(err: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error."""
    if err != 0:
        msg = library().rte_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
