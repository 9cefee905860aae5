"""ctypes bindings for the native host runtime (native/rrtio.cpp).

Port of rte_rrtmgp_nn_tpu/utils/native.py, onto the same shared library
``native/librrtio.so``, built by ``native/Makefile`` the first time it is
missing. The C++ classic-netCDF reader, and the multithreaded feature
packing and col_dry of the host staging side: numpy in, numpy out, on the
host and never on the device path. ``available()`` says whether the
library loads; every other entry raises when it does not.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native", "librrtio.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        # try building it once; tolerate failure (fallback paths exist)
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.rrtio_open.restype = ctypes.c_void_p
    lib.rrtio_open.argtypes = [ctypes.c_char_p]
    lib.rrtio_close.argtypes = [ctypes.c_void_p]
    lib.rrtio_var_info.restype = ctypes.c_int
    lib.rrtio_var_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rrtio_dim_size.restype = ctypes.c_int64
    lib.rrtio_dim_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rrtio_read_f64.restype = ctypes.c_int64
    lib.rrtio_read_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.rrtio_pack_features.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rrtio_col_dry.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rrtio_n_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeNCFile:
    """Classic-netCDF reader backed by the C++ parser."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self._h = lib.rrtio_open(path.encode())
        if not self._h:
            raise IOError(f"cannot parse {path} as classic netCDF")

    def close(self):
        if self._h:
            self._lib.rrtio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def dim_size(self, name: str) -> int:
        n = self._lib.rrtio_dim_size(self._h, name.encode())
        if n < 0:
            raise KeyError(name)
        return int(n)

    def read(self, name: str) -> np.ndarray:
        dims = (ctypes.c_int64 * 8)()
        nd = self._lib.rrtio_var_info(self._h, name.encode(), dims)
        if nd < 0:
            raise KeyError(name)
        shape = tuple(int(dims[i]) for i in range(nd))
        out = np.empty(int(np.prod(shape)) if shape else 1, np.float64)
        n = self._lib.rrtio_read_f64(
            self._h, name.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size,
        )
        if n < 0:
            raise IOError(f"read failed for {name}")
        return out[:n].reshape(shape)


# feature kinds matching rrtio_pack_features
KIND_RAW_T, KIND_LOG_P, KIND_QUARTER_ROOT, KIND_RAW_VMR = 0, 1, 2, 3



def pack_features_native(
    columns: Sequence[np.ndarray],
    kinds: Sequence[int],
    fmin: np.ndarray,
    fmax: np.ndarray,
) -> np.ndarray:
    """Multithreaded feature packing: columns are (nbatch,) float64 arrays
    (one per feature, already flattened over col*lay)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    nbatch = columns[0].shape[0]
    nfeat = len(columns)
    cols = [np.ascontiguousarray(c, np.float64) for c in columns]
    ptrs = (ctypes.POINTER(ctypes.c_double) * nfeat)(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for c in cols]
    )
    kind_arr = np.asarray(kinds, np.int32)
    fmin32 = np.ascontiguousarray(fmin, np.float32)
    fmax32 = np.ascontiguousarray(fmax, np.float32)
    out = np.empty((nbatch, nfeat), np.float32)
    lib.rrtio_pack_features(
        nbatch, nfeat, ptrs,
        kind_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fmin32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fmax32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def col_dry_native(vmr_h2o: np.ndarray, plev: np.ndarray, grav=9.80665,
                   m_dry=0.028964, m_h2o=0.018016, avogad=6.02214076e23) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    ncol, nlay = vmr_h2o.shape
    q = np.ascontiguousarray(vmr_h2o, np.float64)
    pv = np.ascontiguousarray(plev, np.float64)
    out = np.empty((ncol, nlay), np.float64)
    lib.rrtio_col_dry(
        ncol, nlay,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        grav, m_dry, m_h2o, avogad,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
