"""Minimal netCDF reading without the netCDF4 library.

Copy of the reading side of rte_rrtmgp_nn_tpu/utils/ncio.py, which cannot
be imported without JAX. Two on-disk formats:
  - netCDF-4 (HDF5-based), via h5py, imported only when such a file is
    opened;
  - netCDF-3 classic, via scipy.io.

Arrays come back exactly as stored (C order): a variable the reference's
Fortran declares as ``var(a, b)`` appears here with shape ``(b, a)``.
"""
from __future__ import annotations

import numpy as np


class NCFile:
    """Uniform read access to a netCDF file (HDF5 or classic)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic.startswith(b"\x89HDF"):
            import h5py

            self._h5 = h5py.File(path, "r")
            self._nc3 = None
        elif magic.startswith(b"CDF"):
            from scipy.io import netcdf_file

            self._nc3 = netcdf_file(path, "r", mmap=False)
            self._h5 = None
        else:
            raise ValueError(f"{path}: not a netCDF file (magic {magic!r})")

    def __enter__(self) -> "NCFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
        if self._nc3 is not None:
            self._nc3.close()

    def has_var(self, name: str) -> bool:
        if self._h5 is not None:
            return name in self._h5
        return name in self._nc3.variables

    def dim_size(self, name: str) -> int:
        """Size of a named dimension."""
        if self._h5 is not None:
            # netCDF-4/HDF5: dimensions are scale datasets with the same name.
            if name in self._h5:
                d = self._h5[name]
                return int(d.shape[0]) if d.shape else 1
            for k in self._h5.keys():
                ds = self._h5[k]
                for i, dim in enumerate(ds.dims):
                    if dim.label == name:
                        return int(ds.shape[i])
            raise KeyError(f"{self.path}: no dimension {name!r}")
        size = self._nc3.dimensions.get(name)
        if size is None:
            raise KeyError(f"{self.path}: no dimension {name!r}")
        return int(size)

    def attr(self, var: str, name: str, default=None):
        """A variable attribute, or ``default`` when absent."""
        if self._h5 is not None:
            return self._h5[var].attrs.get(name, default)
        return getattr(self._nc3.variables[var], name, default)

    def read(self, name: str, dtype=None) -> np.ndarray:
        """Read a variable as a numpy array in stored (C) order."""
        if self._h5 is not None:
            if name not in self._h5:
                raise KeyError(f"{self.path}: no variable {name!r}")
            arr = np.asarray(self._h5[name][...])
        else:
            if name not in self._nc3.variables:
                raise KeyError(f"{self.path}: no variable {name!r}")
            arr = np.array(self._nc3.variables[name][...])  # copy out
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr

    def read_strings(self, name: str) -> list[str]:
        """Read a char-array or string variable as a list of python strings:
        the reference's ``(n, string_len)`` char layout or variable-length
        HDF5 strings."""
        if self._h5 is not None and name in self._h5:
            arr = self._h5[name][...]
        elif self._nc3 is not None and name in self._nc3.variables:
            arr = np.array(self._nc3.variables[name][...])
        else:
            raise KeyError(f"{self.path}: no variable {name!r}")

        def _decode(x) -> str:
            if isinstance(x, bytes):
                return x.decode("utf-8", "ignore").strip().strip("\x00").strip()
            return str(x).strip()

        if arr.dtype.kind == "O" or arr.dtype.kind == "U":
            return [_decode(x) for x in arr.ravel()]
        if arr.dtype.kind == "S" and arr.dtype.itemsize > 1:
            return [_decode(x) for x in arr.ravel()]
        if arr.ndim == 2 and arr.dtype.kind in ("S", "U"):
            out = []
            for row in arr:
                chars = [c.decode("utf-8", "ignore") if isinstance(c, bytes) else str(c) for c in row]
                out.append("".join(chars).strip().strip("\x00").strip())
            return out
        raise ValueError(f"{name}: cannot decode dtype {arr.dtype} shape {arr.shape} as strings")
