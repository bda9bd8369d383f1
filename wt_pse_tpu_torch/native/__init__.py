"""Native (C++) eval operators with ctypes bindings (counterpart of
``wt_pse_tpu/native/``).

``csrc/evalops.cpp`` is compiled with the system C++ compiler at first use
into ``build/native/`` at the root of the checkout, named by the hash of the
source, so an edit rebuilds. Nothing is built or loaded at import.

The build is race-free between processes: it holds an exclusive
``fcntl.flock`` on ``evalops.lock`` in the build directory, compiles to a
temporary name and moves the library into place with ``os.replace``. A
library under its final name is therefore always a whole file, and a process
that waited on the lock finds it there and loads it.

A failed build or load is not swallowed: :func:`load` raises
:class:`NativeUnavailable` with the reason, and the reason is kept
(:func:`unavailable_reason`) so that a caller that chose the scipy paths
instead can say why. :func:`scoring_backend` resolves the backend the
metrics and post-processing run on.

Exposed:
  largest_component_fill_holes_native(mask)  -> cleaned uint8 mask
  edt_native(mask)                           -> float32 distances to nearest ON
  surface_distances_native(a, b)             -> 1-D float32 distances (medpy
                                                semantics), raises on empty input
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "evalops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
BACKENDS = ("auto", "native", "scipy")


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


# the process's loaded library, or the reason it could not be loaded
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libwtpse_evalops_{digest}.so"


def build() -> Path:
    """Compile ``csrc/evalops.cpp`` unless a library of the same source is
    already built; returns its path. Raises ``RuntimeError`` when no compiler
    is found or the compile fails."""
    lib = library_path()
    if lib.exists():  # only ever made by os.replace of a finished file
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "evalops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, f32p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.largest_component_fill_holes.argtypes = [u8p, i, i]
    lib.largest_component_fill_holes.restype = i
    lib.edt.argtypes = [u8p, i, i, f32p]
    lib.edt.restype = None
    lib.surface_distances.argtypes = [u8p, u8p, i, i, f32p]
    lib.surface_distances.restype = ctypes.c_int64
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built at the first call. Raises
    :class:`NativeUnavailable` with the reason if it cannot be built or
    loaded; a failure is remembered and not retried in this process."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise NativeUnavailable(_error)
    try:
        _lib = _bind(ctypes.CDLL(str(build())))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        raise NativeUnavailable(_error) from e
    return _lib


def available() -> bool:
    """Whether the library builds and loads (building it if needed)."""
    try:
        load()
    except NativeUnavailable:
        return False
    return True


def unavailable_reason() -> str | None:
    """Why the library did not load, if it was tried and failed."""
    return _error


def scoring_backend(requested: str = "auto") -> str:
    """The backend the eval metrics and post-processing run on: ``'native'``
    (raises :class:`NativeUnavailable` if it cannot load), ``'scipy'``, or
    ``'auto'``: native when it loads, else scipy, the reason kept in
    :func:`unavailable_reason`."""
    if requested not in BACKENDS:
        raise ValueError(f"scoring backend must be one of {BACKENDS}, got {requested!r}")
    if requested == "native":
        load()
        return "native"
    if requested == "auto":
        return "native" if available() else "scipy"
    return "scipy"


def _as_u8(mask) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"native eval operators take a 2-D mask, got shape {m.shape}")
    return m


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def largest_component_fill_holes_native(mask) -> np.ndarray:
    """Keep the largest 8-connected component (first in raster order on a
    tie), then fill holes (4-connected background flood)."""
    m = _as_u8(mask)  # a new array: cleaned in place
    h, w = m.shape
    load().largest_component_fill_holes(_u8p(m), h, w)
    return m


def edt_native(mask) -> np.ndarray:
    """Euclidean distance of every pixel to the nearest ON pixel (inf if
    there is none), float32."""
    m = _as_u8(mask)
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    load().edt(_u8p(m), h, w, _f32p(out))
    return out


def surface_distances_native(a, b) -> np.ndarray:
    """Distances from each surface pixel of ``a`` to the nearest surface pixel
    of ``b`` (float32, raster order). Raises ``ValueError`` on an empty mask."""
    ma, mb = _as_u8(a), _as_u8(b)
    if ma.shape != mb.shape:
        raise ValueError(f"mask shapes differ: {ma.shape} vs {mb.shape}")
    h, w = ma.shape
    out = np.empty(h * w, np.float32)
    n = load().surface_distances(_u8p(ma), _u8p(mb), h, w, _f32p(out))
    if n < 0:
        raise ValueError("empty mask")
    return out[:n]
