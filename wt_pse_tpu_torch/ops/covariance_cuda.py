"""The per-sample feature covariance: two hand-written CUDA kernels, their plain
PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``wt_pse_tpu/ops/whitening_pallas.py`` (the ``jax.custom_vjp``
``feature_covariance_pallas`` around the ``_gram`` and ``_dz`` Pallas kernels).
The kernels live in ``csrc/covariance.cu``; its header states what bounds them
on the card and what the design does about it.

- :func:`covariance_forward` — ``cov = Z Zᵀ / (HW-1) + 1e-5·I`` for each sample
  of an NCHW map ``z`` (B, C, H, W).
- :func:`covariance_backward` — ``dz = S Z`` with ``S = (g + gᵀ) / (HW-1)``.

Each wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel, or raises on what the kernel does not take
(anything but contiguous f32 NCHW with C <= 32): there is no fallback. The
library picks each kernel's 16-byte variant when HW % 4 == 0 and the pointers
are 16-byte aligned, and the same kernel's 4-byte variant otherwise. Each
wrapper counts its launches in ``.launches``, a plain integer.

The library is built with ``nvcc`` at first use into ``build/kernels/`` at the
root of the checkout (named by the hash of the source, so an edit rebuilds),
and loaded with ``ctypes``. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

EPS = 1e-5
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "covariance.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: the compiler output reports each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build() -> tuple[Path, str]:
    """Compile ``csrc/covariance.cu`` unless a library of the same source is
    already built. Returns the library's path and the compiler's output (empty
    when nothing was compiled)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libwtpse_covariance_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wtpse_covariance_gram_chunks.argtypes = [i, i, i]
    lib.wtpse_covariance_gram_chunks.restype = i
    lib.wtpse_covariance_max_c.argtypes = []
    lib.wtpse_covariance_max_c.restype = i
    lib.wtpse_covariance_gram_f32.argtypes = [p, p, p, i, i, i, ctypes.c_float, p]
    lib.wtpse_covariance_gram_f32.restype = i
    lib.wtpse_covariance_dz_f32.argtypes = [p, p, p, i, i, i, p]
    lib.wtpse_covariance_dz_f32.restype = i
    return lib


@functools.cache
def _max_c() -> int:
    return _library().wtpse_covariance_max_c()


@functools.lru_cache(maxsize=256)
def _gram_chunks(device_index: int, b: int, c: int, hw: int) -> int:
    """Chunks the library cuts each sample into on this device (it sizes them
    to fill the card once); called with that device current."""
    n_chunks = _library().wtpse_covariance_gram_chunks(b, c, hw)
    _raise_on(-n_chunks if n_chunks < 1 else 0, "covariance gram planning")
    return n_chunks


def _check_cuda_input(z: torch.Tensor) -> tuple[int, int, int]:
    if z.device.type != "cuda":
        raise ValueError(f"covariance kernels take CUDA or CPU tensors, got {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"covariance kernels take float32, got {z.dtype}")
    if z.dim() != 4 or not z.is_contiguous():
        raise ValueError("covariance kernels take a contiguous NCHW tensor, got "
                         f"shape {tuple(z.shape)} strides {z.stride()}")
    b, c, h, w = z.shape
    if not 1 <= c <= _max_c() or h * w < 2 or b < 1:
        raise ValueError(f"covariance kernels take 1 <= C <= {_max_c()}, HW >= 2 and "
                         f"B >= 1; got shape {tuple(z.shape)}")
    return b, c, h * w


def _raw_stream(device_index: int) -> int:
    """The current stream of a CUDA device as a ``cudaStream_t`` handle. The
    accessor that torch's own generated kernel launchers use: it builds no
    ``torch.cuda.Stream`` object, which costs microseconds a call."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


# -- plain versions: exact f32 (f64 stays f64) -------------------------------


def _plain_dtype(z: torch.Tensor) -> torch.dtype:
    return torch.float64 if z.dtype == torch.float64 else torch.float32


def covariance_forward_plain(z: torch.Tensor) -> torch.Tensor:
    b, c, h, w = z.shape
    f = z.reshape(b, c, h * w).to(_plain_dtype(z))
    cov = torch.einsum("bcp,bdp->bcd", f, f) / (h * w - 1)
    return cov + EPS * torch.eye(c, dtype=f.dtype, device=z.device)


def covariance_backward_plain(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, c, h, w = z.shape
    dt = _plain_dtype(z)
    s = (g + g.transpose(1, 2)).to(dt) / (h * w - 1)
    dz = torch.bmm(s, z.reshape(b, c, h * w).to(dt))
    return dz.reshape(z.shape).to(z.dtype)


# -- the wrappers --------------------------------------------------------------


def covariance_forward(z: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) covariance ``Z Zᵀ / (HW-1) + 1e-5·I``."""
    if z.device.type == "cpu":
        return covariance_forward_plain(z)
    lib = _library()
    b, c, hw = _check_cuda_input(z)
    dev = z.device
    with torch.cuda.device(dev):
        n_chunks = _gram_chunks(dev.index, b, c, hw)
        partial = torch.empty((b, n_chunks, c * c), dtype=torch.float32, device=dev)
        cov = torch.empty((b, c, c), dtype=torch.float32, device=dev)
        stream = _raw_stream(dev.index)
        rc = lib.wtpse_covariance_gram_f32(z.data_ptr(), partial.data_ptr(),
                                           cov.data_ptr(), b, c, hw, EPS, stream)
    _raise_on(rc, "covariance gram")
    covariance_forward.launches += 1
    return cov


covariance_forward.launches = 0


def covariance_backward(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dz = S Z with S = (g + gᵀ) / (HW-1): the gradient of
    :func:`covariance_forward` at ``z`` for the upstream gradient ``g``."""
    if z.device.type == "cpu":
        return covariance_backward_plain(z, g)
    lib = _library()
    b, c, hw = _check_cuda_input(z)
    if g.shape != (b, c, c) or g.dtype != torch.float32 or not g.is_contiguous() \
            or g.device != z.device:
        raise ValueError(f"covariance dz kernel takes a contiguous float32 "
                         f"(B, C, C) gradient on {z.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    dz = torch.empty_like(z)
    dev = z.device
    with torch.cuda.device(dev):
        stream = _raw_stream(dev.index)
        rc = lib.wtpse_covariance_dz_f32(z.data_ptr(), g.data_ptr(), dz.data_ptr(),
                                         b, c, hw, stream)
    _raise_on(rc, "covariance dz")
    covariance_backward.launches += 1
    return dz


covariance_backward.launches = 0


class Covariance(torch.autograd.Function):
    """Forward: kernel 1 (the Gram); backward: kernel 2 (dz). The JAX
    ``custom_vjp`` ``feature_covariance_pallas`` is the model. ``z`` is saved
    for the backward, so callers must not modify it in place afterwards."""

    @staticmethod
    def forward(ctx, z: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(z)
        return covariance_forward(z)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (z,) = ctx.saved_tensors
        return covariance_backward(z, g.contiguous())
