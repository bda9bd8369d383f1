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
(anything but contiguous f32 or bf16 NCHW with C <= 32): there is no fallback,
and a bf16 map goes into the kernel as bf16, with no f32 copy. The covariance
is f32 for either; dz has z's type. The library picks each kernel's 16-byte
variant when HW is a multiple of the values in 16 bytes (4 f32, 8 bf16) and
the pointers are 16-byte aligned, and the same kernel's narrow variant
otherwise; a bf16 z with C = 16 takes the tensor-core kernels in the 16-byte
case. Each wrapper counts its launches, a plain integer for each element
type: ``.launches`` (f32) and ``.launches_bf16``, which ``train/graph.py``
keeps across a CUDA graph's replays (``ops/cuda_lib.py``).

The library is built with ``nvcc`` at first use (``ops/cuda_lib.py::build``)
and loaded with ``ctypes``. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from wt_pse_tpu_torch.ops import cuda_lib
from wt_pse_tpu_torch.ops.cuda_lib import raise_on, raw_stream

EPS = 1e-5
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "covariance.cu"


def build() -> tuple[Path, str]:
    """Compile ``csrc/covariance.cu`` unless it is built (:func:`cuda_lib.build`)."""
    return cuda_lib.build(SOURCE, "covariance")


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wtpse_covariance_gram_chunks.argtypes = [i, i, i, i, i]
    lib.wtpse_covariance_gram_chunks.restype = i
    lib.wtpse_covariance_max_c.argtypes = []
    lib.wtpse_covariance_max_c.restype = i
    for t in ("f32", "bf16"):
        gram = getattr(lib, f"wtpse_covariance_gram_{t}")
        gram.argtypes, gram.restype = [p, p, p, i, i, i, ctypes.c_float, p], i
        dz = getattr(lib, f"wtpse_covariance_dz_{t}")
        dz.argtypes, dz.restype = [p, p, p, i, i, i, p], i
    return lib


# the library's name for each element type the kernels take
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _max_c() -> int:
    return _library().wtpse_covariance_max_c()


@functools.lru_cache(maxsize=256)
def _gram_chunks(device_index: int, elem_bytes: int, b: int, c: int, hw: int,
                 aligned: bool) -> int:
    """Chunks the library cuts each sample into on this device (it sizes them
    to fill the card once), for a z of ``elem_bytes`` a value whose data is
    16-byte ``aligned`` or not (a bf16 z takes the tensor-core Gram, with its
    own tiles, when C = 16, HW % 8 == 0 and it is aligned); called with that
    device current."""
    n_chunks = _library().wtpse_covariance_gram_chunks(b, c, hw, elem_bytes, int(aligned))
    raise_on(-n_chunks if n_chunks < 1 else 0, "covariance gram planning")
    return n_chunks


def _check_cuda_input(z: torch.Tensor) -> tuple[int, int, int]:
    if z.device.type != "cuda":
        raise ValueError(f"covariance kernels take CUDA or CPU tensors, got {z.device}")
    if z.dtype not in _SUFFIX:
        raise TypeError(f"covariance kernels take float32 or bfloat16, got {z.dtype}")
    if z.dim() != 4 or not z.is_contiguous():
        raise ValueError("covariance kernels take a contiguous NCHW tensor, got "
                         f"shape {tuple(z.shape)} strides {z.stride()}")
    b, c, h, w = z.shape
    if not 1 <= c <= _max_c() or h * w < 2 or b < 1:
        raise ValueError(f"covariance kernels take 1 <= C <= {_max_c()}, HW >= 2 and "
                         f"B >= 1; got shape {tuple(z.shape)}")
    return b, c, h * w


# -- plain versions: exact f32 (f64 stays f64; bf16 is widened, and dz is
# rounded back to bf16 once) --------------------------------------------------


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
        n_chunks = _gram_chunks(dev.index, z.element_size(), b, c, hw,
                                z.data_ptr() % 16 == 0)
        partial = torch.empty((b, n_chunks, c * c), dtype=torch.float32, device=dev)
        cov = torch.empty((b, c, c), dtype=torch.float32, device=dev)
        stream = raw_stream(dev.index)
        suffix = _SUFFIX[z.dtype]
        rc = getattr(lib, f"wtpse_covariance_gram_{suffix}")(
            z.data_ptr(), partial.data_ptr(), cov.data_ptr(), b, c, hw, EPS, stream)
    raise_on(rc, "covariance gram")
    cuda_lib.count(covariance_forward, z.dtype)
    return cov


covariance_forward.launches = 0
covariance_forward.launches_bf16 = 0


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
        stream = raw_stream(dev.index)
        suffix = _SUFFIX[z.dtype]
        rc = getattr(lib, f"wtpse_covariance_dz_{suffix}")(
            z.data_ptr(), g.data_ptr(), dz.data_ptr(), b, c, hw, stream)
    raise_on(rc, "covariance dz")
    cuda_lib.count(covariance_backward, z.dtype)
    return dz


covariance_backward.launches = 0
covariance_backward.launches_bf16 = 0


class Covariance(torch.autograd.Function):
    """Forward: kernel 1 (the Gram); backward: kernel 2 (dz). The JAX
    ``custom_vjp`` ``feature_covariance_pallas`` is the model. ``z`` is saved
    for the backward, so callers must not modify it in place afterwards. It
    takes ``z`` in the type it comes in, bf16 under autocast too: no
    ``custom_fwd(cast_inputs=...)`` widens it before the kernel."""

    @staticmethod
    def forward(ctx, z: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(z)
        return covariance_forward(z)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (z,) = ctx.saved_tensors
        return covariance_backward(z, g.contiguous())
