"""The 2x bilinear upsample of the U-Net decoders (``align_corners=False``):
two hand-written CUDA kernels, their plain PyTorch version, and the
``torch.autograd.Function`` that ``models/layers.py::upsample2x`` calls.

It replaces no TPU kernel (the JAX package leaves the resize to XLA); it was
added because PyTorch's NCHW bilinear upsample gives one thread to each
output pixel and loops it over every image and channel, its backward
zero-fills the gradient and scatters into it with atomic adds, and the bf16
training mode resized in two such passes. ``csrc/upsample.cu``'s header
states what bounds the kernels and what the design does about it.

- :func:`upsample2x_forward`: y (N, C, 2H, 2W) from x (N, C, H, W) with
  ATen's weights and clamped source indices. A bf16 x is resized one axis at
  a time, rows then columns, each pass in f32 and rounded to bf16: bit for
  bit ``F.interpolate(scale_factor=(2, 1))`` then ``(1, 2)``, the policy of
  the port's bf16 mode (``models/layers.py`` docstring). An f32 x is resized
  in one pass, with ATen's expression contracted into fused multiply-adds as
  the kernel of ``F.interpolate(scale_factor=2)`` has it.
- :func:`upsample2x_backward`: dx from dy by a gather, each input pixel
  summing its 4 x 4 neighbourhood of dy in f32 (weights 0.25, 0.75, 0.75,
  0.25 along each axis; at an edge 1 for the edge output and 0 past it),
  every product and sum rounded on its own, and dx written once in dy's
  type. No atomics: two calls give the same bits. In bf16 this is the exact
  gradient of the two-pass forward, rounded once.

Both take a contiguous f32 or bf16 CUDA tensor of fewer than 2**31 output
values and raise on anything else: there is no fallback.
:func:`upsample2x_forward_plain` is the ``F.interpolate`` call (two passes in
bf16) that the forward kernel equals bit for bit, and what
``models/layers.py`` runs on a CPU tensor, with its own autograd.
:func:`upsample2x_backward_plain` repeats the backward kernel's arithmetic in
PyTorch, bit for bit (f64 too, computed in f64).

:class:`Upsample2x` joins the kernels on a CUDA tensor and the plain
versions on a CPU tensor (what the CPU tests hold the gather to); it saves
nothing for the backward but the shape.
:func:`upsample2x_forward` and :func:`upsample2x_backward` count their
launches, ``.launches`` (f32) and ``.launches_bf16`` (``ops/cuda_lib.py``).
The library is built at first use and loaded with ``ctypes``. Nothing is
built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from wt_pse_tpu_torch.ops import cuda_lib

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "upsample.cu"
_INT_MAX = 2 ** 31 - 1
# the library's name for each element type the kernels take
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = cuda_lib.build(SOURCE, "upsample")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for way in ("forward", "backward"):
        for t in _SUFFIX.values():
            fn = getattr(lib, f"wtpse_upsample2x_{way}_{t}")
            fn.argtypes, fn.restype = [p, p, i, i, i, p], i
    return lib


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"upsample kernels take CUDA tensors, got {t.device}")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"upsample kernels take float32 or bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"upsample kernels take a contiguous non-empty NCHW {what}, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _launch(way: str, src: torch.Tensor, dst: torch.Tensor, n: int, c: int, h: int, w: int):
    """Runs kernel ``way`` from ``src`` into ``dst``; (h, w) is the small
    map's size."""
    dev = src.device
    with torch.cuda.device(dev):
        rc = getattr(_library(), f"wtpse_upsample2x_{way}_{_SUFFIX[src.dtype]}")(
            src.data_ptr(), dst.data_ptr(), n * c, h, w, cuda_lib.raw_stream(dev.index))
    cuda_lib.raise_on(rc, f"upsample {way}")


def upsample2x_forward(x: torch.Tensor) -> torch.Tensor:
    """The 2x bilinear upsample of a contiguous f32 or bf16 CUDA x (module
    docstring); the result has x's type."""
    _check(x, "x")
    n, c, h, w = x.shape
    if 4 * x.numel() > _INT_MAX:
        raise ValueError(f"upsample kernels take fewer than 2**31 output values, got shape "
                         f"{tuple(x.shape)}")
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    _launch("forward", x, y, n, c, h, w)
    cuda_lib.count(upsample2x_forward, x.dtype)
    return y


upsample2x_forward.launches = 0
upsample2x_forward.launches_bf16 = 0


def upsample2x_backward(dy: torch.Tensor) -> torch.Tensor:
    """The upsample's input gradient from a contiguous f32 or bf16 CUDA dy
    of even height and width (module docstring); dx has dy's type."""
    _check(dy, "dy")
    n, c, h2, w2 = dy.shape
    if h2 % 2 or w2 % 2 or dy.numel() > _INT_MAX:
        raise ValueError(f"upsample backward takes a dy of even sides and fewer than 2**31 "
                         f"values, got shape {tuple(dy.shape)}")
    dx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=dy.dtype, device=dy.device)
    _launch("backward", dy, dx, n, c, h2 // 2, w2 // 2)
    cuda_lib.count(upsample2x_backward, dy.dtype)
    return dx


upsample2x_backward.launches = 0
upsample2x_backward.launches_bf16 = 0


# -- the plain version --------------------------------------------------------


def upsample2x_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`upsample2x_forward` in PyTorch, for x of any device: a bf16 x
    rows then columns, each pass rounded to bf16; any other x in one pass."""
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, scale_factor=(2, 1), mode="bilinear", align_corners=False)
        return F.interpolate(x, scale_factor=(1, 2), mode="bilinear", align_corners=False)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _gather_weights(n: int, dtype, device) -> list[torch.Tensor]:
    """For each input index i of ``n``, the weights of output indices 2i - 1
    .. 2i + 2: (0.25, 0.75, 0.75, 0.25), and at an edge 1 for the edge output
    and 0 past it."""
    i = torch.arange(n, device=device)
    lo, hi = i >= 1, i <= n - 2
    one = torch.ones(n, dtype=dtype, device=device)
    return [torch.where(lo, 0.25, 0.0).to(dtype), torch.where(lo, 0.75, one),
            torch.where(hi, 0.75, one), torch.where(hi, 0.25, 0.0).to(dtype)]


def upsample2x_backward_plain(dy: torch.Tensor) -> torch.Tensor:
    """:func:`upsample2x_backward` in PyTorch, for dy of any device: the
    vertical sums of each column first, then the horizontal ones, in f32
    (f64 for an f64 dy), ``((w0 a + w1 b) + w2 c) + w3 d`` each."""
    n, c, h2, w2 = dy.shape
    h, w = h2 // 2, w2 // 2
    dt = torch.promote_types(dy.dtype, torch.float32)
    g = F.pad(dy.to(dt), (1, 1, 1, 1))  # output rows and columns -1 and 2n as zeros
    wy = [t[:, None] for t in _gather_weights(h, dt, dy.device)]
    wx = _gather_weights(w, dt, dy.device)
    rows = [g[:, :, t:t + h2:2] for t in range(4)]
    v = ((wy[0] * rows[0] + wy[1] * rows[1]) + wy[2] * rows[2]) + wy[3] * rows[3]
    cols = [v[..., t:t + w2:2] for t in range(4)]
    dx = ((wx[0] * cols[0] + wx[1] * cols[1]) + wx[2] * cols[2]) + wx[3] * cols[3]
    return dx.to(dy.dtype)


class Upsample2x(torch.autograd.Function):
    """The 2x bilinear upsample under autograd: the kernels on a CUDA
    tensor (f32 or bf16), the plain versions on a CPU tensor. A
    non-contiguous x or dy is made contiguous first."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        return upsample2x_forward(x) if x.is_cuda else upsample2x_forward_plain(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        return upsample2x_backward(dy) if dy.is_cuda else upsample2x_backward_plain(dy)
