"""The backward of training-mode BatchNorm with the ReLU after it: two
hand-written CUDA kernels, their plain PyTorch version, and the
``torch.autograd.Function`` that the models call on the card.

It replaces no TPU kernel (the JAX package leaves BatchNorm to XLA); it was
added because PyTorch's NCHW BatchNorm backward reduces each channel in one
block, which leaves most of the card idle at the few-channel, large layers
that hold most of the bytes. ``csrc/batchnorm.cu``'s header states what bounds
the kernels and what the design does about it.

:func:`batch_norm_backward` gives dx, dweight and dbias from x, dy and the
forward's saved mean and invstd; with the ReLU, ``g = dy`` where the
pre-activation recomputed from x, ``fmaf(x - mean, invstd w, b)``, is
positive (:func:`relu_mask`), and 0 elsewhere. The output is not kept for the
mask: kept, it is live through the backward beside x, dy and dx, which grew
the f32 step's CUDA graph pool from 5.0 to 7.2 GB. The forward that ran
rounds y its own way, so an element whose y lies within an f32 rounding of 0
can take the other side of the ReLU's kink than the forward (the card tests
count them). For a CUDA tensor it launches the kernels, or raises on what
they do not take (anything but a contiguous f32 or bf16 NCHW x with f32
parameters and statistics): there is no fallback. Sums are f32; dx has x's
type. dy may have any batch stride (a channel slice of a concat's gradient);
other layouts are made contiguous by :class:`BatchNormReLU`.
:func:`batch_norm_backward_plain` repeats the kernels' arithmetic in PyTorch,
for the tests.

:class:`BatchNormReLU`, what ``models/layers.py::BatchNorm2d`` runs in
training without a mesh on the card, leaves the forward to PyTorch's own
batch norm (the dispatch ``nn.BatchNorm2d`` takes: cuDNN for f32, ATen's
kernels for a bf16 input), then the ReLU in place, and takes the backward
kernels, which read that forward's saved mean and invstd. A forward of the
port's own rounds otherwise than ``nn.BatchNorm2d``, and one that differs by
an f32 rounding moves pixels of the first step's OD prediction across the
0.75 threshold that cuts the OC phases' ROI: the benchmark's output check,
which replays those steps with ``nn.BatchNorm2d``, then reads the OC nets'
gradients 10-1000x further from its reference than its limits allow
(``PERF.md``).

The split (:func:`splits`): every channel's N x HW values are cut into S
chunks, one block of 256 threads a chunk, so that C x S blocks cover the card
``WAVE_BLOCKS`` blocks an SM deep, and no block reads fewer than two 16-byte
vectors a thread. The split depends only on the shape, the element type and
the card's SM count.

:func:`batch_norm_backward` counts its launches, ``.launches`` (f32) and
``.launches_bf16`` (``ops/cuda_lib.py``). The library is built at first use
and loaded with ``ctypes``. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from wt_pse_tpu_torch.ops import cuda_lib

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "batchnorm.cu"
THREADS = 256        # a block (kThreads in the source)
WAVE_BLOCKS = 8      # blocks an SM the split aims for
MIN_VECTORS = 2 * THREADS  # vectors (16 bytes, or one value) a block reads at least
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = cuda_lib.build(SOURCE, "batchnorm")
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "bf16"):
        bw = getattr(lib, f"wtpse_bn_backward_{t}")
        bw.argtypes, bw.restype = [p] * 10 + [i] * 6 + [p], i
    return lib


# the library's name for each element type the kernels take
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def splits(n: int, c: int, hw: int, per: int, sms: int) -> int:
    """Chunks S each channel is cut into, for a (n, c, hw) map read ``per``
    values a load on a card of ``sms`` SMs: enough that c x S blocks give
    every SM ``WAVE_BLOCKS`` of them, as long as each block reads at least
    ``MIN_VECTORS`` loads."""
    vectors = n * hw // per
    want = -(-WAVE_BLOCKS * sms // c)
    return max(1, min(want, vectors // MIN_VECTORS))


def _per_load(t: torch.Tensor, hw: int) -> int:
    """Values a load of the kernels' variant for ``t``: 16 bytes where HW and
    the batch stride are multiples of it and the data is 16-byte aligned,
    else one. (The library picks the same variant; S depends on it.)"""
    per = 16 // t.element_size()
    ok = hw % per == 0 and t.stride(0) % per == 0 and t.data_ptr() % 16 == 0
    return per if ok else 1


def _check(x: torch.Tensor, *params: torch.Tensor) -> tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"batch-norm kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"batch-norm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("batch-norm kernels take a contiguous NCHW tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    if n * h * w < 2 or c < 1 or x.numel() > _INT_MAX:
        raise ValueError(f"batch-norm kernels take more than 1 value a channel and fewer "
                         f"than 2**31 values, got shape {tuple(x.shape)}")
    for p in params:
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous() \
                or p.device != x.device:
            raise ValueError(f"batch-norm kernels take contiguous float32 ({c},) parameters "
                             f"and statistics on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    return n, c, h * w


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def relu_mask(x, mean, invstd, weight, bias) -> torch.Tensor:
    """Where the kernels pass dy: their pre-activation ``fmaf(x - mean, invstd
    w, b)`` is not <= 0. x - mean and invstd w are f32 (f64 for an f64 x) as
    in the kernels; the product and the sum in f64 give the fused result's
    sign exactly for f32 factors."""
    xm = x.to(torch.promote_types(x.dtype, torch.float32)) - _col(mean)
    pre = xm.double() * _col(invstd * weight).double() + _col(bias).double()
    return ~(pre <= 0)


def batch_norm_backward_plain(x, dy, mean, invstd, weight, bias, relu: bool):
    """(dx, dweight, dbias) as :func:`batch_norm_backward`, in plain PyTorch:
    f32 arithmetic (f64 stays f64; bf16 is widened, and dx is rounded back to
    bf16 once)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xm = x.to(dt) - _col(mean)
    g = dy.to(dt)
    if relu:
        g = torch.where(relu_mask(x, mean, invstd, weight, bias), g, 0)
    m = x.numel() // x.shape[1]
    sg, sgx = g.sum((0, 2, 3)), (g * xm).sum((0, 2, 3))
    dx = (g - _col(sg / m) - xm * _col(invstd * invstd * sgx / m)) * _col(invstd * weight)
    return dx.to(x.dtype), (sgx * invstd).to(weight.dtype), sg.to(weight.dtype)


def batch_norm_backward(x, dy, mean, invstd, weight, bias, relu: bool):
    """(dx, dweight, dbias) of training-mode batch norm at x for the upstream
    gradient dy, from the forward's saved mean and invstd; with ``relu``, dy
    passes where :func:`relu_mask` is true. dx has x's type and is
    contiguous; dweight and dbias are f32."""
    n, c, hw = _check(x, mean, invstd, weight, bias)
    h, w = x.shape[2:]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or dy.stride()[1:] != (hw, w, 1) or dy.stride(0) < c * hw \
            or dy.storage_offset() + (n - 1) * dy.stride(0) + c * hw > _INT_MAX:
        raise ValueError(f"batch-norm backward takes a {x.dtype} dy of shape "
                         f"{tuple(x.shape)} on {x.device} with rows of HW values at channel "
                         f"stride HW, got {dy.dtype} {tuple(dy.shape)} strides {dy.stride()} "
                         f"on {dy.device}")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        per = min(_per_load(x, hw), _per_load(dy, hw))
        s = splits(n, c, hw, per, _sm_count(dev.index))
        partial = torch.empty(2 * c * s, dtype=torch.float32, device=dev)
        dx = torch.empty_like(x)
        dweight = torch.empty(c, dtype=torch.float32, device=dev)
        dbias = torch.empty_like(dweight)
        rc = getattr(lib, f"wtpse_bn_backward_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(), mean.data_ptr(),
            invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), n, c, hw, dy.stride(0), s, int(relu),
            cuda_lib.raw_stream(dev.index))
    cuda_lib.raise_on(rc, "batch-norm backward")
    cuda_lib.count(batch_norm_backward, x.dtype)
    return dx, dweight, dbias


batch_norm_backward.launches = 0
batch_norm_backward.launches_bf16 = 0


def forward_library(x, weight, bias, running_mean, running_var, num_batches_tracked,
                    momentum: float, eps: float, relu: bool):
    """(y, mean, invstd) by the batch norm ``nn.BatchNorm2d`` runs in
    training (``torch._batch_norm_impl_index``, the dispatch of
    ``F.batch_norm``), with ``num_batches_tracked`` counted, then the ReLU,
    in place on y, which nothing else holds."""
    y, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, weight, bias, running_mean, running_var, True, momentum, eps,
        torch.backends.cudnn.enabled)
    with torch.no_grad():
        num_batches_tracked.add_(1)
    return (y.relu_() if relu else y), mean, invstd


class BatchNormReLU(torch.autograd.Function):
    """Training-mode BatchNorm (+ ReLU) on the card: the forward by
    :func:`forward_library`, the backward by :func:`batch_norm_backward`'s
    kernels. x, the parameters and the saved statistics are kept for the
    backward, so callers must not modify x in place afterwards. The running
    statistics and ``num_batches_tracked`` are updated in place, under
    ``no_grad`` too."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                momentum: float, eps: float, relu: bool):
        y, mean, invstd = forward_library(x, weight, bias, running_mean, running_var,
                                          num_batches_tracked, momentum, eps, relu)
        ctx.save_for_backward(x, mean, invstd, weight, bias)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight, bias = ctx.saved_tensors
        if dy.stride()[1:] != x.stride()[1:] or dy.stride(0) < x.stride(0):
            dy = dy.contiguous()
        dx, dweight, dbias = batch_norm_backward(x, dy, mean, invstd, weight, bias, ctx.relu)
        return dx, dweight, dbias, None, None, None, None, None, None
