"""Training-mode BatchNorm with the ReLU after it: hand-written CUDA kernels
for the forward (f32) and the backward, their plain PyTorch versions, and
the ``torch.autograd.Function`` that the models call on the card.

It replaces no TPU kernel (the JAX package leaves BatchNorm to XLA); it was
added because PyTorch's NCHW BatchNorm reduces each channel in one block,
which leaves most of the card idle at the few-channel, large layers that hold
most of the bytes, and runs the ReLU as passes of their own.
``csrc/batchnorm.cu``'s header states what bounds the kernels and what the
design does about it.

:func:`batch_norm_forward` gives y, the saved mean and invstd (biased
variance) of an f32 x, and updates the running statistics (the unbiased
variance, at ``momentum``) and ``num_batches_tracked`` in place; with the
ReLU, y is 0 where the pre-activation ``fmaf(x - mean, invstd w, b)`` is
<= 0. :func:`batch_norm_backward` gives dx, dweight and dbias from x, dy and
the forward's saved mean and invstd; with the ReLU, ``g = dy`` where that
pre-activation, recomputed from x, is positive (:func:`relu_mask`), and 0
elsewhere. The output is not kept for the mask: kept, it is live through the
backward beside x, dy and dx, which grew the f32 step's CUDA graph pool from
5.0 to 7.2 GB. After the forward kernels the two sides of the kink agree bit
for bit; after another forward (the library's, in bf16), an element whose y
lies within a rounding of 0 can take the other side (the card tests count
them). For a CUDA tensor each wrapper launches its kernels, or raises on
what they do not take (anything but a contiguous NCHW x, f32 for the forward
and f32 or bf16 for the backward, with f32 parameters and statistics): there
is no fallback. Sums are f32; dx has x's type. dy may have any batch stride
(a channel slice of a concat's gradient); other layouts are made contiguous
by :class:`BatchNormReLU`. :func:`batch_norm_forward_plain` and
:func:`batch_norm_backward_plain` repeat the kernels' arithmetic in PyTorch,
for the tests; the forward's down to the order of every rounding.

:class:`BatchNormReLU`, what ``models/layers.py::BatchNorm2d`` runs in
training without a mesh on the card, takes the forward kernels for an f32 x
and otherwise PyTorch's own batch norm (:func:`forward_library`: the
dispatch ``nn.BatchNorm2d`` takes, ATen's kernels for a bf16 input) and the
ReLU in place; then the backward kernels, which read the forward's saved
mean and invstd. A bf16 forward of the port's own rounds otherwise than
``nn.BatchNorm2d``, and whole bf16 buckets of the first step's OD
predictions sit on the 0.75 threshold that cuts the OC phases' ROI: the
benchmark's bf16 output check, which replays those steps with
``nn.BatchNorm2d``, holds the OC side to the library's rounding
(``PERF.md``). Its f32 check admits a forward that rounds otherwise.

The split (:func:`splits`): every channel's N x HW values are cut into S
chunks, one block of 256 threads a chunk, so that C x S blocks cover the card
``WAVE_BLOCKS`` blocks an SM deep, and no block reads fewer than two 16-byte
vectors a thread. The split depends only on the shape, the element type and
the card's SM count.

The wrappers count their launches, ``.launches`` (f32) and
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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wtpse_bn_forward_f32.argtypes = [p] * 10 + [i] * 4 + [f] * 2 + [i, p]
    lib.wtpse_bn_forward_f32.restype = i
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
    if x.device.type != "cuda":
        raise ValueError(f"batch-norm kernels take CUDA tensors, got {x.device}")
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


def batch_norm_forward(x, weight, bias, running_mean, running_var, num_batches_tracked,
                       momentum: float, eps: float, relu: bool):
    """(y, mean, invstd) of training-mode batch norm of an f32 x, with the
    ReLU when ``relu``, by the forward kernels: y contiguous f32, the saved
    mean and invstd (biased variance) f32; ``running_mean`` and
    ``running_var`` are updated in place (the unbiased variance, at
    ``momentum``), ``num_batches_tracked`` (one int64) incremented."""
    if x.dtype != torch.float32:
        raise TypeError(f"the batch-norm forward kernels take float32, got {x.dtype}")
    n, c, hw = _check(x, weight, bias, running_mean, running_var)
    if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.numel() != 1 \
            or num_batches_tracked.device != x.device:
        raise ValueError(f"batch-norm forward takes one int64 num_batches_tracked on "
                         f"{x.device}, got {num_batches_tracked.dtype} "
                         f"{tuple(num_batches_tracked.shape)} on {num_batches_tracked.device}")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        s = splits(n, c, hw, _per_load(x, hw), _sm_count(dev.index))
        partial = torch.empty(2 * c * s, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        mean = torch.empty(c, dtype=torch.float32, device=dev)
        invstd = torch.empty_like(mean)
        rc = lib.wtpse_bn_forward_f32(
            x.data_ptr(), y.data_ptr(), partial.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), invstd.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), num_batches_tracked.data_ptr(), n, c, hw, s,
            momentum, eps, int(relu), cuda_lib.raw_stream(dev.index))
    cuda_lib.raise_on(rc, "batch-norm forward")
    cuda_lib.count(batch_norm_forward, x.dtype)
    return y, mean, invstd


batch_norm_forward.launches = 0
batch_norm_forward.launches_bf16 = 0


def thread_vectors(vectors: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Which of a channel's ``vectors`` loads each thread of the kernels
    reads, in its order, for ``s`` chunks: (index, valid), each (s, THREADS,
    K). Chunk k holds loads [k vectors / s, (k + 1) vectors / s), and thread t
    of its block those j0 + t + i THREADS; where valid is false, index is 0."""
    k = torch.arange(s)
    j0, j1 = k * vectors // s, (k + 1) * vectors // s
    most = -(-int((j1 - j0).max()) // THREADS)
    idx = j0[:, None, None] + torch.arange(THREADS)[:, None] + THREADS * torch.arange(most)
    valid = idx < j1[:, None, None]
    return torch.where(valid, idx, 0), valid


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernels' ``block_sum2`` over the last dimension (THREADS): warp
    shuffles down 16, 8, 4, 2, 1, then the warps in order."""
    v = v.unflatten(-1, (THREADS // 32, 32))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    v = v[..., 0]
    out = v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i]
    return out


def _merge(a, b):
    """Chan's pairwise update of (count, mean, M2), as the kernels' ``merge``
    (b empty: a stays)."""
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    delta = mb - ma
    f = nb / n
    m = ma + delta * f
    q = (qa + qb) + ((delta * delta) * na) * f
    empty = nb == 0
    return (torch.where(empty, na, n), torch.where(empty, ma, m), torch.where(empty, qa, q))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of f32 tensors, rounded once: the product is exact in
    f64, and where the f64 sum lies on an f32 tie its rounding error decides
    the side."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # s + err is the exact sum
    r = s.float()
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    near = torch.nextafter(r, torch.where(r.double() < s, inf, -inf).float()).double()
    tie = (s != r.double()) & (s == (r.double() + near) / 2)
    s = torch.where(tie & (err != 0), torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def batch_norm_forward_plain(x, weight, bias, running_mean, running_var, num_batches_tracked,
                             momentum: float, eps: float, relu: bool, sms: int):
    """(y, mean, invstd) as :func:`batch_norm_forward` on a card of ``sms``
    SMs, in plain PyTorch, updating the running statistics and
    ``num_batches_tracked`` in place: the kernels' split, each thread's sums
    in its order, the block's and the merge's orders, each operation rounded
    on its own, and the fused multiply-add of y. f32 arithmetic (f64 stays
    f64, the multiply-add unfused; bf16 is widened, and y is rounded back to
    bf16 once)."""
    n, c, h, w = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    per = _per_load(x, h * w)
    vectors = n * h * w // per
    s = splits(n, c, h * w, per, sms)

    def const(v):
        return torch.tensor(v, dtype=dt, device=x.device)

    xc = x.to(dt).transpose(0, 1).reshape(c, n * h * w)
    shift = xc[:, 0]
    d = (xc - shift[:, None]).view(c, vectors, per)
    idx, valid = thread_vectors(vectors, s)
    idx, valid = idx.to(x.device), valid.to(x.device)
    d = torch.where(valid[..., None], d[:, idx], 0).flatten(-2)  # (c, s, THREADS, values)
    s1 = s2 = torch.zeros(d.shape[:-1], dtype=dt, device=x.device)
    for i in range(d.shape[-1]):
        s1 = s1 + d[..., i]
        s2 = s2 + d[..., i] * d[..., i]
    s1, s2 = _block_sum(s1), _block_sum(s2)  # (c, s)
    cnt = (valid.sum((1, 2)) * per).to(dt).expand(c, s)
    m = s1 / cnt
    q = s2 - s1 * m
    # warp 0: lane l merges chunks l, l + 32, ... in order, then by shuffles
    lanes = -(-s // 32) * 32
    part = [torch.nn.functional.pad(t, (0, lanes - s)).view(c, -1, 32) for t in (cnt, m, q)]
    acc = tuple(torch.zeros(c, 32, dtype=dt, device=x.device) for _ in range(3))
    for i in range(lanes // 32):
        acc = _merge(acc, tuple(t[:, i] for t in part))
    for o in (16, 8, 4, 2, 1):
        acc = _merge(tuple(t[:, :o] for t in acc), tuple(t[:, o:2 * o] for t in acc))
    m, q = acc[1][:, 0], acc[2][:, 0]
    q = torch.where(q < 0, 0, q)
    mean = shift + m
    var = q / const(n * h * w)
    invstd = torch.div(const(1.0), torch.sqrt(var + const(eps)))
    with torch.no_grad():
        keep, mom = const(1.0) - const(momentum), const(momentum)
        running_mean.copy_(keep * running_mean.to(dt) + mom * mean)
        running_var.copy_(keep * running_var.to(dt) + mom * (q / const(n * h * w - 1)))
        num_batches_tracked.add_(1)
    scale, bias_col = _col(invstd * weight.to(dt)), _col(bias.to(dt))
    pre = torch.empty(x.shape, dtype=dt, device=x.device)
    for i in range(n):  # a sample at a time: fma_f32's f64 temporaries
        xm = x[i].to(dt) - _col(mean)
        pre[i] = fma_f32(xm, scale, bias_col) if dt == torch.float32 else xm * scale + bias_col
    y = torch.where(pre <= 0, 0, pre) if relu else pre
    return y.to(x.dtype), mean, invstd


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
    :func:`batch_norm_forward`'s kernels for an f32 x and by
    :func:`forward_library` for any other type, the backward by
    :func:`batch_norm_backward`'s kernels. x, the parameters and the saved
    statistics are kept for the backward, so callers must not modify x in
    place afterwards. The running
    statistics and ``num_batches_tracked`` are updated in place, under
    ``no_grad`` too."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                momentum: float, eps: float, relu: bool):
        fn = batch_norm_forward if x.dtype == torch.float32 else forward_library
        y, mean, invstd = fn(x, weight, bias, running_mean, running_var, num_batches_tracked,
                             momentum, eps, relu)
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
