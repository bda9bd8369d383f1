"""Core layer library (PyTorch, NCHW) — counterpart of ``wt_pse_tpu/models/layers.py``.

Module and child names follow the reference's ``state_dict`` (as
``tests/torch_ref.py`` does), so a reference ``.pth.tar`` loads with a plain
``load_state_dict``: DoubleConv children are ``double_conv.{0,1,3,4}``,
DoubleConvWT children ``double_conv.{0,2}``, and the 1x1 heads are
``nn.Sequential`` with convs at indices ``0, 2, 4``.

BatchNorm is ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1, unbiased variance in
the running estimate) and the 2x upsample computes what
``F.interpolate(bilinear, align_corners=False)`` does — the reference's own
ops, which the JAX package re-implements for parity. Under data parallelism
the BatchNorm layers hold the mesh and synchronise their training statistics
across its ranks (:class:`BatchNorm2d`, JAX's ``BatchNorm(axis_name=...)``);
without one they are ``nn.BatchNorm2d`` itself.

Parameters are initialised the way the JAX package's Flax modules initialise
them (:func:`init_like_flax_`), drawn from an explicit ``torch.Generator``.

Compute dtype (``ModelConfig.compute_dtype``): every block takes a ``dtype``,
``None`` for f32 or ``torch.bfloat16`` for the bf16 training mode, which is
the JAX package's policy (``wt_pse_tpu/models/layers.py``). Each op casts
explicitly; none runs under ``torch.autocast``, whose op lists differ between
the CPU and CUDA (the CPU's would also narrow the plain covariance's einsum
and the MMD's matmul) and which rounds a conv's bias into its output where
JAX rounds twice. Per op:

- conv (:class:`Conv2d`): input, weight and bias cast to bf16 (the weight is
  an f32 master copy; its gradient comes back f32 through the cast), the conv
  with f32 accumulation rounded to bf16, then the bias added in bf16 — two
  roundings, as ``RefConv``'s ``conv + bias`` (``layers.py:139-156``);
- BatchNorm: ``nn.BatchNorm2d`` with f32 parameters and running statistics
  on a bf16 input, which computes the statistics and the normalisation in
  f32 and returns bf16 (``layers.py:68-108``: statistics in f32, output cast
  back to the input type); the running statistics stay f32;
- 2x bilinear upsample (:func:`upsample2x`): bf16 in, one axis at a time,
  f32 sums rounded to bf16 after each axis (``layers.py:211-226``: bf16
  operands, f32 accumulation, a bf16 round between the two passes); an f64
  input (``net.double()``) is resized in f32, as JAX's is (``:227-231``).
  On the card it is ``ops/upsample_cuda.py::Upsample2x``, one hand-written
  kernel each way (both passes in registers, the forward bit for bit the
  two ``F.interpolate`` calls; the backward a gather summed in f32 and
  rounded once); on the CPU those ``F.interpolate`` calls themselves;
- ReLU, max-pool, concat (the skip cast to the decoder's type), sigmoid and
  the attention fusion run in the compute dtype; ``ConvStack1x1`` and
  ``AttentionLayer`` are convs in it (``layers.py:375-404``).

Row sharding (:func:`row_shard`, entered by
``parallel/spatial.py::spatial_sharded``): inside the context each rank holds
a slab of an image's rows, and the two layers that read across rows take one
row from each neighbouring slab (``parallel/collectives.py::halo_rows``)
where JAX's GSPMD inserts its halo exchanges:

- a 3x3 conv pads its rows with the neighbours' rows (zero rows at the
  image's true top and bottom, its padding) and pads only its columns;
- the 2x upsample resizes the slab with a neighbour row on each side (the
  edge row repeated at the true edges, the resize's clamp) and drops the two
  output rows each side that those rows make.

1x1 convs, BatchNorm in eval mode, ReLU, sigmoid and concat are pointwise,
and a 2x2 max-pool needs nothing while every slab starts on an even row at
every level (``spatial_sharded`` deals out slabs of whole 16-row blocks).
The context is per thread (a ``ContextVar``): each shard of an in-process
mesh runs in a thread of its own with its own view. Outside the context
every layer runs as it did without it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wt_pse_tpu_torch.ops.batchnorm_cuda import BatchNormReLU
from wt_pse_tpu_torch.ops.upsample_cuda import Upsample2x, upsample2x_forward_plain
from wt_pse_tpu_torch.parallel.collectives import all_reduce_sum, halo_rows

# the mesh whose ranks hold the slabs of an image's rows inside row_shard, or
# None; each thread sees its own
_ROW_MESH = contextvars.ContextVar("row_mesh", default=None)


@contextlib.contextmanager
def row_shard(mesh):
    """Inside the context, this rank's activations are its slab of rows of
    images split along H over ``mesh``'s ranks in rank order, and the 3x3
    convs and the upsample exchange rows with the neighbouring ranks (module
    docstring). Every rank of the mesh must run the same layers in the
    context: each exchange is a collective. The context holds in the
    calling thread only."""
    token = _ROW_MESH.set(mesh)
    try:
        yield
    finally:
        _ROW_MESH.reset(token)


# flax.linen.initializers.lecun_normal: truncated normal on [-2, 2] standard
# deviations, rescaled by this constant so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """Square same-padding conv with bias that computes in ``dtype`` (f32 when
    ``None``): ``conv(x, w) + b`` with x, w and b cast to it and the bias added
    after the conv's rounding, as ``RefConv`` does in bf16. The parameters
    stay f32; their names are ``nn.Conv2d``'s."""

    def __init__(self, cin: int, cout: int, ksize: int, dtype: torch.dtype | None = None):
        super().__init__(cin, cout, ksize, 1, ksize // 2, bias=True)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        mesh = _ROW_MESH.get()
        if mesh is not None and padding[0]:  # a slab: the neighbours' rows
            x = halo_rows(x, mesh, "zero")
            padding = (0, padding[1])
        dt = self.compute_dtype
        if dt is None:
            return F.conv2d(x, self.weight, self.bias, 1, padding)
        return (F.conv2d(x.to(dt), self.weight.to(dt), None, 1, padding)
                + self.bias.to(dt)[:, None, None])


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``, followed by a ReLU in every mode when ``relu``, with
    sync BN: in training, with a ``mesh`` (set by :func:`models.common.place`
    from ``ModelConfig.bn_mesh``), the batch statistics are those of the
    ranks' batches together, as ``wt_pse_tpu/models/layers.py:68-100``
    computes them under an ``axis_name``:

    - the mean and the mean of squares, in at least f32, all-reduced and
      divided by the mesh size (one all-reduce, differentiable, so the
      gradient of every rank's loss reaches every rank's input);
    - ``var = max(mean2 - mean², 0)`` normalises;
    - the running statistics take the unbiased variance at the global count
      ``n * size``, written back in their own dtype.

    In training without a mesh on the card it is
    ``ops/batchnorm_cuda.py::BatchNormReLU``: one forward through both by the
    hand-written kernels for an f32 x (``nn.BatchNorm2d``'s own forward and
    the ReLU for bf16), and one backward through both by the kernels.
    Otherwise (eval mode, or a CPU tensor) it is ``nn.BatchNorm2d.forward``
    itself, then the ReLU. The ``state_dict`` is ``nn.BatchNorm2d``'s either
    way. ``torch.nn.
    SyncBatchNorm`` is not used: it takes no CPU tensor and all-gathers,
    which gloo does not do for CUDA tensors."""

    mesh = None

    def __init__(self, num_features: int, relu: bool = False):
        super().__init__(num_features)
        self.relu = relu

    def extra_repr(self) -> str:
        return super().extra_repr() + (", relu=True" if self.relu else "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mesh is not None:
            y = self._sync(x)
        elif self.training and x.is_cuda:
            return BatchNormReLU.apply(x, self.weight, self.bias, self.running_mean,
                                       self.running_var, self.num_batches_tracked,
                                       self.momentum, self.eps, self.relu)
        else:
            y = super().forward(x)
        return F.relu(y) if self.relu else y

    def _sync(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        mean, mean2 = (all_reduce_sum(stats, self.mesh) / self.mesh.size).split(c)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            n = x.numel() // c * self.mesh.size
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c, 1, 1)
        return ((xf - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)).to(x.dtype)


def conv3x3(cin: int, cout: int, dtype: torch.dtype | None = None) -> Conv2d:
    """3x3 same-padding conv with bias (reference convs are all bias=True)."""
    return Conv2d(cin, cout, 3, dtype)


def conv1x1(cin: int, cout: int, dtype: torch.dtype | None = None) -> Conv2d:
    return Conv2d(cin, cout, 1, dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)``
    by :class:`~wt_pse_tpu_torch.ops.upsample_cuda.Upsample2x` on the card
    (its kernels) and ``F.interpolate`` with its autograd on the CPU, which
    the forward kernel equals bit for bit. A bf16 ``x`` is resized one
    axis at a time, each pass summing in f32 and rounding to bf16, as the JAX
    package's bf16 path does (its 0.25 / 0.75 weights are exact in bf16). An
    f64 ``x`` is resized in f32 and returned f64, as the JAX package's
    ``resize_bilinear`` computes in f32 whatever its input
    (``layers.py:227-231``), so f64 nets round there as JAX's do. Inside
    :func:`row_shard`, a slab is resized with a neighbour row on each side
    and the two output rows each side that they make are dropped."""
    mesh = _ROW_MESH.get()
    if mesh is not None:
        return _upsample2x(halo_rows(x, mesh, "replicate"))[:, :, 2:-2]
    return _upsample2x(x)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float64:
        return _upsample2x(x.float()).to(x.dtype)
    return Upsample2x.apply(x) if x.is_cuda else upsample2x_forward_plain(x)


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw ``module``'s parameters as Flax initialises them: conv kernels
    lecun-normal (truncated normal, variance 1/fan_in), biases zero, BatchNorm
    scale one / shift zero, running mean zero / variance one. Draws happen on
    the CPU, in module order, so a seed gives the same weights on any device."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


class ConvD(nn.Module):
    """Encoder block: [maxpool if not first] -> conv/bn -> conv/bn/act -> conv/bn/act.
    No activation after bn1 (``wt_pse_tpu/models/layers.py:282-283``); bn2 and
    bn3 apply theirs."""

    def __init__(self, cin: int, planes: int, first: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.first = first
        self.conv1, self.bn1 = conv3x3(cin, planes, dtype), BatchNorm2d(planes)
        self.conv2, self.bn2 = conv3x3(planes, planes, dtype), BatchNorm2d(planes, relu=True)
        self.conv3, self.bn3 = conv3x3(planes, planes, dtype), BatchNorm2d(planes, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = F.max_pool2d(x, 2)
        x = self.bn1(self.conv1(x))
        return self.bn3(self.conv3(self.bn2(self.conv2(x))))


class ConvU(nn.Module):
    """Decoder block: [conv/bn/act if not first] -> up2x -> 1x1 conv/bn/act ->
    concat ``[prev, y]`` -> conv/bn/act (``layers.py:292-339``); each bn applies
    its act. The input has ``planes`` channels when first, else ``2 * planes``."""

    def __init__(self, planes: int, first: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.first = first
        if not first:
            self.conv1 = conv3x3(2 * planes, planes, dtype)
            self.bn1 = BatchNorm2d(planes, relu=True)
        self.conv2 = conv1x1(planes, planes // 2, dtype)
        self.bn2 = BatchNorm2d(planes // 2, relu=True)
        self.conv3, self.bn3 = conv3x3(planes, planes, dtype), BatchNorm2d(planes, relu=True)

    def forward(self, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(upsample2x(x)))
        y = torch.cat([prev.to(y.dtype), y], dim=1)
        return self.bn3(self.conv3(y))


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2 (``layers.py:342-356``). Each BN applies
    the ReLU after it; the reference's ``nn.ReLU`` slots are ``nn.Identity``,
    which keeps the children's indices (and so the ``state_dict`` keys)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.double_conv = nn.Sequential(
            conv3x3(cin, features, dtype), BatchNorm2d(features, relu=True), nn.Identity(),
            conv3x3(features, features, dtype), BatchNorm2d(features, relu=True), nn.Identity(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class DoubleConvWT(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, no normalisation (``layers.py:359-372``).
    The output is pre-activation so the covariance loss sees the raw map."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.double_conv = nn.Sequential(
            conv3x3(cin, features, dtype), nn.ReLU(), conv3x3(features, features, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class ConvStack1x1(nn.Sequential):
    """A stack of 1x1 convs with ReLU between (not after) — the ``mu`` /
    ``mu_prior`` / ``logvar_prior`` / ``outc`` / ``fusion`` heads
    (``layers.py:375-390``); convs sit at Sequential indices 0, 2, 4, ..."""

    def __init__(self, cin: int, features: Sequence[int], dtype: torch.dtype | None = None):
        mods: list[nn.Module] = []
        for i, f in enumerate(features):
            if i > 0:
                mods.append(nn.ReLU())
            mods.append(conv1x1(cin, f, dtype))
            cin = f
        super().__init__(*mods)


class AttentionLayer(nn.Module):
    """1x1 conv + sigmoid gate (``layers.py:393-404``). Returns
    (sigmoid(logits), logits)."""

    def __init__(self, cin: int = 1, features: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.layer1 = conv1x1(cin, features, dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        logits = self.layer1(x)
        return torch.sigmoid(logits), logits


class InstanceWhitening(nn.Module):
    """Parameter-free instance standardisation (``wt_pse_tpu/models/layers.py:407-420``,
    ``nn.InstanceNorm2d(dim, affine=False)``): each sample's channels take
    their mean and biased variance over H and W, then ``(x - mean) *
    rsqrt(var + eps)``. The reference defines it inside DeepWT and leaves it
    out of the datapath; so does the port."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), correction=0, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)
