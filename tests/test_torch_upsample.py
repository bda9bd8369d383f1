"""The 2x bilinear upsample (``wt_pse_tpu_torch/ops/upsample_cuda.py`` and
``models/layers.py::upsample2x``) on the CPU. ``upsample2x`` runs
``F.interpolate`` there, with its autograd, as the reference does; the
plain version of the card's kernels (``Upsample2x`` on a CPU tensor) runs
that forward and the backward's gather, which the card tests hold the
backward kernel to bit for bit.

- The forward: bit for bit ``F.interpolate`` (in bf16
  ``scale_factor=(2, 1)`` then ``(1, 2)``, the two passes the kernel fuses),
  and ``upsample2x``'s gradient bit for bit that of ``F.interpolate``.
- The plain f32 forward and backward within tolerance class ``f32_reduce``
  (rtol 2e-5 of the result's largest magnitude) of ``F.interpolate``'s
  autograd.
- The backward's gather, its edge weights included, against the adjoint of
  the forward: ``F.interpolate``'s f64 backward, and the dot-product
  identity; a ``gradcheck`` of the plain version in f64.
- A bf16 dx no further from an f64 truth than the two-pass autograd's dx.
- An f64 input still resizes in f32; ``row_shard`` slabs join into the whole
  image's result; the plain path counts no launch, and the kernels' wrappers
  take no CPU tensor.

Shapes are small: batch 2-3, 2-32 channels, sides 1, 2, 3, 8 and 16.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wt_pse_tpu_torch.models import layers as L
from wt_pse_tpu_torch.ops import upsample_cuda as up
from wt_pse_tpu_torch.parallel.mesh import data_mesh
from wt_pse_tpu_torch.parallel.spatial import spatial_sharded

from torch_numerics import F32_REDUCE_RTOL, bf16_ulp_error
from torch_port import torch_single_thread  # noqa: F401

SHAPES = [(2, 2, 1, 1), (3, 4, 2, 3), (2, 3, 3, 1), (3, 8, 8, 8), (2, 32, 16, 16),
          (2, 5, 3, 16), (3, 16, 16, 2)]
ids = ["x".join(map(str, s)) for s in SHAPES]


def seeded(shape, seed=0, dtype=torch.float32):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)


def interpolate(x, scale=2):
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


def two_pass(x):
    """The bf16 resize the kernel replaces: rows, then columns."""
    return interpolate(interpolate(x, (2, 1)), (1, 2))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_bf16_forward_is_the_two_pass_interpolate_bitwise(shape):
    """Also in f32 (one pass), where ``upsample2x``'s gradient is
    ``F.interpolate``'s too, bit for bit."""
    x = (seeded(shape) * 3).to(torch.bfloat16)
    x.view(-1)[::7] = 0.0
    got = L.upsample2x(x)
    assert got.dtype == torch.bfloat16 and got.shape == shape[:2] + (2 * shape[2], 2 * shape[3])
    assert torch.equal(bits(got), bits(two_pass(x)))
    assert torch.equal(bits(up.upsample2x_forward_plain(x)), bits(got))
    assert torch.equal(bits(up.Upsample2x.apply(x)), bits(got))
    dy = seeded(got.shape, seed=1)
    out = []
    for fn in (L.upsample2x, interpolate):
        xr = x.float().requires_grad_()
        y = fn(xr)
        y.backward(dy)
        out.append((bits(y.detach()), bits(xr.grad)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_f32_forward_and_backward_within_f32_reduce_of_interpolate(shape):
    x, dy = seeded(shape), seeded(shape[:2] + (2 * shape[2], 2 * shape[3]), seed=1)
    out = []
    for fn in (up.Upsample2x.apply, interpolate):
        xr = x.clone().requires_grad_()
        y = fn(xr)
        y.backward(dy)
        out.append((y.detach(), xr.grad))
    (y, dx), (y_want, dx_want) = out
    assert y.dtype == dx.dtype == torch.float32
    assert rel_err(y, y_want) <= F32_REDUCE_RTOL
    assert rel_err(dx, dx_want) <= F32_REDUCE_RTOL


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_the_gather_is_the_adjoint_of_the_forward(shape):
    """In f64: the plain backward equals ``F.interpolate``'s backward (edge
    rows and columns included), and <up(x), dy> = <x, up^T(dy)>."""
    x = seeded(shape).double().requires_grad_()
    dy = seeded(shape[:2] + (2 * shape[2], 2 * shape[3]), seed=2).double()
    interpolate(x).backward(dy)
    dx = up.upsample2x_backward_plain(dy)
    assert dx.dtype == torch.float64
    assert rel_err(dx, x.grad) <= 1e-14
    lhs = float((up.upsample2x_forward_plain(x.detach()) * dy).sum())
    rhs = float((x.detach() * dx).sum())
    assert abs(lhs - rhs) <= 1e-12 * (abs(lhs) + 1)


@pytest.mark.parametrize("shape", [(2, 2, 1, 1), (2, 2, 2, 3), (2, 3, 3, 2), (2, 2, 4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gradcheck_in_f64(shape):
    x = seeded(shape).double().requires_grad_()
    assert torch.autograd.gradcheck(up.Upsample2x.apply, (x,))


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_bf16_dx_no_further_from_an_f64_truth_than_the_two_pass_autograd(shape):
    """The gather sums in f32 and rounds once; the two ``F.interpolate``
    backwards round between and within the passes."""
    x = seeded(shape).to(torch.bfloat16)
    dy = (seeded(shape[:2] + (2 * shape[2], 2 * shape[3]), seed=3) * 5).to(torch.bfloat16)
    x64 = x.double().requires_grad_()
    interpolate(x64).backward(dy.double())
    xb = x.clone().requires_grad_()
    two_pass(xb).backward(dy)
    xp = x.clone().requires_grad_()
    up.Upsample2x.apply(xp).backward(dy)
    assert xp.grad.dtype == torch.bfloat16
    assert torch.equal(bits(xp.grad), bits(up.upsample2x_backward_plain(dy)))
    err = float((xp.grad.double() - x64.grad).abs().max())
    assert err <= float((xb.grad.double() - x64.grad).abs().max())
    # one rounding of the f32 sum: half a bf16 ulp of the truth, with the
    # f32 summation's allowance
    assert bf16_ulp_error(xp.grad, x64.grad) <= 0.5


def test_an_f64_input_still_resizes_in_f32():
    x = seeded((2, 3, 8, 8)).double()
    got = L.upsample2x(x)
    assert got.dtype == torch.float64
    assert torch.equal(got, up.upsample2x_forward_plain(x.float()).double())
    assert not torch.equal(got, up.upsample2x_forward_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shards", [2, 3])
def test_row_shard_slabs_join_into_the_whole_images_result(dtype, shards):
    """``upsample2x`` in ``row_shard`` on the in-process mesh of CPU shards
    (slabs of whole 16-row blocks, a halo row each side): the slabs' outputs
    joined along H are the whole image's, bit for bit, but for the image's
    first output row in f32. There the top slab's halo repeats row 0, and
    the CPU's ``F.interpolate`` sums ``0.25 x + 0.75 x`` where the whole
    image takes ``x`` at weight 1: one f32 ulp apart at most (in bf16 the f32
    sum rounds back to x)."""
    x = seeded((2, 3, 48, 8), seed=5).to(dtype)
    predict = spatial_sharded(lambda dev: (lambda image: (L.upsample2x(image),)),
                              data_mesh(devices=["cpu"] * shards))
    try:
        (got,) = predict(x)
    finally:
        predict.close()
    want = L.upsample2x(x)
    first = 1 if dtype == torch.float32 else 0
    assert torch.equal(bits(got[:, :, first:]), bits(want[:, :, first:]))
    ulp = torch.finfo(torch.float32).eps * want[:, :, 0].abs()
    assert bool(((got[:, :, 0] - want[:, :, 0]).abs() <= ulp).all())


def test_the_plain_path_counts_no_launch():
    counters = [(fn, attr) for fn in (up.upsample2x_forward, up.upsample2x_backward)
                for attr in ("launches", "launches_bf16")]
    before = [getattr(fn, a) for fn, a in counters]
    for dtype in (torch.float32, torch.bfloat16):
        for fn in (L.upsample2x, up.Upsample2x.apply):
            x = seeded((2, 4, 8, 8)).to(dtype).requires_grad_()
            fn(x).sum().backward()
    assert [getattr(fn, a) for fn, a in counters] == before


def test_the_kernels_wrappers_take_no_cpu_tensor():
    with pytest.raises(ValueError):
        up.upsample2x_forward(seeded((2, 4, 8, 8)))
    with pytest.raises(ValueError):
        up.upsample2x_backward(seeded((2, 4, 16, 16)))
