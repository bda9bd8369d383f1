"""Training-mode BatchNorm + ReLU (``wt_pse_tpu_torch/ops/batchnorm_cuda.py`` and
``models/layers.py::BatchNorm2d``) on the CPU.

- The plain backward, which repeats the CUDA kernels' arithmetic, the ReLU's
  mask recomputed from x as they do (the card tests hold the kernels to
  it), joined to the path's forward
  (``forward_library``) as ``BatchNormReLU`` joins them, against
  ``F.batch_norm`` + ``F.relu`` under autograd, with and without the ReLU:
  ``gradcheck`` in f64; f32 at tolerance class ``f32_reduce`` (rtol 2e-5,
  relative to the result's largest magnitude; dweight and dbias, channel
  sums, relative to the sum of their terms' magnitudes); a bf16 input with
  f32 statistics within 1 bf16 ulp (plus the ``f32_reduce`` allowance) of dx.
- ``forward_library`` (the forward the card runs) bitwise equal to
  ``nn.BatchNorm2d`` + ``F.relu`` in f32, bf16 and f64, the running
  statistics and ``num_batches_tracked`` too; the running mean, the running
  (unbiased) variance and ``num_batches_tracked`` after a step.
- The split fills an H100's 132 SMs at every layer shape of the default step.
- The kernels' wrapper takes no CPU tensor.
- ``ConvD``, ``ConvU`` and ``DoubleConv`` against the reference's blocks
  (``tests/torch_ref.py``, ``nn.BatchNorm2d`` then ``F.relu``): the same
  ``state_dict`` keys, loaded strictly either way; the ReLU in each
  BatchNorm where the reference applies one; on the CPU in training the same
  output, gradients and running statistics, bit for bit; eval mode bitwise
  equal and the mesh path (sync BN over a mesh of one process) at
  ``f32_reduce`` (its own variance formula); none through the fused op,
  which only a CUDA tensor takes (the card tests hold it there).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_ref
from wt_pse_tpu_torch.models import layers as L
from wt_pse_tpu_torch.ops import batchnorm_cuda as bn
from wt_pse_tpu_torch.parallel.mesh import data_mesh

from torch_numerics import F32_REDUCE_RTOL, bf16_ulp_error
from torch_port import torch_single_thread  # noqa: F401

EPS, MOMENTUM = 1e-5, 0.1
SHAPE = (3, 5, 6, 7)


def fresh_stats(c: int, dtype=torch.float32):
    return (torch.zeros(c, dtype=dtype), torch.ones(c, dtype=dtype),
            torch.zeros((), dtype=torch.long))


class PlainBN(torch.autograd.Function):
    """The path's forward and the plain backward, joined as
    ``BatchNormReLU`` joins the forward and the kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        y, mean, invstd = bn.forward_library(x, weight, bias, *fresh_stats(x.shape[1],
                                                                           weight.dtype),
                                             MOMENTUM, EPS, relu)
        ctx.save_for_backward(x, mean, invstd, weight, bias)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight, bias = ctx.saved_tensors
        return (*bn.batch_norm_backward_plain(x, dy, mean, invstd, weight, bias, ctx.relu),
                None)


def library(x, weight, bias, relu):
    y = F.batch_norm(x, *fresh_stats(x.shape[1], weight.dtype)[:2], weight, bias, True,
                     MOMENTUM, EPS)
    return F.relu(y) if relu else y


def inputs(dtype=torch.float32, seed=0):
    r = np.random.RandomState(seed)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.from_numpy(r.randn(*SHAPE) * 2 + 0.5).to(dtype)
    dy = torch.from_numpy(r.randn(*SHAPE)).to(dtype)
    w = torch.from_numpy(r.rand(SHAPE[1]) + 0.5).to(pdt)
    b = torch.from_numpy(r.randn(SHAPE[1]) * 0.5).to(pdt)
    return x, dy, w, b


def forward_backward(fn, x, dy, w, b, relu):
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y = fn(xs, ws, bs, relu)
    y.backward(dy)
    return y.detach(), xs.grad, ws.grad, bs.grad


def magnitudes(x, dy, y, relu):
    """The sums of the magnitudes of dbias's and dweight's terms, in f64."""
    xd = x.double()
    var, mean = torch.var_mean(xd, (0, 2, 3), correction=0)
    xhat = (xd - mean[:, None, None]) * torch.rsqrt(var + EPS)[:, None, None]
    g = torch.where(y <= 0, 0, dy.double()) if relu else dy.double()
    return g.abs().sum((0, 2, 3)), (g * xhat).abs().sum((0, 2, 3))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
def test_gradcheck_in_f64(relu):
    x, _, w, b = inputs(torch.float64)
    args = tuple(t.clone().requires_grad_() for t in (x, w, b))
    assert torch.autograd.gradcheck(lambda x, w, b: PlainBN.apply(x, w, b, relu), args)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
def test_plain_backward_matches_the_library_in_f32(relu):
    x, dy, w, b = inputs()
    got = forward_backward(PlainBN.apply, x, dy, w, b, relu)
    want = forward_backward(library, x, dy, w, b, relu)
    assert torch.equal(got[0], want[0])  # one forward
    err = float((got[1] - want[1]).abs().max() / want[1].abs().max())
    assert err <= F32_REDUCE_RTOL, f"dx: {err:.3e}"
    db_mag, dw_mag = magnitudes(x, dy, want[0], relu)
    for name, g, v, mag in (("dweight", got[2], want[2], dw_mag), ("dbias", got[3], want[3],
                                                                    db_mag)):
        err = float(((g - v).abs() / mag.float()).max())
        assert err <= F32_REDUCE_RTOL, f"{name}: {err:.3e}"


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
def test_plain_backward_in_bf16_within_one_ulp_of_the_library(relu):
    """A bf16 x with f32 parameters: statistics and sums in f32, dx rounded
    to bf16 once on either side."""
    x, dy, w, b = inputs(torch.bfloat16)
    got = forward_backward(PlainBN.apply, x, dy, w, b, relu)
    want = forward_backward(library, x, dy, w, b, relu)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == got[3].dtype == torch.float32
    assert torch.equal(got[0], want[0])
    assert bf16_ulp_error(got[1], want[1]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
def test_forward_library_is_the_module_bit_for_bit(relu, dtype):
    """The path's forward against ``nn.BatchNorm2d`` (+ ``F.relu``) in
    training: the output, the running statistics and ``num_batches_tracked``
    bit for bit."""
    x, _, w, b = inputs(dtype)
    ref = torch.nn.BatchNorm2d(SHAPE[1]).to(w.dtype)
    with torch.no_grad():
        ref.weight.copy_(w)
        ref.bias.copy_(b)
        want = ref(x)
    want = F.relu(want) if relu else want
    stats = fresh_stats(SHAPE[1], w.dtype)
    got = bn.forward_library(x, w, b, *stats, MOMENTUM, EPS, relu)[0]
    assert got.dtype == dtype and torch.equal(got, want)
    assert all(torch.equal(a, r) for a, r in zip(stats, (ref.running_mean, ref.running_var,
                                                        ref.num_batches_tracked)))


def test_running_statistics_after_a_step():
    """Momentum 0.1 into running statistics of zeros and ones: the batch
    mean and the unbiased variance, and ``num_batches_tracked`` one more,
    under ``no_grad`` too (the teachers' forwards update them)."""
    x, _, w, b = inputs()
    c = SHAPE[1]
    stats = fresh_stats(c)
    with torch.no_grad():
        bn.forward_library(x, w, b, *stats, MOMENTUM, EPS, True)
    mean = x.double().mean((0, 2, 3))
    unbiased = x.double().var((0, 2, 3), correction=1)
    np.testing.assert_allclose(stats[0].numpy(), 0.1 * mean.numpy(), rtol=F32_REDUCE_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(stats[1].numpy(), 0.9 + 0.1 * unbiased.numpy(),
                               rtol=F32_REDUCE_RTOL)
    assert int(stats[2]) == 1


# (C, H, W) of every training-mode BatchNorm of the default WT_PSE step at
# 256x256 (batch 9)
LAYER_SHAPES = [(16, 256, 256), (32, 256, 256), (32, 128, 128), (64, 128, 128), (64, 64, 64),
                (128, 64, 64), (128, 32, 32), (256, 32, 32), (256, 16, 16)]
H100_SMS = 132


@pytest.mark.parametrize("per", [4, 8], ids=["f32", "bf16"])
@pytest.mark.parametrize("chw", LAYER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_fills_the_card_at_every_layer(chw, per):
    """At N = 9 on 132 SMs: at least a block an SM at every layer, the
    ``WAVE_BLOCKS`` an SM it aims for unless a block would read fewer than
    ``MIN_VECTORS`` loads, and never fewer than that in a block of a split
    channel."""
    c, h, w = chw
    vectors = 9 * h * w // per
    s = bn.splits(9, c, h * w, per, H100_SMS)
    assert 1 <= s and c * s >= H100_SMS
    assert s == 1 or vectors // s >= bn.MIN_VECTORS
    assert c * s >= bn.WAVE_BLOCKS * H100_SMS or s == max(1, vectors // bn.MIN_VECTORS)
    assert c * (s - 1) < bn.WAVE_BLOCKS * H100_SMS


def test_the_kernels_wrapper_takes_no_cpu_tensor():
    x, dy, w, b = inputs()
    with pytest.raises(ValueError):
        bn.batch_norm_backward(x, dy, torch.zeros(SHAPE[1]), torch.ones(SHAPE[1]), w, b, True)


# -- the blocks against the reference's --------------------------------------------


def block_pair(name: str, seed: int = 0):
    """(port block, reference block with the port's weights, inputs)."""
    torch.manual_seed(seed)
    r = np.random.RandomState(seed)
    if name == "ConvD":
        port, ref = L.ConvD(4, 8), torch_ref.ConvD(4, 8)
        args = (torch.from_numpy(r.randn(2, 4, 16, 16).astype(np.float32)),)
    elif name == "ConvU":
        port, ref = L.ConvU(8), torch_ref.ConvU(8)
        args = (torch.from_numpy(r.randn(2, 16, 8, 8).astype(np.float32)),
                torch.from_numpy(r.randn(2, 4, 16, 16).astype(np.float32)))
    else:
        port, ref = L.DoubleConv(4, 8), torch_ref.DoubleConv(4, 8)
        args = (torch.from_numpy(r.randn(2, 4, 16, 16).astype(np.float32)),)
    with torch.no_grad():
        for p in port.parameters():
            p.normal_(0.0, 0.3)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref, args


BLOCKS = ["ConvD", "ConvU", "DoubleConv"]


@pytest.fixture
def fused_calls(monkeypatch):
    """How many times the blocks called the fused op."""
    calls = []
    apply = bn.BatchNormReLU.apply
    monkeypatch.setattr(bn.BatchNormReLU, "apply",
                        lambda *a: calls.append(a[-1]) or apply(*a))
    return calls


@pytest.mark.parametrize("name", BLOCKS)
def test_state_dict_keys_are_the_references(name):
    port, ref, _ = block_pair(name)
    assert list(port.state_dict()) == list(ref.state_dict())
    port.load_state_dict(ref.state_dict(), strict=True)


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_in_training_equal_the_reference_bitwise(name, fused_calls):
    """Each BatchNorm takes in the ReLU that the reference applies after it;
    on the CPU the block's output, every gradient and the running statistics
    are the reference's, bit for bit, with no call of the fused op."""
    port, ref, args = block_pair(name)
    relu = {"ConvD": [False, True, True], "ConvU": [True, True, True],
            "DoubleConv": [True, True]}[name]
    assert [m.relu for m in port.modules() if isinstance(m, L.BatchNorm2d)] == relu
    outs = []
    for m in (port, ref):
        xs = [a.clone().requires_grad_() for a in args]
        y = m(*xs)
        y.backward(torch.ones_like(y) + y.detach())
        outs.append([y.detach(), *(x.grad for x in xs), *(p.grad for p in m.parameters()),
                     *m.buffers()])
    assert len(outs[0]) == len(outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert fused_calls == []


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_in_eval_mode_equal_the_reference_bitwise(name, fused_calls):
    port, ref, args = block_pair(name)
    for m in (port, ref):
        m.train()(*args)  # running statistics that differ from the defaults
        m.eval()
    fused_calls.clear()
    with torch.no_grad():
        assert torch.equal(port(*args), ref(*args))
    assert fused_calls == []


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_on_a_mesh_take_the_sync_path(name, fused_calls):
    """Sync BN over the mesh of this one process: its own variance formula
    (mean of squares less the squared mean) against the reference's
    training-mode blocks at ``f32_reduce``, the ReLU where the reference has
    one, and no call of the fused op."""
    port, ref, args = block_pair(name)
    mesh = data_mesh()
    for m in port.modules():
        if isinstance(m, L.BatchNorm2d):
            m.mesh = mesh
    got, want = port(*args).detach(), ref(*args).detach()
    assert fused_calls == []
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= F32_REDUCE_RTOL, err
    assert torch.equal(got > 0, want > 0)
    for a, b in zip(port.buffers(), ref.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_REDUCE_RTOL, atol=1e-7)
