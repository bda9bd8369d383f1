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
- The plain forward (``batch_norm_forward_plain``, which repeats the forward
  kernels' arithmetic) against ``nn.BatchNorm2d`` + ``F.relu`` at every layer
  shape of the default step (N = 9), in f64 and f32, with and without the
  ReLU: y, the saved mean and invstd, the running statistics and
  ``num_batches_tracked``; its multiply-add rounded once; its reading of
  every value once, in the kernels' order.
- The split fills an H100's 132 SMs at every layer shape of the default step.
- The kernels' wrappers take no CPU tensor, and the forward's refuses any
  type but f32, a non-contiguous x and parameters of another type or shape;
  ``BatchNormReLU`` takes the forward kernels for an f32 x and the library's
  forward for a bf16 one.
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
    with pytest.raises(ValueError, match="CUDA"):
        bn.batch_norm_backward(x, dy, torch.zeros(SHAPE[1]), torch.ones(SHAPE[1]), w, b, True)
    with pytest.raises(ValueError, match="CUDA"):
        bn.batch_norm_forward(x, w, b, *fresh_stats(SHAPE[1]), MOMENTUM, EPS, True)


# -- the forward ---------------------------------------------------------------

# the plain forward against the module: f32 at f32_reduce, f64 within this
FORWARD_RTOL = {torch.float32: F32_REDUCE_RTOL, torch.float64: 1e-12}


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("chw", LAYER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_the_module(chw, dtype, relu):
    """``batch_norm_forward_plain`` on an H100's split against
    ``nn.BatchNorm2d`` (+ ``F.relu``) in training, from running statistics
    that are not the defaults: y at the tolerance of its largest magnitude;
    the saved mean (of its channel's magnitude, |mean| + std) and invstd
    against ATen's; the running mean and (unbiased) variance; and
    ``num_batches_tracked`` one more."""
    c = chw[0]
    r = np.random.RandomState(c + chw[1])
    x = torch.from_numpy(r.randn(9, *chw) * 2 + 0.5).to(dtype)
    w = torch.from_numpy(r.rand(c) + 0.5).to(dtype)
    b = torch.from_numpy(r.randn(c) * 0.5).to(dtype)
    start = (torch.from_numpy(r.randn(c)).to(dtype), torch.from_numpy(r.rand(c) + 0.5).to(dtype),
             torch.tensor(4))
    ref = torch.nn.BatchNorm2d(c).to(dtype)
    with torch.no_grad():
        for t, v in zip((ref.weight, ref.bias, ref.running_mean, ref.running_var,
                         ref.num_batches_tracked), (w, b, *start)):
            t.copy_(v)
        want = ref(x)
        _, mean_want, invstd_want = torch.native_batch_norm(x, w, b, None, None, True,
                                                            MOMENTUM, EPS)
    want = F.relu(want) if relu else want
    stats = tuple(t.clone() for t in start)
    y, mean, invstd = bn.batch_norm_forward_plain(x, w, b, *stats, MOMENTUM, EPS, relu, H100_SMS)
    rtol = FORWARD_RTOL[dtype]
    assert y.dtype == dtype and y.shape == x.shape
    err = float((y - want).abs().max() / want.abs().max())
    assert err <= rtol, f"y: {err:.3e}"
    std = torch.var(x.double(), (0, 2, 3), correction=0).sqrt()
    scale = (mean_want.double().abs() + std).numpy()
    assert float(((mean.double() - mean_want.double()).abs().numpy() / scale).max()) <= rtol
    np.testing.assert_allclose(invstd.numpy(), invstd_want.numpy(), rtol=rtol)
    np.testing.assert_allclose(stats[0].numpy(), ref.running_mean.numpy(), rtol=rtol,
                               atol=rtol * MOMENTUM * float(std.max()))
    np.testing.assert_allclose(stats[1].numpy(), ref.running_var.numpy(), rtol=rtol)
    assert int(stats[2]) == int(ref.num_batches_tracked) == 5


@pytest.mark.parametrize("chw", LAYER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_reads_every_value_once_in_the_kernels_order(chw):
    """At N = 9 on 132 SMs, f32 (4 values a load): the chunks of
    ``thread_vectors`` cover a channel's loads once each, chunk k those of
    [k vectors / S, (k + 1) vectors / S), each thread its own in rising
    order, THREADS apart, and only a thread's last loads may be padding."""
    c, h, w = chw
    vectors = 9 * h * w // 4
    s = bn.splits(9, c, h * w, 4, H100_SMS)
    idx, valid = bn.thread_vectors(vectors, s)
    assert idx.shape[:2] == (s, bn.THREADS)
    assert torch.equal(idx[valid].sort().values, torch.arange(vectors))
    for k in range(s):
        got = idx[k][valid[k]]
        assert int(got.min()) == k * vectors // s and int(got.max()) == (k + 1) * vectors // s - 1
    steps = idx[..., 1:] - idx[..., :-1]
    assert bool((steps[valid[..., 1:]] == bn.THREADS).all())
    assert bool((valid[..., :-1] | ~valid[..., 1:]).all())  # no valid load after padding


def exact_f32_fma(a: float, b: float, c: float) -> float:
    """a b + c rounded once to f32 (to nearest, ties to even), by exact
    rational arithmetic."""
    from fractions import Fraction

    exact = Fraction(a) * Fraction(b) + Fraction(c)
    r = np.float32(float(exact))
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return float(min(ties, key=lambda v: int(np.array(v).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rounding: random triples at several scales,
    with c near -a b (the ReLU's kink), and sums whose f64 rounding lands on
    an f32 tie."""
    r = np.random.RandomState(5)
    a = (r.randn(3000) * 2.0 ** r.randint(-20, 20, 3000)).astype(np.float32)
    b = (r.randn(3000) * 2.0 ** r.randint(-20, 20, 3000)).astype(np.float32)
    c = (r.randn(3000) * 2.0 ** r.randint(-20, 20, 3000)).astype(np.float32)
    c[:1000] = (-(a[:1000].astype(np.float64) * b[:1000]) * (1 + r.randn(1000) * 1e-6)
                ).astype(np.float32)
    # sums whose f64 rounding is an f32 tie that the exact sum lies above
    ties = np.array([[float.fromhex(a), float.fromhex(b), c] for a, b, c in (
        ("0x1.00169cp+0", "0x1.ffd2ccp-25", 1.0), ("0x1.00169cp+0", "-0x1.ffd2ccp-25", -1.0),
        ("0x1.ffd2f8p-1", "0x1.001686p-24", 1.0), ("0x1.ffd2f8p-1", "-0x1.001686p-24", -1.0))],
        np.float32)
    a, b, c = (np.concatenate([v, ties[:, i]]) for i, v in enumerate((a, b, c)))
    got = bn.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([exact_f32_fma(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)],
                    np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)  # rounded twice
    assert not np.array_equal(naive[-4:].view(np.int32), want[-4:].view(np.int32))


BAD_FORWARD = {
    "bfloat16": (lambda x, w, b, st: (x.bfloat16(), w, b, st), TypeError, "float32"),
    "float64": (lambda x, w, b, st: (x.double(), w, b, st), TypeError, "float32"),
    "non_contiguous": (lambda x, w, b, st: (x.transpose(2, 3), w, b, st), ValueError,
                       "contiguous NCHW"),
    "weight_shape": (lambda x, w, b, st: (x, w[:-1], b, st), ValueError, "parameters"),
    "weight_float64": (lambda x, w, b, st: (x, w.double(), b, st), ValueError, "parameters"),
    "running_var_shape": (lambda x, w, b, st: (x, w, b, (st[0], st[1][None], st[2])),
                          ValueError, "parameters"),
}


@pytest.mark.parametrize("bad", list(BAD_FORWARD))
def test_forward_wrapper_refuses_what_the_kernels_do_not_take(bad):
    """Refused for the input's own fault, before the device is looked at."""
    x, _, w, b = inputs()
    make, exc, match = BAD_FORWARD[bad]
    x, w, b, stats = make(x, w, b, fresh_stats(SHAPE[1]))
    with pytest.raises(exc, match=match):
        bn.batch_norm_forward(x, w, b, *stats, MOMENTUM, EPS, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_relu_takes_the_forward_kernels_for_f32_alone(dtype, monkeypatch):
    """The route is the input's type: f32 to the forward kernels (here their
    plain version in their place), anything else to ``forward_library``."""
    taken = []
    plain, library = bn.batch_norm_forward_plain, bn.forward_library
    monkeypatch.setattr(bn, "batch_norm_forward",
                        lambda *a: taken.append("kernels") or plain(*a, H100_SMS))
    monkeypatch.setattr(bn, "forward_library",
                        lambda *a: taken.append("library") or library(*a))
    x, _, w, b = inputs(dtype)
    bn.BatchNormReLU.apply(x, w, b, *fresh_stats(SHAPE[1]), MOMENTUM, EPS, True)
    assert taken == (["kernels"] if dtype == torch.float32 else ["library"])


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
