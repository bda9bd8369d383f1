"""Tests of the port that need a CUDA card; every test here is marked ``cuda``
and skips without one. They import neither JAX nor the JAX package, so they run
where only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are held against their plain versions at tolerance class
``f32_reduce`` (rtol 2e-5, relative to the scale of the result: a covariance
entry against ``sqrt(cov_cc * cov_dd)``, dz against its largest magnitude),
for f32 and for bf16 input (a bf16 dz within 1 bf16 ulp of the plain version,
which rounds its f32 result once as the kernel does, plus the f32 kernel's
f32_reduce allowance for the summation order: ``bf16_ulp_error``);
a bf16 step and a joint step (bf16, whitening on) launch the bf16 kernels and
match the CPU at class ``bf16`` (rtol 2e-2, atol 1e-3);
a step on the card against the same step on the CPU at class ``conv``;
augmentation with injected draws against the CPU (images at ``f32_reduce``,
masks exact); one Trainer epoch and a validation on the card; the device
post-processing on the card bitwise equal to the CPU, ``device_metrics`` at
``f32_reduce`` (Dice exact), the device upsample within ``f32_reduce`` of the
f64 host one, and a Trainer epoch with fast validation and the montage;
sync BN over a mesh of one process on the card against the CPU at class
``conv``, and the DP step over a world-1 NCCL process group within rtol 2e-3
of the plain step; ``spatial_sharded`` over 2 gloo ranks sharing the card
against the card's unsharded predict (OD at class ``conv``, no OD pixel
flipped, OC at class ``conv``), and over the in-process mesh of two shards
of the card and of every card (``data_mesh(devices=...)``, the second
skipping below two cards; 128 rows, an H that H % (16 N) refused, and
``batch_sharded``), and the transform library on the card
against the CPU with the same draws (``chip_smoke.extras_cases``: images at
``f32_reduce``, masks exact, the elastic transform and the rotation at
``conv``); the graphed epoch (``train/graph.py``): every replayed step trains
on the eager loop's batch bitwise, one step's metrics within the JAX
package's scan-vs-loop bounds (rtol 1e-4, atol 1e-6,
``tests/test_trainer_e2e.py:137-138``) of the default loop's and of the same
step run eagerly with the same capturable Adam, 8 launches of each kernel a
replay, a capture that leaves the state and the generator as they were, and
a capture that meets a host sync raises; the step captured with its device
marks (``utils/trace.py``) stamps every mark of every replayed step in order,
a step captured without them runs no stamp kernel, and both pools are the
same size; the graph under data parallelism
(``Trainer(dp=True)`` over a world-1 NCCL group, and over one NCCL rank a
card on a machine with two or more cards): the replayed batches equal the
loop's, the first step within the scan-vs-loop bounds, 8 launches of each
kernel a replay, the ranks' states bitwise equal, and a resume under the
loop; the training CLI's launcher (``launch_ranks``) on every card of a
machine with two or more: the resume-rollback run ends, every rank leaves
its process group, and the ranks end bitwise equal; the BatchNorm kernels
(``ops/batchnorm_cuda.py``) at each training-mode BatchNorm's shape of the
default step (N = 9), in f32 and bf16, with and without the ReLU, through
``BatchNormReLU`` (the forward kernels in f32, the library's forward in
bf16, then the backward kernels), held by ``chip_smoke.check_batchnorm``: the
f32 forward within 1 ulp of its plain version (its statistics bit for bit)
and within f32_reduce of an f64 truth, the bf16 forward bit for bit the
library's, the backward against an f64 truth, its plain version and the
library's backward through ``F.batch_norm`` + ``F.relu`` (the recomputed
ReLU mask's flips counted: none after the f32 forward, bounded after
bf16's), their other variants, a batch-strided dy, two calls of each bitwise
equal, the inputs they refuse, and the module on the card against the CPU
at class ``conv``; the 2x bilinear
upsample's kernels (``ops/upsample_cuda.py``) at the decoders' four shapes
(batch 9) and at odd and edge shapes: the forward bit for bit the
``F.interpolate`` calls it replaces (two passes in bf16, one in f32), infs,
NaNs, subnormals and signed zeros included; the backward bit for bit its
plain version and within ``f32_reduce`` (bf16: half an ulp) of an f64
``F.interpolate`` backward; two backwards bitwise equal; a captured call
replaying the eager result; the inputs they refuse; and a step's launches of
both (``STEP_LAUNCHES``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.data import augment
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.ops import cuda_lib
from wt_pse_tpu_torch.ops.whitening import feature_covariance
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step
from wt_pse_tpu_torch.train.trainer import Trainer

from torch_numerics import F32_REDUCE_RTOL, bf16_ulp_error

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def assert_cov_close(got, want):
    d = torch.sqrt(torch.diagonal(want, dim1=1, dim2=2).abs())
    err = float(((got - want).abs() / (d[:, :, None] * d[:, None, :])).max())
    assert err <= F32_REDUCE_RTOL, f"f32_reduce: scaled error {err:.3e}"


def assert_scaled_close(got, want):
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= F32_REDUCE_RTOL, f"f32_reduce: error / max|want| = {err:.3e}"


@pytest.mark.parametrize("bad", ["float64", "float16", "channels_last", "3d", "wide"])
def test_wrapper_raises_on_unsupported_input(cuda, bad):
    z = torch.randn(2, 16, 8, 8, device=cuda)
    z = {"float64": z.double(), "float16": z.half(),
         "channels_last": z.contiguous(memory_format=torch.channels_last),
         "3d": z.reshape(2, 16, 64),
         "wide": torch.randn(2, 33, 8, 8, device=cuda)}[bad]
    c = z.shape[1]
    with pytest.raises((TypeError, ValueError)):
        cc.covariance_forward(z)
    with pytest.raises((TypeError, ValueError)):
        cc.covariance_backward(z, torch.zeros(z.shape[0], c, c, device=cuda))


# (shape, storage offset in floats). HW % 4 == 0 with an aligned base takes the
# kernels' 16-byte variants, for C = 16 and for any other C; a ragged HW or a
# base 4 bytes past a 16-byte boundary takes their 4-byte variants.
KERNEL_CASES = [((9, 16, 64, 64), 0), ((9, 16, 256, 256), 0), ((3, 16, 47, 47), 0),
                ((2, 32, 16, 16), 0), ((2, 5, 8, 8), 0), ((2, 32, 33, 31), 0),
                ((1, 5, 1, 3), 0), ((9, 16, 64, 64), 1), ((2, 32, 16, 16), 1)]


def seeded_inputs(cuda, shape, offset, dtype=torch.float32, scale=1.0):
    """z (normal draws times ``scale``, a contiguous view ``offset`` elements
    into its storage) and g, seeded."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = int(np.prod(shape))
    z = (torch.randn(n + offset, device=cuda, generator=gen) * scale).to(dtype)
    z = z[offset:].view(shape)
    g = torch.randn(shape[0], shape[1], shape[1], device=cuda, generator=gen)
    assert z.is_contiguous() and z.storage_offset() == offset
    return z, g


@pytest.mark.parametrize("shape,offset", KERNEL_CASES)
def test_kernels_match_plain_versions(cuda, shape, offset):
    z, g = seeded_inputs(cuda, shape, offset)
    f0, b0 = cc.covariance_forward.launches, cc.covariance_backward.launches
    got_f, got_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    assert (cc.covariance_forward.launches - f0, cc.covariance_backward.launches - b0) == (1, 1)
    assert_cov_close(got_f, cc.covariance_forward_plain(z))
    assert_scaled_close(got_b, cc.covariance_backward_plain(z, g))


# bf16 (shape, storage offset in bf16 values, scale of z). C = 16 with HW % 8
# == 0 and a 16-byte aligned base takes the tensor-core kernels: with a tail
# inside a tile (24 x 24, HW = 576; 40 x 37, HW % 16 == 8), B = 1 and B = 32
# (the Gram's chunk plan and its scratch), values of large and of small
# magnitude. C != 16 with HW % 8 == 0 takes the 16-byte FFMA variants; HW % 8
# == 4, an odd HW or a base 2 or 8 bytes past a 16-byte boundary the narrow ones.
BF16_CASES = [((9, 16, 64, 64), 0, 1.0), ((9, 16, 256, 256), 0, 1.0), ((9, 16, 24, 24), 0, 1.0),
              ((2, 16, 40, 37), 0, 1.0), ((1, 16, 256, 256), 0, 1.0), ((32, 16, 64, 64), 0, 1.0),
              ((9, 16, 64, 64), 0, 3e4), ((9, 16, 64, 64), 0, 1e-3),
              ((3, 16, 18, 18), 0, 1.0), ((3, 16, 47, 47), 0, 1.0), ((2, 32, 16, 16), 0, 1.0),
              ((2, 32, 33, 31), 0, 1.0), ((2, 5, 8, 8), 0, 1.0), ((9, 16, 64, 64), 1, 1.0),
              ((9, 16, 64, 64), 4, 1.0), ((9, 16, 64, 64), 8, 1.0)]


def assert_within_bf16_ulp(got, want):
    worst = bf16_ulp_error(got, want)
    assert worst <= 1.0, f"bf16 dz: {worst:.3f} of (1 ulp + f32_reduce)"


@pytest.mark.parametrize("shape,offset,scale", BF16_CASES)
def test_bf16_kernels_match_plain_versions(cuda, shape, offset, scale):
    z, g = seeded_inputs(cuda, shape, offset, torch.bfloat16, scale)
    f0, b0 = cc.covariance_forward.launches_bf16, cc.covariance_backward.launches_bf16
    got_f, got_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    again_f, again_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    assert (cc.covariance_forward.launches_bf16 - f0,
            cc.covariance_backward.launches_bf16 - b0) == (2, 2)
    assert got_f.dtype == torch.float32 and got_b.dtype == torch.bfloat16
    # the Gram at f32_reduce, dz within 1 bf16 ulp + f32_reduce (PERF.md has
    # what the H100 measured)
    assert_cov_close(got_f, cc.covariance_forward_plain(z))
    assert_within_bf16_ulp(got_b, cc.covariance_backward_plain(z, g))
    assert torch.equal(got_f, again_f) and torch.equal(got_b, again_b)


def test_bf16_autograd_keeps_the_map_bf16(cuda):
    """Under autocast too, the map reaches the kernels as bf16 and its
    gradient comes back bf16."""
    z = torch.randn(3, 16, 32, 32, device=cuda).bfloat16().requires_grad_(True)
    f0 = cc.covariance_forward.launches_bf16
    with torch.autocast("cuda", dtype=torch.bfloat16):
        cov = feature_covariance(z)
    cov.sum().backward()
    assert cov.dtype == torch.float32 and z.grad.dtype == torch.bfloat16
    assert cc.covariance_forward.launches_bf16 - f0 == 1


@pytest.mark.parametrize("shape,offset", [((9, 16, 64, 64), 0), ((3, 16, 47, 47), 0),
                                          ((2, 32, 16, 16), 0), ((2, 32, 33, 31), 0),
                                          ((9, 16, 64, 64), 1)])
def test_two_kernel_calls_are_bitwise_equal(cuda, shape, offset):
    z, g = seeded_inputs(cuda, shape, offset)
    first = cc.covariance_forward(z), cc.covariance_backward(z, g)
    second = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_autograd_gradient_matches_the_cpu(cuda):
    z = torch.randn(3, 16, 40, 24, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", cuda):
        zd = z.to(dev).detach().requires_grad_(True)  # a leaf on either device
        cov = feature_covariance(zd)
        (torch.sum(torch.abs(cov)) + torch.sum(cov ** 2)).backward()
        grads.append(zd.grad.cpu())
    assert_scaled_close(grads[1], grads[0])


def test_step_launches_both_kernels_eight_times_and_matches_the_cpu(cuda):
    hp = default_hparams("WT_PSE")
    cfg = ModelConfig.from_hparams(hp)
    b, hw = 3, 32
    r = np.random.RandomState(5)
    yy, xx = np.mgrid[0:hw, 0:hw]
    od = ((yy - 16) ** 2 + (xx - 16) ** 2 < 100).astype(np.float32)
    oc = ((yy - 16) ** 2 + (xx - 16) ** 2 < 36).astype(np.float32)
    batch = {"image": torch.from_numpy(r.rand(b, 3, hw, hw).astype(np.float32) * 2 - 1),
             "target_od": torch.from_numpy(np.tile(od[None, None], (b, 1, 1, 1))),
             "target_oc": torch.from_numpy(np.tile(oc[None, None], (b, 1, 1, 1)))}
    eps = {k: torch.from_numpy(r.randn(b, 1, hw, hw).astype(np.float32)) for k in EPS_KEYS}
    step_cfg = StepConfig(hp, 3, 1)
    out = []
    for dev in ("cpu", cuda):
        state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(3))
        f0, b0 = cc.covariance_forward.launches, cc.covariance_backward.launches
        metrics = make_train_step(step_cfg, device=dev)(
            state, batch, eps={k: v.to(dev) for k, v in eps.items()})
        torch.cuda.synchronize()
        launched = (cc.covariance_forward.launches - f0, cc.covariance_backward.launches - b0)
        assert launched == ((0, 0) if dev == "cpu" else (8, 8))
        out.append(metrics)
    # conv class: cuDNN against CPU convolutions, f32 with TF32 off. loss_kd{,_oc}
    # read the teacher after an Adam step, whose lr*sign(grad) flips where a
    # gradient is at f32 noise, and train_dice counts thresholded pixels: both
    # are only checked finite.
    for k, v in out[0].items():
        got = float(out[1][k])
        assert np.isfinite(got), k
        if not k.startswith(("loss_kd", "train_dice")):
            np.testing.assert_allclose(got, float(v), rtol=5e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("algorithm", ["WT_PSE", JOINT])
def test_bf16_step_launches_the_bf16_kernels_and_matches_the_cpu(cuda, algorithm):
    """A bf16 step (WT-PSE: 8 launches of each bf16 kernel; the joint variant
    with whitening on: 4) on the card against the CPU, at class bf16: the two
    devices round convolutions and reductions in bf16 at other places."""
    hp = dict(default_hparams(algorithm), compute_dtype="bfloat16", whitening=True)
    cfg = ModelConfig.from_hparams(hp)
    b, hw = 3, 32
    r = np.random.RandomState(6)
    yy, xx = np.mgrid[0:hw, 0:hw]
    od = ((yy - 16) ** 2 + (xx - 16) ** 2 < 100).astype(np.float32)
    batch = {"image": torch.from_numpy(r.rand(b, 3, hw, hw).astype(np.float32) * 2 - 1),
             "target_od": torch.from_numpy(np.tile(od[None, None], (b, 1, 1, 1))),
             "target_oc": torch.from_numpy(np.tile(od[None, None] * 0, (b, 1, 1, 1)))}
    eps = {k: torch.from_numpy(r.randn(b, 1, hw, hw).astype(np.float32)) for k in EPS_KEYS}
    step_cfg = StepConfig(hp, 3, 1, distill=algorithm != JOINT)
    want = 8 if algorithm == "WT_PSE" else 4
    out = []
    for dev in ("cpu", cuda):
        state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(3),
                              algorithm=algorithm)
        counts = (cc.covariance_forward.launches, cc.covariance_backward.launches,
                  cc.covariance_forward.launches_bf16, cc.covariance_backward.launches_bf16)
        metrics = make_train_step(step_cfg, device=dev)(
            state, batch, eps={k: v.to(dev) for k, v in eps.items()})
        torch.cuda.synchronize()
        launched = tuple(n - c for n, c in zip(
            (cc.covariance_forward.launches, cc.covariance_backward.launches,
             cc.covariance_forward.launches_bf16, cc.covariance_backward.launches_bf16),
            counts))
        assert launched == ((0, 0, 0, 0) if dev == "cpu" else (0, 0, want, want))
        assert all(p.dtype == torch.float32 for ns in state.net_states()
                   for p in ns.net.parameters())
        out.append(metrics)
    for k, v in out[0].items():
        got = float(out[1][k])
        assert np.isfinite(got), k
        if k.startswith(("loss_seg", "loss_ins", "loss_dom")):
            # class bf16; chip_smoke.py's small bf16 checks measure 0.28
            # (WT-PSE) and 0.77 (joint) of it on an H100
            np.testing.assert_allclose(got, float(v), rtol=2e-2, atol=1e-3, err_msg=k)


def test_augmentation_matches_the_cpu(cuda):
    r = np.random.RandomState(2)
    b, size = 9, 256
    img = torch.from_numpy((r.rand(b, size, size, 3) * 255).astype(np.uint8))
    lab = torch.from_numpy(r.choice([0, 128, 255], size=(b, size, size)).astype(np.uint8))
    draws = augment.sample_params(b, size, torch.Generator().manual_seed(4), torch.device("cpu"))
    out = [augment.augment_batch(img.to(d), lab.to(d), draws=tuple(t.to(d) for t in draws))
           for d in ("cpu", cuda)]
    assert_scaled_close(out[1]["image"].cpu(), out[0]["image"])
    for k in ("target_od", "target_oc"):
        assert torch.equal(out[1][k].cpu(), out[0][k]), k


def test_trainer_epoch_and_validation_on_the_card(cuda, tmp_path):
    r = np.random.RandomState(3)
    yy, xx = np.mgrid[0:64, 0:64]
    gray = np.full((64, 64), 255, np.uint8)
    gray[(yy - 32) ** 2 + (xx - 32) ** 2 < 300] = 128
    gray[(yy - 32) ** 2 + (xx - 32) ** 2 < 80] = 0
    doms = [FundusDomain(images=r.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                         labels=np.stack([gray] * 4)) for _ in range(3)]
    val = FundusDomain(images=doms[0].images[:3], labels=[np.kron(gray, np.ones((2, 2), np.uint8))] * 3)
    trainer = Trainer(default_hparams("WT_PSE"), doms, val, str(tmp_path / "run"), batch_size=6,
                      max_epoch=1, val_visualization=False, device=cuda)
    f0, b0 = cc.covariance_forward.launches, cc.covariance_backward.launches
    trainer.train()
    steps = trainer.iter_per_epoch
    assert steps == 2
    assert (cc.covariance_forward.launches - f0, cc.covariance_backward.launches - b0) == \
        (8 * steps, 8 * steps)
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rec = f.readline()
    assert "loss_seg" in rec and "NaN" not in rec and "Infinity" not in rec
    val_out = trainer.validate()
    assert len(val_out) == 7 and all(np.isfinite(v) for v in val_out.values())


def _blob_masks(b=4, hw=64, seed=9):
    """Seeded blobs with specks and a hole, and a serpentine path longer than
    H + W (the capped propagation), as (B, H, W) bool."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    m = np.zeros((b, hw, hw), bool)
    for i in range(b - 1):
        for _ in range(4):
            cy, cx, rad = r.randint(6, hw - 6), r.randint(6, hw - 6), r.randint(3, 12)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
        m[i] |= r.rand(hw, hw) > 0.98
        m[i, 30:33, 30:33] = False
    for k, y in enumerate(range(1, hw - 1, 2)):
        m[-1, y, 1:hw - 1] = True
        if y + 1 < hw - 1:
            m[-1, y + 1, hw - 2 if k % 2 == 0 else 1] = True
    return m


def test_device_postprocessing_on_the_card_equals_the_cpu(cuda):
    from wt_pse_tpu_torch.ops import postprocess_device as PD

    m = torch.from_numpy(_blob_masks())
    for fn in (PD.label_components, PD.largest_component, PD.fill_holes):
        assert torch.equal(fn(m.to(cuda)).cpu(), fn(m)), fn.__name__


def test_device_metrics_on_the_card_match_the_cpu(cuda):
    from wt_pse_tpu_torch.train.eval_device import device_metrics

    r = np.random.RandomState(10)
    m = _blob_masks(seed=10)
    logits = torch.from_numpy(np.where(m, 6.0, -6.0).astype(np.float32)
                              + r.randn(*m.shape).astype(np.float32))
    gt = torch.from_numpy(np.roll(m, 2, axis=2).astype(np.float32))
    cpu = device_metrics(logits, logits, gt, gt)
    card = device_metrics(*(t.to(cuda) for t in (logits, logits, gt, gt)))
    for k, v in cpu.items():
        got = card[k].cpu()
        if k.endswith("dice"):
            assert torch.equal(got, v), k
        else:
            assert_scaled_close(got, v)


def test_resize_device_on_the_card_matches_the_host_f64(cuda):
    from wt_pse_tpu_torch.train.eval import _resize_host, resize_device

    x = np.random.RandomState(11).randn(2, 1, 256, 256).astype(np.float32) * 6
    for hw in ((512, 512), (640, 640)):
        got = resize_device(torch.from_numpy(x).to(cuda), hw).cpu().numpy()
        want = _resize_host(x, hw)
        assert np.abs(got - want).max() <= F32_REDUCE_RTOL * np.abs(want).max(), hw


def test_fast_validation_and_the_montage_on_the_card(cuda, tmp_path):
    r = np.random.RandomState(12)
    yy, xx = np.mgrid[0:64, 0:64]
    gray = np.full((64, 64), 255, np.uint8)
    gray[(yy - 32) ** 2 + (xx - 32) ** 2 < 300] = 128
    gray[(yy - 32) ** 2 + (xx - 32) ** 2 < 80] = 0
    doms = [FundusDomain(images=r.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                         labels=np.stack([gray] * 4)) for _ in range(3)]
    val = FundusDomain(images=doms[0].images[:3], labels=[np.kron(gray, np.ones((2, 2), np.uint8))] * 3)
    trainer = Trainer(default_hparams("WT_PSE"), doms, val, str(tmp_path / "run"), batch_size=6,
                      max_epoch=1, image_size=64, val_visualization=False, fast_validation=True,
                      train_visualization=True, train_viz_interval=1, device=cuda)
    trainer.train()
    out = trainer.validate()
    assert trainer.scoring_backend == "device"
    assert len(out) == 7 and all(np.isfinite(v) for v in out.values())
    assert len(list((tmp_path / "run" / "images").glob("train_*.png"))) == 4 * trainer.iter_per_epoch


def test_sync_bn_on_the_card_matches_the_cpu_at_world_one(cuda):
    """Sync BN over a mesh of one process (its own formula, no collective) on
    the card against the CPU, at class conv: output, input gradient and the
    running statistics."""
    from wt_pse_tpu_torch.models.layers import BatchNorm2d
    from wt_pse_tpu_torch.parallel.mesh import data_mesh

    r = np.random.RandomState(13)
    x = torch.from_numpy((r.randn(4, 16, 32, 32) * 2 + 0.5).astype(np.float32))
    w = torch.from_numpy(r.randn(4, 16, 32, 32).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        bn = BatchNorm2d(16).to(dev)
        bn.mesh = data_mesh()
        xd = x.clone().to(dev).requires_grad_()  # a leaf of its own on each device
        y = bn(xd)
        (y * w.to(dev)).sum().backward()
        out.append([t.detach().cpu() for t in (y, xd.grad, bn.running_mean, bn.running_var)])
    for name, a, b in zip(("output", "grad", "running_mean", "running_var"), out[1], out[0]):
        bound = 1e-5 + 5e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, name


def test_dp_step_over_a_world_one_nccl_mesh_matches_the_plain_step(cuda, tmp_path):
    """A world-1 NCCL process group: the DP step (sync BN, gradient mean,
    pos_weight sum and metric mean all through NCCL) launches 8 of each
    kernel and its metrics are within rtol 2e-3 of the plain step's."""
    import torch.distributed as dist

    from wt_pse_tpu_torch.parallel.distributed import initialize_multihost
    from wt_pse_tpu_torch.parallel.dp import make_dp_fused
    from wt_pse_tpu_torch.parallel.mesh import data_mesh

    hp = default_hparams("WT_PSE")
    b, hw = 3, 32
    r = np.random.RandomState(14)
    yy, xx = np.mgrid[0:hw, 0:hw]
    od = ((yy - 16) ** 2 + (xx - 16) ** 2 < 100).astype(np.float32)
    oc = ((yy - 16) ** 2 + (xx - 16) ** 2 < 36).astype(np.float32)
    batch = {"image": torch.from_numpy(r.rand(b, 3, hw, hw).astype(np.float32) * 2 - 1).to(cuda),
             "target_od": torch.from_numpy(np.tile(od[None, None], (b, 1, 1, 1))).to(cuda),
             "target_oc": torch.from_numpy(np.tile(oc[None, None], (b, 1, 1, 1))).to(cuda)}
    eps = {k: torch.from_numpy(r.randn(b, 1, hw, hw).astype(np.float32)).to(cuda)
           for k in EPS_KEYS}
    assert initialize_multihost(f"file://{tmp_path}/rdzv", 1, 0, cuda.index or 0, "nccl", 60)
    try:
        mesh = data_mesh()
        assert mesh.size == 1 and mesh.group is not None
        dp_state = init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh), device=cuda,
                                 generator=torch.Generator().manual_seed(3))
        step = make_dp_fused([ns.net for ns in dp_state.net_states()], hp, mesh, 3, 1,
                             device=cuda)
        f0, b0 = cc.covariance_forward.launches, cc.covariance_backward.launches
        got = step.train_step(dp_state, batch, eps=eps)
        torch.cuda.synchronize()
        assert (cc.covariance_forward.launches - f0, cc.covariance_backward.launches - b0) == \
            (8, 8)
    finally:
        dist.destroy_process_group()
    state = init_ensemble(ModelConfig.from_hparams(hp), device=cuda,
                          generator=torch.Generator().manual_seed(3))
    want = make_train_step(StepConfig(hp, 3, 1), device=cuda)(state, batch, eps=eps)
    for k, v in want.items():
        assert np.isfinite(float(got[k])), k
        if not k.startswith(("loss_kd", "train_dice")):  # as the step test above
            np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-3, atol=1e-5, err_msg=k)


def test_spatial_sharded_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """The two-stage predict with the image's rows split over 2 gloo ranks on
    the card (the halo exchanges over all-reduce) against the unsharded
    predict on the card."""
    import chip_smoke as cs
    import torch_dp_worker as W
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    image = torch.from_numpy(np.random.RandomState(3).rand(1, 3, 128, 128).astype(np.float32)
                             * 2 - 1)
    nets = cs.spatial_nets(cuda, cs.median_lift(cs.spatial_nets(cuda), image.to(cuda), cuda))
    with torch.no_grad():
        want_od, want_oc = make_predict_fn(*nets, device=cuda)(image.to(cuda))
    sds = [{k: v.cpu().numpy() for k, v in n.state_dict().items()} for n in nets]
    ranks = W.run(W.spatial_rank, tmp_path, [("WT_PSE", None, sds, image.numpy())], "cuda",
                  world=2)
    for (res,) in ranks:
        held = cs.hold_two_stage(res["od"], res["oc"], want_od.cpu().numpy(),
                                 want_oc.cpu().numpy())
        assert held["od_err_of_bound"] <= 1 and held["oc_err_of_bound"] <= 1, held
        assert held["flipped"] == 0 and 0.05 < held["roi_share"] < 0.95, held
        assert res["exchanges"] == 106


SHARDED_S = 180.0  # an in-process sharded predict test fails if its predicts outlast this


def _within(seconds: float, fn):
    """``fn()`` in a thread of its own; fails the test if it has not returned
    within ``seconds`` (a shard waiting on a barrier would otherwise wait
    for the barrier's own timeout)."""
    import threading

    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised in the test's thread
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"the sharded predicts did not return within {seconds} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _local_mesh_predicts_match(cuda, devices: list) -> None:
    """``spatial_sharded`` over the in-process mesh of ``devices`` at 128x128
    and at an H that H % (16 N) refused, and ``batch_sharded`` of 5 images,
    against the single-process predict on the first card: OD at class
    ``conv``, at most 1 in 10^4 OD pixels thresholded the other way, OC at
    class ``conv`` beyond the OC stage's reach, the halo exchanges of a
    predict, the outputs on the mesh's first device."""
    import chip_smoke as cs
    from wt_pse_tpu_torch.parallel.collectives import halo_rows
    from wt_pse_tpu_torch.parallel.mesh import data_mesh
    from wt_pse_tpu_torch.parallel.spatial import batch_sharded, nets_on, spatial_sharded
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    n = len(devices)
    r = np.random.RandomState(3)
    images = {h: torch.from_numpy(r.rand(b, 3, h, 128).astype(np.float32) * 2 - 1).to(cuda)
              for b, h in ((1, 128), (1, 16 * (2 * n + 1)), (5, 64))}
    nets = cs.spatial_nets(cuda, cs.median_lift(cs.spatial_nets(cuda), images[128], cuda))
    single = make_predict_fn(*nets, device=cuda)
    mesh = data_mesh(devices=devices)
    wraps = [(wrap, wrap(lambda d: make_predict_fn(*nets_on(nets, d), device=d), mesh))
             for wrap in (spatial_sharded, batch_sharded)]

    def run():
        out = []
        for h, img in images.items():
            wrap, predict = wraps[h == 64]
            before = halo_rows.exchanges
            od, oc = predict(img)
            out.append((h, od, oc, halo_rows.exchanges - before, single(img)))
        return out

    done = _within(SHARDED_S, run)
    for _, predict in wraps:
        predict.close()
    for h, od, oc, exchanges, (want_od, want_oc) in done:
        assert od.device == mesh.devices[0] and oc.device == mesh.devices[0]
        held = cs.hold_two_stage(od.cpu().numpy(), oc.cpu().numpy(), want_od.cpu().numpy(),
                                 want_oc.cpu().numpy())
        assert held["od_err_of_bound"] <= 1 and held["oc_err_of_bound"] <= 1, (h, held)
        assert held["flipped"] <= 1e-4 * held["pixels"], (h, held)
        assert exchanges == (0 if h == 64 else 106), (h, exchanges)


def test_sharded_predicts_over_two_shards_of_the_card_in_one_process(cuda):
    """The in-process mesh ``[cuda:0, cuda:0]``: two shard threads on the card."""
    _local_mesh_predicts_match(cuda, [torch.device("cuda", 0)] * 2)


def test_sharded_predicts_over_every_card_in_one_process(cuda):
    """The in-process mesh of every visible card, one shard thread a card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards (one shard a card); this machine has {n}")
    _local_mesh_predicts_match(cuda, [torch.device("cuda", i) for i in range(n)])


def test_spatial_sharded_over_more_nccl_ranks_than_row_blocks(cuda, tmp_path):
    """``spatial_sharded`` over one NCCL rank a card on every card (three or
    more) at H = 32 (two 16-row blocks), then at H = 48 (three): the ranks
    past the last block hold no rows, and the others exchange over a
    sub-group of the first ranks. NCCL splits that group from the world's
    communicator, so every rank makes it, in the same order; one that did
    not would leave the others waiting. Every rank gets the unsharded
    predict on the card: OD at class ``conv`` with no OD pixel thresholded
    the other way, OC at class ``conv``."""
    import chip_smoke as cs
    import torch_dp_worker as W
    from wt_pse_tpu_torch.parallel.distributed import run_local_ranks
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    n = torch.cuda.device_count()
    if n < 3:
        pytest.skip(f"needs three or more cards (one NCCL rank a card, more ranks than the "
                    f"two 16-row blocks of H = 32); this machine has {n}")
    r = np.random.RandomState(5)
    images = [torch.from_numpy(r.rand(1, 3, h, h).astype(np.float32) * 2 - 1) for h in (32, 48)]
    nets = cs.spatial_nets(cuda, cs.median_lift(cs.spatial_nets(cuda), images[1].to(cuda), cuda))
    sds = [{k: v.cpu().numpy() for k, v in net.state_dict().items()} for net in nets]
    cases = [("WT_PSE", None, sds, img.numpy()) for img in images]
    ranks = run_local_ranks(W.spatial_rank, n, f"file://{tmp_path}/rdzv", (cases, "cuda"),
                            backend="nccl", local_rank=None, timeout_s=300)
    for img, got in zip(images, zip(*ranks)):
        with torch.no_grad():
            want_od, want_oc = make_predict_fn(*nets, device=cuda)(img.to(cuda))
        holding = img.shape[2] // 16
        for rank, res in enumerate(got):
            held = cs.hold_two_stage(res["od"], res["oc"], want_od.cpu().numpy(),
                                     want_oc.cpu().numpy())
            assert held["od_err_of_bound"] <= 1 and held["oc_err_of_bound"] <= 1, (rank, held)
            assert held["flipped"] == 0, (rank, held)
            assert res["exchanges"] == (106 if rank < holding else 0), (rank, res["exchanges"])


def test_the_transform_library_on_the_card_matches_the_cpu(cuda):
    import chip_smoke as cs

    for name, (fn, kinds) in cs.extras_cases(hw=64).items():
        res = cs.hold_extras(fn(cuda), fn("cpu"), kinds)
        assert res["f32_err_of_bound"] <= 1 and res["conv_err_of_bound"] <= 1, (name, res)
        assert res["exact_diffs"] == 0, (name, res)
        assert res["floor_max"] <= 1 and res["floor_ties"] <= 1e-3 * 64 * 64 * 3, (name, res)


def _graph_trainers(cuda, tmp_path, hp=None, **kw):
    """A graphed Trainer (the default on the card) and an eager-loop one from
    one seed, on 64x64 pools of 3 domains x 4, batch 6 = 3 x 2 (2 steps an
    epoch); ``kw`` goes to both."""
    r = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:64]
    gray = np.full((64, 64), 255, np.uint8)
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 300] = 128
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 80] = 0
    doms = [FundusDomain(images=r.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                         labels=np.stack([gray] * 4)) for _ in range(3)]
    return [Trainer(hp or default_hparams("WT_PSE"), doms, doms[0],
                    str(tmp_path / f"run_{scan}"), batch_size=6, max_epoch=2,
                    val_visualization=False, scan_epochs=scan, device=cuda, **kw)
            for scan in (None, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_epoch_draws_the_loops_batches_and_matches_its_first_step(cuda, tmp_path,
                                                                         dtype):
    """From one seed, each replayed step trains on the eager loop's batch,
    bitwise (the graph reads the run's generator stream), and the first
    step's metrics are within the scan-vs-loop bounds of the loop's."""
    import chip_smoke as cs

    graph, loop = _graph_trainers(
        cuda, tmp_path, dict(default_hparams("WT_PSE"), compute_dtype=dtype))
    assert graph.scan_epochs and not loop.scan_epochs
    res = cs.graph_vs_loop_epoch(graph, loop)
    assert all(res["batches_bitwise_equal"]) and len(res["batches_bitwise_equal"]) == 2, res
    assert res["first_step"]["err_of_bound"] <= 1.0, res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_matches_the_same_step_eager(cuda, dtype):
    """One step from one state, graphed against the same step eager with the
    same capturable Adam: metrics within the scan-vs-loop bounds (in bf16 the
    two read through a teacher after its update at class bf16:
    ``chip_smoke.POST_UPDATE``). The largest parameter differences are
    printed beside each other, with no bound (as the JAX package's
    scan-vs-loop test compares no parameters). A captured step counts 8
    launches of each covariance kernel, 198 of the BatchNorm forward in f32
    (none in bf16, whose forward is PyTorch's) and 148 of its backward, 32 of
    the upsample's forward and 24 of its backward (``STEP_LAUNCHES``)."""
    import chip_smoke as cs

    res = cs.graph_vs_eager_step(cuda, dict(default_hparams("WT_PSE"), compute_dtype=dtype),
                                 "WT_PSE", hw=32)
    print(res)
    assert res["graph_vs_eager"]["err_of_bound"] <= 1.0, res
    key = "launches_bf16" if dtype == "bfloat16" else "launches"
    assert res["launches_a_step"] == {f"{k}.{key}": n for k, n in STEP_LAUNCHES.items()
                                      if key == "launches" or k not in F32_ONLY}, res


# the hand-written kernels' launches in a step of the default WT_PSE
# configuration in f32, and in bf16 but for ``F32_ONLY`` (the bf16 BatchNorm
# forward is PyTorch's). BatchNorm: 198 training-mode forwards a step (the
# teachers' no-grad ones too), 148 backwards. The upsample: 4 a U-Net forward,
# 8 U-Net forwards a step (the teachers' 2 without grad), 6 backwards
STEP_LAUNCHES = {"covariance_forward": 8, "covariance_backward": 8,
                 "batch_norm_forward": 198, "batch_norm_backward": 148,
                 "upsample2x_forward": 32, "upsample2x_backward": 24}
F32_ONLY = ("batch_norm_forward",)


def test_capture_leaves_the_run_as_it_was_and_replays_count_their_launches(cuda, tmp_path):
    """Capturing the step changes no weight, BatchNorm statistic, Adam state,
    step count or generator state, and the launch counters move by the
    warm-up's eager steps alone (``STEP_LAUNCHES`` a step), not by the
    capture; each replay adds a
    step's launches and one step."""
    from wt_pse_tpu_torch.train.graph import COUNTED, WARMUP_STEPS, GraphedStep

    graph, _ = _graph_trainers(cuda, tmp_path)
    state, gen = graph.state, graph._gen
    gen.manual_seed(7)

    def snapshot():
        torch.cuda.synchronize()
        tensors = [t.clone() for ns in state.net_states()
                   for t in list(ns.net.state_dict().values()) +
                   [v for st in ns.opt.state.values() for v in st.values()]]
        return tensors, gen.get_state(), state.step, cuda_lib.launch_counts(COUNTED)

    before = snapshot()
    again = GraphedStep(state, graph._train_step, graph.last_batch, capacity=2,
                        batch_fn=graph._batch_fn, data=graph.data, generator=gen)
    again.capture()
    after = snapshot()
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert len(before[0]) == len(after[0])
    assert torch.equal(before[1], after[1]) and before[2] == after[2]
    warmup = {k: STEP_LAUNCHES[k[0]] * WARMUP_STEPS if k[1] == "launches" else 0
              for k in before[3]}
    assert {k: after[3][k] - n for k, n in before[3].items()} == warmup
    metrics = again.replay(2)
    torch.cuda.synchronize()
    replays = {k: STEP_LAUNCHES[k[0]] * 2 if k[1] == "launches" else 0 for k in before[3]}
    assert {k: n - after[3][k] for k, n in cuda_lib.launch_counts(COUNTED).items()} == replays
    assert state.step == before[2] + 2
    assert all(v.shape == (2,) and torch.isfinite(v).all() for v in metrics.values())


def test_a_capture_that_meets_a_host_sync_raises(cuda, tmp_path):
    """A step that reads a value on the host (``.item()``) cannot be captured:
    the capture raises, nothing falls back to the eager loop, and the step
    count and launch counters are left as the capture found them."""
    from wt_pse_tpu_torch.train.graph import COUNTED, WARMUP_STEPS, GraphedStep

    graph, _ = _graph_trainers(cuda, tmp_path)

    def syncing_step(state, batch, generator=None, eps=None):
        metrics = graph._train_step(state, batch, generator=generator, eps=eps)
        if metrics["loss_seg"].item() > 1e9:  # a Python branch on a value
            metrics["loss_seg"] = metrics["loss_seg"] * 0
        return metrics

    gs = GraphedStep(graph.state, syncing_step, graph.last_batch, capacity=1,
                     batch_fn=graph._batch_fn, data=graph.data, generator=graph._gen)
    step, counts = graph.state.step, cuda_lib.launch_counts(COUNTED)
    with pytest.raises(RuntimeError):
        gs.capture()
    assert gs.graph is None and graph.state.step == step
    # the eager warm-up's launches stay counted, the failed capture's do not
    warmup = {k: STEP_LAUNCHES[k[0]] * WARMUP_STEPS if k[1] == "launches" else 0
              for k in counts}
    assert {k: n - counts[k] for k, n in cuda_lib.launch_counts(COUNTED).items()} == warmup


def test_marked_capture_replays_epochs_with_monotone_stamps(cuda, tmp_path):
    """A Trainer with ``trace_dir`` captures its step with its 18 marks under
    the sync debug mode "error", so no mark syncs with the host. Each
    epoch's replays stamp every mark of every step in order on the card's
    clock, which the epoch's brackets put inside the host's ``epoch`` span;
    the host launches no stamp for a replay (only the brackets' 5 at each
    end of an epoch), and ``train`` writes ``spans.json``."""
    import json

    trainer, _ = _graph_trainers(cuda, tmp_path, trace_dir=str(tmp_path / "trace"))
    g = trainer._graph
    assert g.marks.names[0] == "step.start" and g.marks.names[-1] == "metrics"
    assert len(g.marks.names) == 18
    launches = g.stamp_launches
    trainer.train()
    assert g.stamp_launches == launches + 2 * 2 * 5
    assert [rec.epoch for rec in trainer.tracer.stamped] == [0, 1]
    for rec in trainer.tracer.stamped:
        s = rec.stamps
        assert s.shape == (18, 2) and (s > 0).all()
        assert (np.diff(s, axis=0) >= 0).all() and (s[0, 1:] >= s[-1, :-1]).all()
        host = rec.to_host(s)
        width = max(w for _, _, w in rec.clock)
        epoch = next(e for e in trainer.tracer.closed("epoch") if e.epoch == rec.epoch)
        assert epoch.start - width <= host.min() and host.max() <= epoch.end + width
    doc = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert sum(e["name"] == "step" for e in doc["traceEvents"]) == 4


def test_unmarked_capture_launches_no_stamp_kernel_and_marks_keep_the_pool(cuda, tmp_path):
    """Off by default: a replay of the captured step runs no stamp kernel
    (none in its profile) and the host launched none. Turned on
    (``start_device_spans``, twice: the second does nothing), the step is
    captured again with 18 stamp kernels in a replay, into a pool of the
    same size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, _ = _graph_trainers(cuda, tmp_path)
    g = trainer._graph
    assert g.marks is None and g.stamp_launches == 0
    pool = g.pool_bytes

    def stamp_kernels():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.epoch_step(0, 1)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        assert len(names) > 100
        return sum("stamp_kernel" in n for n in names)

    assert stamp_kernels() == 0
    trainer.start_device_spans()
    graph = g.graph
    trainer.start_device_spans()
    assert g.graph is graph and g.pool_bytes == pool, (g.pool_bytes, pool)
    assert stamp_kernels() == 18


def test_dp_trainer_over_world_one_nccl_captures_and_replays_the_loops_batches(cuda, tmp_path):
    """``Trainer(dp=True)`` in a rank of a world-1 NCCL group captures the
    data-parallel step, collectives included (``run_meta.json``: driver
    ``graph``); from one seed its replayed batches equal the loop's bitwise;
    a replayed epoch moves the launch counters by 8 of each kernel a step;
    the graphed run's checkpoint (written between replays, with the barrier
    after it) resumes under the loop and trains an epoch, and under the DP
    graph, where a non-finite epoch rolls back bitwise."""
    from wt_pse_tpu_torch.parallel.distributed import run_local_ranks

    from torch_dp_worker import dp_graph_rank

    (res,) = run_local_ranks(dp_graph_rank, 1, f"file://{tmp_path}/rdzv", (str(tmp_path),),
                             backend="nccl", local_rank=cuda.index or 0, timeout_s=300)
    _assert_dp_graph_rank(res)


def _assert_dp_graph_rank(res):
    """``torch_dp_worker.dp_graph_rank``'s record of one rank: the graph and
    the loop from one seed draw the same batches, their first steps agree at
    the scan-vs-loop bounds (rtol 1e-4, atol 1e-6), 8 launches of each kernel
    a replayed step (and the upsample's: ``STEP_LAUNCHES``; sync BatchNorm
    launches none of the port's BatchNorm kernels), the checkpoint resumes under the loop and,
    restored in place, under the DP graph, whose ``nan_recovery`` rolls back
    bitwise into the graph's tensors."""
    assert res["drivers"] == ["graph", "eager"] and res["graphed"], res
    graph, loop = res["first_step"]
    assert set(graph) == set(loop)
    for k, v in loop.items():
        np.testing.assert_allclose(graph[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert res["same_batches"] == [True] * res["iter_per_epoch"], res
    per_step = {f"{k}.launches": n for k, n in STEP_LAUNCHES.items()
                if not k.startswith("batch_norm_")}
    assert res["launches_a_step"] == per_step, res
    assert res["launches_an_epoch"] == {k: n * res["iter_per_epoch"]
                                        for k, n in per_step.items()}, res
    assert res["checkpoint"] and res["resumed"]["driver"] == "eager", res
    assert res["resumed"]["start"] == res["step"] == 6 * res["iter_per_epoch"], res
    assert res["resumed"]["step"] == res["step"] + res["iter_per_epoch"], res
    assert res["resumed"]["finite"], res
    again = res["resumed_graph"]
    assert again["driver"] == "graph" and again["restored_alike"], again
    assert again["epochs"] == 3 and again["rollbacks"] == 1, again
    assert again["rolled_back"] and again["finite"], again


def test_dp_graph_across_cards_captures_the_collectives_and_keeps_the_ranks_equal(cuda,
                                                                                  tmp_path):
    """On every card of the machine (two or more: NCCL takes one rank a card),
    ``Trainer(dp=True)`` captures the data-parallel step with its NCCL
    collectives across the ranks, the MMD gather included; on each rank it
    holds what the world-1 test holds, and every rank ends the graphed run
    with the same state, bitwise."""
    from wt_pse_tpu_torch.parallel.distributed import run_local_ranks

    from torch_dp_worker import dp_graph_rank

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards (one NCCL rank a card); this machine has {n}")
    res = run_local_ranks(dp_graph_rank, n, f"file://{tmp_path}/rdzv", (str(tmp_path),),
                          backend="nccl", local_rank=None, timeout_s=300)
    for r in res:
        _assert_dp_graph_rank(r)
    assert len({r["digest"] for r in res}) == 1


def test_launcher_runs_the_resume_rollback_sequence_on_every_card_and_ends(cuda, tmp_path):
    """The training CLI's launcher (``launch_ranks``), one NCCL rank a card on
    every card (two or more), runs ``dp_graph_rank`` on each: a graphed
    ``Trainer(dp=True)`` to its checkpoint, a resume under the loop, and one
    under the DP graph whose second epoch is made non-finite and rolled back
    (``nan_recovery``) before it trains to its last epoch. Each rank holds
    what the world-1 test holds, the ranks end bitwise equal, and every rank
    leaves its process group: the launcher raises if one is still up
    ``TEARDOWN_S`` after its result, as every rank was, in
    ``destroy_process_group``, while the rolled-back trainer's CUDA graph
    (kept by a reference cycle) held NCCL's communicator, until the teardown
    collected garbage first. Bound: 300 s."""
    from wt_pse_tpu_torch.parallel.distributed import launch_ranks

    from torch_dp_worker import launched_dp_graph_rank

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards (one NCCL rank a card); this machine has {n}")
    res = launch_ranks(launched_dp_graph_rank, n, (str(tmp_path),), deadline_s=300)
    assert len(res["ranks"]) == n
    for r in res["ranks"]:
        _assert_dp_graph_rank(r)
    assert len({r["digest"] for r in res["ranks"]}) == 1


# -- training-mode BatchNorm + ReLU (ops/batchnorm_cuda.py) --------------------

# (C, H, W) of every training-mode BatchNorm of the default WT_PSE step at
# 256x256 (batch 9): the layers' own shapes
BN_SHAPES = [(16, 256, 256), (32, 256, 256), (32, 128, 128), (64, 128, 128), (64, 64, 64),
             (128, 64, 64), (128, 32, 32), (256, 32, 32), (256, 16, 16)]


def bn_inputs(cuda, shape, dtype, seed=0, offset=0):
    """x = 2 N(0, 1) + 0.5 (a view ``offset`` values into its storage), dy,
    weight, bias and fresh running statistics, seeded."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    x = (torch.randn(n + offset, device=cuda, generator=gen) * 2 + 0.5).to(dtype)
    x = x[offset:].view(shape)
    dy = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    c = shape[1]
    w = torch.rand(c, device=cuda, generator=gen) + 0.5
    b = torch.randn(c, device=cuda, generator=gen) * 0.5
    stats = (torch.zeros(c, device=cuda), torch.ones(c, device=cuda),
             torch.zeros((), dtype=torch.long, device=cuda))
    return x, dy, w, b, stats


def assert_bn_backward_holds(x, dy, w, b, relu):
    """``chip_smoke.check_batchnorm``: ``BatchNormReLU`` (the forward kernels
    in f32, the library's forward in bf16, then the backward kernels). The
    f32 forward within 1 ulp of its plain version, its saved and running
    statistics and ``num_batches_tracked`` bit for bit, and y and the
    statistics within f32_reduce of an f64 truth; the bf16 forward bit for
    bit the library's. The backward within the kernels' tolerance of an f64
    truth with their ReLU mask and of the plain version, and of the library's
    backward through its own forward + ``F.relu`` within that tolerance and
    the library's own distance from its truth (ATen's bf16 channel sums read
    up to 64x f32_reduce from it); the recomputed mask flips on no element
    after the f32 forward, after the bf16 one on at most 1e-5 of the
    elements, each within 8 f32 ulps of 0."""
    import chip_smoke as cs
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    res = cs.check_batchnorm(bn, x, dy, w, b, relu)
    print(res)
    assert res["ok"], res


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("chw", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_kernels_match_plain_versions(cuda, chw, dtype, relu):
    """Each layer's shape at N = 9 through ``BatchNormReLU`` (the forward
    kernels in f32, ATen's forward in bf16, then the backward kernels; one
    launch of each kernel pair counted), as ``assert_bn_backward_holds``."""
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    x, dy, w, b, _ = bn_inputs(cuda, (9,) + chw, dtype)
    fns = (bn.batch_norm_forward, bn.batch_norm_backward)
    before = cuda_lib.launch_counts(fns)
    assert_bn_backward_holds(x, dy, w, b, relu)
    torch.cuda.synchronize()
    key = "launches" if dtype == torch.float32 else "launches_bf16"
    want = dict.fromkeys(before, 0)
    want["batch_norm_backward", key] = 1
    want["batch_norm_forward", key] = int(dtype == torch.float32)
    after = cuda_lib.launch_counts(fns)
    assert {k: after[k] - n for k, n in before.items()} == want


# the kernels' other variants: HW not a multiple of the values in 16 bytes, a
# base past a 16-byte boundary (one value a load), N = 1, one channel, and a
# channel of fewer values than a block has threads
BN_VARIANTS = [((3, 5, 7, 7), 0), ((2, 16, 33, 31), 0), ((9, 16, 64, 64), 1),
               ((1, 32, 64, 64), 0), ((4, 1, 128, 128), 0), ((2, 64, 4, 4), 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,offset", BN_VARIANTS)
def test_batchnorm_kernel_variants_match_plain_versions(cuda, shape, offset, dtype):
    x, dy, w, b, _ = bn_inputs(cuda, shape, dtype, offset=offset)
    assert_bn_backward_holds(x, dy, w, b, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batchnorm_backward_takes_a_channel_slice_of_a_gradient(cuda, dtype):
    """dy with a batch stride of its own (the gradient of one half of a
    channel concat): the same dx, dweight and dbias as from its contiguous
    copy, bit for bit."""
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    x, _, w, b, stats = bn_inputs(cuda, (9, 16, 64, 64), dtype)
    big = torch.randn(9, 48, 64, 64, device=cuda).to(dtype)
    dy = big[:, 16:32]
    assert not dy.is_contiguous()
    _, mean, invstd = bn.forward_library(x, w, b, *stats, 0.1, 1e-5, True)
    got = bn.batch_norm_backward(x, dy, mean, invstd, w, b, True)
    want = bn.batch_norm_backward(x, dy.contiguous(), mean, invstd, w, b, True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, v) for g, v in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("chw", [(16, 256, 256), (64, 64, 64), (256, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_two_batchnorm_kernel_calls_are_bitwise_equal(cuda, chw, dtype):
    """No atomics: two calls give the same dx, dweight and dbias, bit for
    bit; in f32 two forwards the same y, saved statistics and running
    statistics too."""
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    x, dy, w, b, stats = bn_inputs(cuda, (9,) + chw, dtype)
    _, mean, invstd = bn.forward_library(x, w, b, *stats, 0.1, 1e-5, True)
    out = [bn.batch_norm_backward(x, dy, mean, invstd, w, b, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))
    if dtype == torch.float32:
        runs = []
        for _ in range(2):
            st = [t.clone() for t in stats]
            runs.append([*bn.batch_norm_forward(x, w, b, *st, 0.1, 1e-5, True), *st])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("bad", ["float64", "float16", "channels_last", "non_contiguous"])
def test_batchnorm_wrappers_raise_on_unsupported_input(cuda, bad):
    """Both wrappers; the forward refuses a bf16 x too (its kernels are
    exported for f32 alone), and parameters of another shape."""
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    x, dy, w, b, stats = bn_inputs(cuda, (2, 16, 8, 8), torch.float32)
    with pytest.raises(TypeError):
        bn.batch_norm_forward(x.bfloat16(), w, b, *stats, 0.1, 1e-5, True)
    with pytest.raises(ValueError):
        bn.batch_norm_forward(x, w[:8], b, *stats, 0.1, 1e-5, True)
    x = {"float64": x.double(), "float16": x.half(),
         "channels_last": x.contiguous(memory_format=torch.channels_last),
         "non_contiguous": x.transpose(2, 3)}[bad]
    mean, invstd = torch.zeros(16, device=cuda), torch.ones(16, device=cuda)
    for relu in (True, False):
        with pytest.raises((TypeError, ValueError)):
            bn.batch_norm_backward(x, dy.to(x.dtype), mean, invstd, w, b, relu)
        with pytest.raises((TypeError, ValueError)):
            bn.batch_norm_forward(x, w, b, *stats, 0.1, 1e-5, relu)


def test_batchnorm_module_on_the_card_matches_the_cpu(cuda):
    """``BatchNorm2d(relu=True)`` in training on the card (the forward and
    backward kernels) against the CPU (``nn.BatchNorm2d`` + ``F.relu``), at
    class conv: output, input and parameter gradients, running statistics;
    one forward and one backward launch on the card, none on the CPU or in
    eval mode."""
    from wt_pse_tpu_torch.models.layers import BatchNorm2d
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    r = np.random.RandomState(17)
    x = torch.from_numpy((r.randn(4, 16, 32, 32) * 2 + 0.5).astype(np.float32))
    w = torch.from_numpy(r.randn(4, 16, 32, 32).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        m = BatchNorm2d(16, relu=True).to(dev)
        xd = x.clone().to(dev).requires_grad_()
        b0, f0 = bn.batch_norm_backward.launches, bn.batch_norm_forward.launches
        y = m(xd)
        (y * w.to(dev)).sum().backward()
        assert bn.batch_norm_backward.launches - b0 == (0 if dev == "cpu" else 1)
        m.eval()
        y_eval = m(x.to(dev))
        assert bn.batch_norm_forward.launches - f0 == (0 if dev == "cpu" else 1)
        out.append([t.detach().cpu() for t in (y, xd.grad, m.weight.grad, m.bias.grad,
                                                m.running_mean, m.running_var, y_eval)])
    names = ("output", "grad", "dweight", "dbias", "running_mean", "running_var", "eval")
    for name, a, b in zip(names, out[1], out[0]):
        bound = 1e-5 + 5e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, name


# -- the 2x bilinear upsample (ops/upsample_cuda.py) ----------------------------

# (N, C, H, W) of the decoders' four upsamples in the default step (batch 9),
# then odd and edge shapes: sides 1 to 3, a W that is not a multiple of 4 (the
# one-value variant), a tall and a wide map
UPSAMPLE_SHAPES = [(9, 256, 16, 16), (9, 128, 32, 32), (9, 64, 64, 64), (9, 32, 128, 128),
                   (2, 3, 1, 1), (3, 5, 3, 7), (2, 4, 2, 2), (1, 3, 17, 5), (2, 8, 16, 6),
                   (2, 2, 40, 4), (1, 2, 4, 40)]
up_ids = ["x".join(map(str, s)) for s in UPSAMPLE_SHAPES]


def upsample_input(cuda, shape, dtype, seed=0, offset=0, special=True):
    """Normal draws times 3 (a view ``offset`` values into its storage) with,
    where ``special``, every 97th value an inf, -inf, NaN, subnormal, -0 or
    0 in turns."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device=cuda, generator=gen) * 3
    if special:
        vals = torch.tensor([float("inf"), -float("inf"), float("nan"), 1e-39, -0.0, 0.0],
                            device=cuda)
        idx = torch.arange(offset, n + offset, 97, device=cuda)
        x[idx] = vals[torch.arange(len(idx), device=cuda) % len(vals)]
    return x.to(dtype)[offset:].view(shape)


def assert_same_bits(got, want):
    """Bit for bit, a NaN taken as equal to any NaN (the payload aside)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    diff = (got.view(ints) != want.view(ints)) & ~nan
    assert int(diff.sum()) == 0, (int(diff.sum()), got[diff][:8], want[diff][:8])


def aten_upsample(x):
    """What the kernel replaces: the two-pass resize in bf16, one pass in
    f32."""
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, scale_factor=(2, 1), mode="bilinear", align_corners=False)
        return F.interpolate(x, scale_factor=(1, 2), mode="bilinear", align_corners=False)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=up_ids)
def test_upsample_forward_is_atens_bitwise(cuda, shape, dtype):
    """The forward kernel against the ``F.interpolate`` calls it replaces, bit
    for bit, with infs, NaNs, subnormals and signed zeros among the inputs;
    also from a base 2 values past a 16-byte boundary (the one-value
    variant). One launch counted."""
    from wt_pse_tpu_torch.ops import upsample_cuda as up

    for offset in (0, 2):
        x = upsample_input(cuda, shape, dtype, offset=offset)
        key = "launches_bf16" if dtype == torch.bfloat16 else "launches"
        before = getattr(up.upsample2x_forward, key)
        got = up.upsample2x_forward(x)
        assert getattr(up.upsample2x_forward, key) - before == 1
        torch.cuda.synchronize()
        assert_same_bits(got, aten_upsample(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=up_ids)
def test_upsample_backward_matches_an_f64_interpolate_backward(cuda, shape, dtype):
    """The backward kernel is its plain version on the card, bit for bit,
    and within ``f32_reduce`` of ``F.interpolate``'s f64 backward (in bf16,
    half a bf16 ulp with the ``f32_reduce`` allowance: one rounding of an
    f32 sum); also from a base 2 values past a 16-byte boundary."""
    from wt_pse_tpu_torch.ops import upsample_cuda as up

    n, c, h, w = shape
    for offset in (0, 2):
        dy = upsample_input(cuda, (n, c, 2 * h, 2 * w), dtype, seed=1, offset=offset,
                            special=False)
        got = up.upsample2x_backward(dy)
        x64 = torch.zeros(shape, dtype=torch.float64, device=cuda, requires_grad=True)
        F.interpolate(x64, scale_factor=2, mode="bilinear", align_corners=False).backward(
            dy.double())
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got, up.upsample2x_backward_plain(dy))
        if dtype == torch.bfloat16:
            assert bf16_ulp_error(got, x64.grad) <= 0.5
        else:
            assert_scaled_close(got.double(), x64.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_upsample_backward_calls_are_bitwise_equal(cuda, dtype):
    """No atomics: two backward calls at the largest decoder shape give the
    same bits (ATen's bf16 backward adds with atomics in bf16, in an order
    that changes from call to call)."""
    from wt_pse_tpu_torch.ops import upsample_cuda as up

    dy = upsample_input(cuda, (9, 32, 256, 256), dtype, seed=2, special=False)
    a, b = up.upsample2x_backward(dy), up.upsample2x_backward(dy)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_captured_upsample_replays_the_eager_result(cuda, dtype):
    """``Upsample2x`` forward and backward captured in a CUDA graph (the
    library loaded before, as the warm-up steps load it): a replay on new
    inputs gives the eager call's output and gradient, bit for bit."""
    from wt_pse_tpu_torch.models.layers import upsample2x

    shape = (9, 64, 64, 64)
    x = upsample_input(cuda, shape, dtype, special=False).requires_grad_()
    dy = upsample_input(cuda, (9, 64, 128, 128), dtype, seed=1, special=False)
    warm = x.detach().clone().requires_grad_()  # a leaf of its own: x's grad node is the graph's
    upsample2x(warm).backward(dy)  # loads the library and warms the allocator
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = upsample2x(x)
        y_static.backward(dy)
    with torch.no_grad():
        x.copy_(upsample_input(cuda, shape, dtype, seed=7, special=False))
        dy.copy_(upsample_input(cuda, dy.shape, dtype, seed=8, special=False))
    x.grad.zero_()
    graph.replay()
    torch.cuda.synchronize()
    xe = x.detach().clone().requires_grad_()
    ye = upsample2x(xe)
    ye.backward(dy)
    torch.cuda.synchronize()
    assert torch.equal(y_static, ye) and torch.equal(x.grad, xe.grad)


@pytest.mark.parametrize("bad", ["float64", "float16", "channels_last", "3d", "empty"])
def test_upsample_wrappers_raise_on_unsupported_input(cuda, bad):
    from wt_pse_tpu_torch.ops import upsample_cuda as up

    x = torch.randn(2, 4, 8, 8, device=cuda)
    x = {"float64": x.double(), "float16": x.half(),
         "channels_last": x.contiguous(memory_format=torch.channels_last),
         "3d": x.reshape(2, 4, 64), "empty": x[:0]}[bad]
    with pytest.raises((TypeError, ValueError)):
        up.upsample2x_forward(x)
    with pytest.raises((TypeError, ValueError)):
        up.upsample2x_backward(x)
