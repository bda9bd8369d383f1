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
flipped, OC at class ``conv``), and the transform library on the card
against the CPU with the same draws (``chip_smoke.extras_cases``: images at
``f32_reduce``, masks exact, the elastic transform and the rotation at
``conv``); the graphed epoch (``train/graph.py``): every replayed step trains
on the eager loop's batch bitwise, one step's metrics within the JAX
package's scan-vs-loop bounds (rtol 1e-4, atol 1e-6,
``tests/test_trainer_e2e.py:137-138``) of the default loop's and of the same
step run eagerly with the same capturable Adam, 8 launches of each kernel a
replay, a capture that leaves the state and the generator as they were, and
a capture that meets a host sync raises; the graph under data parallelism
(``Trainer(dp=True)`` over a world-1 NCCL group, and over one NCCL rank a
card on a machine with two or more cards): the replayed batches equal the
loop's, the first step within the scan-vs-loop bounds, 8 launches of each
kernel a replay, the ranks' states bitwise equal, and a resume under the
loop.
"""

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.data import augment
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.ops import covariance_cuda as cc
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


def test_the_transform_library_on_the_card_matches_the_cpu(cuda):
    import chip_smoke as cs

    for name, (fn, kinds) in cs.extras_cases(hw=64).items():
        res = cs.hold_extras(fn(cuda), fn("cpu"), kinds)
        assert res["f32_err_of_bound"] <= 1 and res["conv_err_of_bound"] <= 1, (name, res)
        assert res["exact_diffs"] == 0, (name, res)
        assert res["floor_max"] <= 1 and res["floor_ties"] <= 1e-3 * 64 * 64 * 3, (name, res)


def _graph_trainers(cuda, tmp_path, hp=None):
    """A graphed Trainer (the default on the card) and an eager-loop one from
    one seed, on 64x64 pools of 3 domains x 4, batch 6 = 3 x 2 (2 steps an
    epoch)."""
    r = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:64]
    gray = np.full((64, 64), 255, np.uint8)
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 300] = 128
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 80] = 0
    doms = [FundusDomain(images=r.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
                         labels=np.stack([gray] * 4)) for _ in range(3)]
    return [Trainer(hp or default_hparams("WT_PSE"), doms, doms[0],
                    str(tmp_path / f"run_{scan}"), batch_size=6, max_epoch=2,
                    val_visualization=False, scan_epochs=scan, device=cuda)
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
    ``chip_smoke.POST_UPDATE``). The bilinear upsample's backward adds with
    atomics on the card, so two eager runs need not agree bitwise; the
    largest parameter differences are printed beside each other, with no
    bound (as the JAX package's scan-vs-loop test compares no parameters)."""
    import chip_smoke as cs

    res = cs.graph_vs_eager_step(cuda, dict(default_hparams("WT_PSE"), compute_dtype=dtype),
                                 "WT_PSE", hw=32)
    print(res)
    assert res["graph_vs_eager"]["err_of_bound"] <= 1.0, res
    key = "launches_bf16" if dtype == "bfloat16" else "launches"
    assert res["launches_a_step"] == {f"covariance_forward.{key}": 8,
                                      f"covariance_backward.{key}": 8}, res


def test_capture_leaves_the_run_as_it_was_and_replays_count_their_launches(cuda, tmp_path):
    """Capturing the step changes no weight, BatchNorm statistic, Adam state,
    step count or generator state, and the launch counters move by the
    warm-up's eager steps alone (8 of each kernel a step), not by the
    capture; each replay adds 8 launches of each kernel and one step."""
    from wt_pse_tpu_torch.train.graph import WARMUP_STEPS, GraphedStep

    graph, _ = _graph_trainers(cuda, tmp_path)
    state, gen = graph.state, graph._gen
    gen.manual_seed(7)

    def snapshot():
        torch.cuda.synchronize()
        tensors = [t.clone() for ns in state.net_states()
                   for t in list(ns.net.state_dict().values()) +
                   [v for st in ns.opt.state.values() for v in st.values()]]
        return tensors, gen.get_state(), state.step, cc.launch_counts()

    before = snapshot()
    again = GraphedStep(state, graph._train_step, graph.last_batch, capacity=2,
                        batch_fn=graph._batch_fn, data=graph.data, generator=gen)
    again.capture()
    after = snapshot()
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert len(before[0]) == len(after[0])
    assert torch.equal(before[1], after[1]) and before[2] == after[2]
    warmup = {k: 8 * WARMUP_STEPS if k[1] == "launches" else 0 for k in before[3]}
    assert {k: after[3][k] - n for k, n in before[3].items()} == warmup
    metrics = again.replay(2)
    torch.cuda.synchronize()
    replays = {k: 16 if k[1] == "launches" else 0 for k in before[3]}
    assert {k: n - after[3][k] for k, n in cc.launch_counts().items()} == replays
    assert state.step == before[2] + 2
    assert all(v.shape == (2,) and torch.isfinite(v).all() for v in metrics.values())


def test_a_capture_that_meets_a_host_sync_raises(cuda, tmp_path):
    """A step that reads a value on the host (``.item()``) cannot be captured:
    the capture raises, nothing falls back to the eager loop, and the step
    count and launch counters are left as the capture found them."""
    from wt_pse_tpu_torch.train.graph import WARMUP_STEPS, GraphedStep

    graph, _ = _graph_trainers(cuda, tmp_path)

    def syncing_step(state, batch, generator=None, eps=None):
        metrics = graph._train_step(state, batch, generator=generator, eps=eps)
        if metrics["loss_seg"].item() > 1e9:  # a Python branch on a value
            metrics["loss_seg"] = metrics["loss_seg"] * 0
        return metrics

    gs = GraphedStep(graph.state, syncing_step, graph.last_batch, capacity=1,
                     batch_fn=graph._batch_fn, data=graph.data, generator=graph._gen)
    step, counts = graph.state.step, cc.launch_counts()
    with pytest.raises(RuntimeError):
        gs.capture()
    assert gs.graph is None and graph.state.step == step
    # the eager warm-up's launches stay counted, the failed capture's do not
    warmup = {k: 8 * WARMUP_STEPS if k[1] == "launches" else 0 for k in counts}
    assert {k: n - counts[k] for k, n in cc.launch_counts().items()} == warmup


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
    a replayed step, the checkpoint resumes under the loop and, restored in
    place, under the DP graph, whose ``nan_recovery`` rolls back bitwise
    into the graph's tensors."""
    assert res["drivers"] == ["graph", "eager"] and res["graphed"], res
    graph, loop = res["first_step"]
    assert set(graph) == set(loop)
    for k, v in loop.items():
        np.testing.assert_allclose(graph[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert res["same_batches"] == [True] * res["iter_per_epoch"], res
    per_step = {"covariance_forward.launches": 8, "covariance_backward.launches": 8}
    assert res["launches_a_step"] == per_step, res
    assert res["launches_an_epoch"] == {k: 8 * res["iter_per_epoch"] for k in per_step}, res
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
