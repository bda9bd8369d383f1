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
f64 host one, and a Trainer epoch with fast validation and the montage.
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

pytestmark = pytest.mark.cuda
F32_REDUCE_RTOL = 2e-5


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


def seeded_inputs(cuda, shape, offset, dtype=torch.float32):
    """z (a contiguous view ``offset`` elements into its storage) and g, seeded."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = int(np.prod(shape))
    z = torch.randn(n + offset, device=cuda, generator=gen).to(dtype)[offset:].view(shape)
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


# bf16: HW % 8 == 0 with a 16-byte aligned base takes the 16-byte variants (8
# values); HW % 8 == 4, an odd HW or a base 2 or 8 bytes past a 16-byte
# boundary takes the narrow ones.
BF16_CASES = [((9, 16, 64, 64), 0), ((9, 16, 256, 256), 0), ((3, 16, 18, 18), 0),
              ((3, 16, 47, 47), 0), ((2, 32, 16, 16), 0), ((2, 32, 33, 31), 0),
              ((2, 5, 8, 8), 0), ((9, 16, 64, 64), 1), ((9, 16, 64, 64), 4),
              ((9, 16, 64, 64), 8)]


def bf16_ulp_error(got, want) -> float:
    """The largest ``|got - want| / (ulp + a)`` over the elements: one bf16
    ulp of the larger magnitude, plus ``a = f32_reduce * max|want|``, what
    the f32 dz kernel is allowed for its summation order. Both sides round
    their f32 sums once; the allowance decides only where the 16 products of
    a value cancel to the f32 noise floor, where another summation order
    rounds the other way by several ulps of the small result."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((got - want).abs() / (ulp + F32_REDUCE_RTOL * want.abs().max())).max())


def assert_within_bf16_ulp(got, want):
    worst = bf16_ulp_error(got, want)
    assert worst <= 1.0, f"bf16 dz: {worst:.3f} of (1 ulp + f32_reduce)"


@pytest.mark.parametrize("shape,offset", BF16_CASES)
def test_bf16_kernels_match_plain_versions(cuda, shape, offset):
    z, g = seeded_inputs(cuda, shape, offset, torch.bfloat16)
    f0, b0 = cc.covariance_forward.launches_bf16, cc.covariance_backward.launches_bf16
    got_f, got_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    again_f, again_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    assert (cc.covariance_forward.launches_bf16 - f0,
            cc.covariance_backward.launches_bf16 - b0) == (2, 2)
    assert got_f.dtype == torch.float32 and got_b.dtype == torch.bfloat16
    # measured on an H100 (chip_smoke.py phase 2, the same cases): the Gram
    # within 5.3e-6 scaled, dz at most 0.99 of (1 ulp + f32_reduce)
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
