"""Tests of the port that need a CUDA card; every test here is marked ``cuda``
and skips without one. They import neither JAX nor the JAX package, so they run
where only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels are held against their plain versions at tolerance class
``f32_reduce`` (rtol 2e-5, relative to the scale of the result: a covariance
entry against ``sqrt(cov_cc * cov_dd)``, dz against its largest magnitude);
a step on the card against the same step on the CPU at class ``conv``.
"""

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.ops.whitening import feature_covariance
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

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


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "channels_last", "3d", "wide"])
def test_wrapper_raises_on_unsupported_input(cuda, bad):
    z = torch.randn(2, 16, 8, 8, device=cuda)
    z = {"float64": z.double(), "bfloat16": z.bfloat16(),
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


def seeded_inputs(cuda, shape, offset):
    """z (a contiguous view ``offset`` floats into its storage) and g, seeded."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = int(np.prod(shape))
    z = torch.randn(n + offset, device=cuda, generator=gen)[offset:].view(shape)
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
