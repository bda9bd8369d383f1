"""The port's covariance (``wt_pse_tpu_torch/ops/covariance_cuda.py``) against the
JAX package: the einsum ``feature_covariance`` and the Pallas
``feature_covariance_pallas`` run in interpret mode, forward and gradient.

On the CPU the wrappers take their plain versions; the CUDA kernels are held
against those plain versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.

Tolerance class ``f32_reduce`` (rtol 2e-5, ``tests/test_goldens.py:49``). A
covariance entry is a sum of HW products whose size is bounded by
``sqrt(cov_cc * cov_dd)``; its rounding error scales with that bound, not with
the entry, so entries are compared relative to it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.ops import whitening_pallas
from wt_pse_tpu.ops.whitening import feature_covariance as jax_feature_covariance
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.ops.whitening import feature_covariance

from torch_port import F32_REDUCE, nchw, torch_single_thread  # noqa: F401

F32_REDUCE_RTOL = F32_REDUCE[0]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(whitening_pallas, "INTERPRET", True)


def assert_cov_close(got, want, rtol=F32_REDUCE_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
    scale = d[:, :, None] * d[:, None, :]
    err = np.abs(got - want) / scale
    assert err.max() <= rtol, f"f32_reduce: max scaled error {err.max():.3e} > {rtol}"


@pytest.mark.parametrize("shape", [(3, 64, 64, 16),   # HW a multiple of the tile
                                   (2, 48, 48, 16),   # ragged HW
                                   (2, 20, 36, 8)])   # ragged, narrower C
def test_forward_matches_jax_einsum_and_pallas(shape):
    z = np.random.RandomState(0).randn(*shape).astype(np.float32)  # NHWC
    want_einsum = jax_feature_covariance(jnp.asarray(z))
    want_pallas = whitening_pallas.feature_covariance_pallas(jnp.asarray(z))
    zt = nchw(z)  # NHWC -> NCHW at the boundary between the packages
    for got in (cc.covariance_forward_plain(zt), cc.covariance_forward(zt),
                feature_covariance(zt)):
        assert got.dtype == torch.float32 and got.shape == (shape[0], shape[3], shape[3])
        assert_cov_close(got.numpy(), want_einsum)
        assert_cov_close(got.numpy(), want_pallas)


@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (2, 24, 40, 16)])
def test_gradient_matches_jax_pallas_custom_vjp(shape):
    z = np.random.RandomState(1).randn(*shape).astype(np.float32)

    def loss_jax(z):
        cov = whitening_pallas.feature_covariance_pallas(z)
        return jnp.sum(jnp.abs(cov)) + jnp.sum(cov ** 2)

    want = np.transpose(np.asarray(jax.grad(loss_jax)(jnp.asarray(z))), (0, 3, 1, 2))
    zt = nchw(z).requires_grad_(True)
    cov = feature_covariance(zt)
    (torch.sum(torch.abs(cov)) + torch.sum(cov ** 2)).backward()
    got = zt.grad.numpy()
    # f32_reduce: each dz entry is a C-term sum; compare against the gradient's scale
    np.testing.assert_allclose(got, want, rtol=F32_REDUCE_RTOL,
                               atol=F32_REDUCE_RTOL * np.abs(want).max())


def test_backward_is_the_vjp_of_the_forward():
    """The plain backward formula against autograd through the plain forward, in f64."""
    z = torch.from_numpy(np.random.RandomState(2).randn(3, 16, 9, 11))
    g = torch.from_numpy(np.random.RandomState(3).randn(3, 16, 16))
    zr = z.clone().requires_grad_(True)
    (cc.covariance_forward_plain(zr) * g).sum().backward()
    torch.testing.assert_close(cc.covariance_backward_plain(z, g), zr.grad,
                               rtol=1e-12, atol=1e-12)


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(cc.covariance_forward, "launches", 0)
    monkeypatch.setattr(cc.covariance_backward, "launches", 0)
    z = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    feature_covariance(z).sum().backward()
    assert (cc.covariance_forward.launches, cc.covariance_backward.launches) == (0, 0)
