"""Shared helpers of the ``tests/test_torch_*.py`` files: layout moves between the
JAX package (NHWC) and the port (NCHW), Flax init, weight carrying, and the
tolerance classes of ``tests/test_goldens.py:49``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from wt_pse_tpu_torch.io.convert import state_dict_from_jax

F32_REDUCE = (2e-5, 1e-9)
CONV = (5e-4, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def torch_single_thread():
    """One intra-op thread for torch while a port test module runs, restored
    after. The suite runs several workers on a few cores; torch's default of a
    thread per core in each of them oversubscribes the CPU, and its OpenMP
    threads then wait on each other (the port's files took 5-8x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.transpose(np.asarray(x), (0, 3, 1, 2)), order="C"))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().cpu().numpy(), (0, 2, 3, 1))


def jax_init(module, method, *args, seed: int = 0) -> dict:
    return module.init({"params": jax.random.PRNGKey(seed)}, *args, method=method)


def carry(port_net: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load JAX ``variables`` into ``port_net`` strictly."""
    port_net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port_net


def assert_close(got, want, cls=CONV, what=""):
    """Normwise comparison at a named tolerance class:
    ``|got - want| <= atol + rtol * max|want|`` for every element. An element
    of a deep conv stack that lies near zero still carries the rounding error
    of its whole receptive field, so its error is held against the tensor's
    scale rather than its own size."""
    rtol, atol = cls
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    bound = atol + rtol * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e} (class {cls})"


def assert_stats_close(port_net: torch.nn.Module, params: dict, batch_stats: dict,
                       cls=CONV):
    """The port's BN running stats equal the JAX ``batch_stats`` (``params``
    name the blocks the stats belong to)."""
    want = state_dict_from_jax({"params": params, "batch_stats": batch_stats})
    have = port_net.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        assert_close(have[k].cpu().numpy(), want[k].numpy(), cls, k)
