"""The port's checkpoints (``wt_pse_tpu_torch/io/checkpoint.py``) against the
JAX package's importer, on the CPU.

- A port checkpoint is read by the JAX package's ``load_reference_checkpoint``
  + ``load_into_variables(strict=True)`` with 336/158/336/158 matched leaves,
  and the JAX two-stage predict on those variables gives the port's logits at
  tolerance class ``conv``.
- A reference-layout file built from ``tests/torch_ref.py`` loads into the
  port with the same counts; a leaf of the wrong shape is skipped, or raises
  under ``strict=True``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wt_pse_tpu.io.torch_import import load_into_variables
from wt_pse_tpu.io.torch_import import load_reference_checkpoint as jax_load_reference
from wt_pse_tpu.train.eval import make_predict_fn as jax_make_predict_fn
from wt_pse_tpu_torch.io.checkpoint import NET_KEYS, load_reference_checkpoint, save_ensemble
from wt_pse_tpu_torch.train.eval import make_predict_fn
from wt_pse_tpu_torch.train.state import init_ensemble

import torch_ref
from test_torch_networks import B, CFG, HW, JCFG, JaxStudent, JaxWTPSE
from torch_port import assert_close, jax_init, nchw, nhwc, torch_single_thread  # noqa: F401

COUNTS = {"model": 336, "model_shape": 158, "model_oc": 336, "model_oc_shape": 158}
OD_SHIFT = 1.1  # lifts the OD logits so part of the image lands in the ROI


def _nets(state):
    return tuple(ns.net for ns in state.net_states())


def _port_state(seed):
    """Seeded nets with running stats away from 0/1 and the OD logits lifted."""
    state = init_ensemble(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for net in _nets(state):
            for name, buf in net.named_buffers():
                if name.endswith("running_mean"):
                    buf.add_(0.05 * torch.randn(buf.shape, generator=gen))
                elif name.endswith("running_var"):
                    buf.add_(0.1 * torch.rand(buf.shape, generator=gen))
        state.od.net.outc[0].bias += OD_SHIFT
    return state


def test_port_checkpoint_reads_in_jax_and_predicts_alike(tmp_path):
    state = _port_state(0)
    path = str(tmp_path / "checkpoint_3.pth.tar")
    save_ensemble(path, state, epoch=3)
    converted = jax_load_reference(path)
    assert set(converted) == set(NET_KEYS)
    img = np.random.RandomState(1).rand(B, HW, HW, 3).astype(np.float32) * 2 - 1
    mask = jnp.zeros((B, HW, HW, 1))
    jnets = (JaxWTPSE(JCFG), JaxStudent(JCFG), JaxWTPSE(JCFG, two_step=True), JaxStudent(JCFG))
    variables = []
    for key, jm in zip(NET_KEYS, jnets):
        if isinstance(jm, JaxWTPSE):
            template = jax_init(jm, JaxWTPSE.initialize, jnp.asarray(img), mask)
        else:
            template = jax_init(jm, JaxStudent.initialize, jnp.asarray(img))
        v, matched = load_into_variables(template, converted[key], strict=True)
        assert len(matched) == COUNTS[key], key
        variables.append(v)
    want_od, want_oc = jax_make_predict_fn(*jnets)(*variables, jnp.asarray(img))
    got_od, got_oc = make_predict_fn(*_nets(state), device="cpu")(nchw(img))
    assert_close(nhwc(got_od), want_od, what="od logits")
    assert_close(nhwc(got_oc), want_oc, what="oc logits")
    assert float(np.mean(np.asarray(want_od) > np.log(3.0))) > 0.05  # a non-empty ROI
    assert torch.load(path, map_location="cpu", weights_only=True)["epoch"] == 3


def test_reference_layout_file_loads_into_the_port(tmp_path):
    torch.manual_seed(3)
    ref = {"model": torch_ref.WTPSE(16).state_dict(),
           "model_shape": torch_ref.Student(16).state_dict(),
           "model_oc": torch_ref.WTPSE(16).state_dict(),
           "model_oc_shape": torch_ref.Student(16).state_dict()}
    path = str(tmp_path / "ref.pth.tar")
    torch.save(ref, path)
    state = init_ensemble(CFG, device="cpu")
    assert load_reference_checkpoint(path, state, strict=True) == COUNTS
    for key, net in zip(NET_KEYS, _nets(state)):
        own = net.state_dict()
        for name, value in ref[key].items():
            assert torch.equal(own[name], value), (key, name)
    # a leaf of another shape finds no slot: skipped, or an error under strict
    ref["model"]["outc.0.weight"] = torch.zeros(2, 8, 1, 1)
    torch.save(ref, path)
    fresh = init_ensemble(CFG, device="cpu")
    assert load_reference_checkpoint(path, fresh)["model"] == 335
    with pytest.raises(ValueError, match="mismatch"):
        load_reference_checkpoint(path, fresh, strict=True)
