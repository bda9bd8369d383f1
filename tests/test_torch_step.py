"""The port's 4-phase step (``wt_pse_tpu_torch/train/step.py``) against the JAX
``make_train_step`` in the deterministic configuration (``shape_prior=False``,
``whitening=False``: no random draw), the ``loss/bce_*`` goldens, and the count
of covariance launches per step.

32x32 inputs, batch 3 laid out as 3 domains x 1, base width 16. Tolerances are
those of ``tests/test_step_torch_parity.py``: losses rtol 1e-5, ``pos_weight``
rtol 1e-4; parameters within 2.2*lr elementwise (Adam's first step is about
lr*sign(grad), which flips where a gradient is at f32 noise) and 6e-5 in the
mean; BN running stats within 2e-3 elementwise and 2e-4 in the mean.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu.train.step import StepConfig as JaxStepConfig
from wt_pse_tpu.train.step import make_train_step as jax_make_train_step
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import (StepConfig, bce_logits_pos_weight, bce_probs,
                                         make_train_step)

from torch_port import nchw, torch_single_thread  # noqa: F401
from wt_pse_tpu_torch.io.convert import state_dict_from_jax

B, HW, DOMAINS, PDB = 3, 32, 3, 1
LR = 5e-4
OD_SHIFT = 1.1  # lifts the initial OD logits so the phase-3 ROI is not empty
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.json")


def make_batch(seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    od = ((yy - 16) ** 2 + (xx - 16) ** 2 < 100).astype(np.float32)
    oc = ((yy - 16) ** 2 + (xx - 16) ** 2 < 36).astype(np.float32)
    return {"image": r.rand(B, HW, HW, 3).astype(np.float32) * 2 - 1,
            "target_od": np.tile(od[None, :, :, None], (B, 1, 1, 1)),
            "target_oc": np.tile(oc[None, :, :, None], (B, 1, 1, 1))}


def to_port_batch(batch):
    return {k: nchw(v) for k, v in batch.items()}


def shift_od(variables):
    """JAX variables of the OD net with ``outc`` lifted by OD_SHIFT."""
    params = jax.tree.map(np.asarray, variables["params"])
    params["outc"]["c0"]["bias"] = params["outc"]["c0"]["bias"] + OD_SHIFT
    return {"params": params, "batch_stats": variables["batch_stats"]}


def load_port_state(port_state, jax_state):
    """Carry all four nets of a JAX train state into the port's state."""
    for name in ("od", "od_shape", "oc", "oc_shape"):
        js = getattr(jax_state, name)
        getattr(port_state, name).net.load_state_dict(
            state_dict_from_jax({"params": js.params, "batch_stats": js.batch_stats}),
            strict=True)


def assert_net_close(port, jax_net, lr=LR):
    """A port net (or its state_dict) against a JAX NetState after an update."""
    want = state_dict_from_jax({"params": jax_net.params,
                                "batch_stats": jax_net.batch_stats})
    have = port.state_dict() if isinstance(port, torch.nn.Module) else port
    pdiff, sdiff = [], []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(have[k].detach().cpu().numpy() - w.numpy()).ravel()
        (sdiff if k.endswith(("running_mean", "running_var")) else pdiff).append(d)
    pdiff, sdiff = np.concatenate(pdiff), np.concatenate(sdiff)
    assert pdiff.max() <= 2.2 * lr, ("params", pdiff.max())
    assert pdiff.mean() <= 6e-5, ("params", pdiff.mean())
    assert sdiff.max() <= 2e-3, ("bn stats", sdiff.max())
    assert sdiff.mean() <= 2e-4, ("bn stats", sdiff.mean())


def test_deterministic_step_matches_jax():
    hp = dict(jax_default_hparams("WT_PSE"))
    hp.update(shape_prior=False, whitening=False)
    jcfg = JaxModelConfig.from_hparams(hp)
    jnets = (JaxWTPSE(jcfg), JaxStudent(jcfg), JaxWTPSE(jcfg, two_step=True),
             JaxStudent(jcfg))
    jstate, txs = jax_init_ensemble(*jnets, (B, HW, HW, 3), jax.random.PRNGKey(0))
    od = shift_od({"params": jstate.od.params, "batch_stats": jstate.od.batch_stats})
    jstate = jstate.replace(od=jstate.od.replace(params=jax.tree.map(jnp.asarray,
                                                                     od["params"])))

    php = dict(default_hparams("WT_PSE"))
    php.update(shape_prior=False, whitening=False)
    pstate = init_ensemble(ModelConfig.from_hparams(php), device="cpu")
    load_port_state(pstate, jstate)

    batch = make_batch()
    step = jax.jit(jax_make_train_step(*jnets, txs, JaxStepConfig(hp, DOMAINS, PDB)))
    jnew, jm = step(jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    pm = make_train_step(StepConfig(php, DOMAINS, PDB), device="cpu")(
        pstate, to_port_batch(batch))

    assert set(pm) == set(jm)
    assert 0.0 < float(pm["train_dice"]) and float(jm["pos_weight_oc"]) != 1.0
    for k in ("loss_seg", "loss_seg_oc", "loss_ins_wt", "loss_dom_wt"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(pm["pos_weight_oc"]), float(jm["pos_weight_oc"]),
                               rtol=1e-4)
    assert pstate.step == 1
    assert_net_close(pstate.od.net, jnew.od)
    assert_net_close(pstate.oc.net, jnew.oc)


@pytest.mark.parametrize("name", ["loss/bce_probs", "loss/bce_pos_weight"])
def test_bce_goldens(name):
    with open(GOLDENS) as f:
        frozen = json.load(f)
    rec = frozen["values"][name]
    rtol, atol = frozen["meta"]["tolerances"][rec["tol"]]
    lr = np.random.RandomState(7)  # the draws of tests/test_goldens.py:111-112
    logits = nchw(lr.randn(2, 16, 16, 1).astype(np.float32) * 3)
    tgt = nchw((lr.rand(2, 16, 16, 1) > 0.6).astype(np.float32))
    if name == "loss/bce_probs":
        value = bce_probs(logits, tgt)
    else:
        value = bce_logits_pos_weight(logits, tgt, torch.tensor(2.5))
    assert np.isclose(float(value), rec["value"], rtol=rtol, atol=atol), (
        f"{name}: {float(value)!r} vs {rec['value']!r} (class {rec['tol']})")


def test_pos_weight_falls_back_to_one_when_roi_is_empty():
    hp = dict(default_hparams("WT_PSE"))
    hp.update(shape_prior=False, whitening=False)
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu")
    batch = to_port_batch(make_batch())
    batch["target_oc"] = torch.zeros_like(batch["target_oc"])  # num > 0 or 0 / 0
    m = make_train_step(StepConfig(hp, DOMAINS, PDB), device="cpu")(state, batch)
    assert float(m["pos_weight_oc"]) == 1.0


def _counting(monkeypatch):
    counts = {"forward": 0, "backward": 0}
    fwd, bwd = cc.covariance_forward_plain, cc.covariance_backward_plain

    def forward(z):
        counts["forward"] += 1
        return fwd(z)

    def backward(z, g):
        counts["backward"] += 1
        return bwd(z, g)

    monkeypatch.setattr(cc, "covariance_forward_plain", forward)
    monkeypatch.setattr(cc, "covariance_backward_plain", backward)
    return counts


def test_step_runs_the_covariance_eight_times_each_way(monkeypatch):
    """Four phases x DeepWT maps 0 and 1: 8 forwards and 8 backwards a step."""
    counts = _counting(monkeypatch)
    hp = default_hparams("WT_PSE")
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu")
    step = make_train_step(StepConfig(hp, DOMAINS, PDB), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for n in (1, 2):
        metrics = step(state, to_port_batch(make_batch()), generator=gen)
        assert counts == {"forward": 8 * n, "backward": 8 * n}
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(isinstance(v, torch.Tensor) for v in metrics.values())
