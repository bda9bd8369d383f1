"""The graph's step body (``wt_pse_tpu_torch/train/graph.py::GraphedStep.body``)
against the JAX package's ``make_train_step`` on the CPU, at 32x32 with batch
3 = 3 domains x 1 (the rest of the graph driver's CPU tests are in
``test_torch_graph_driver.py``).

The body, fed one batch and injected draws through its static buffers,
equals JAX's step at the bounds of ``tests/test_torch_step.py`` (losses rtol
1e-5, ``pos_weight`` rtol 1e-4, the nets after their update within 2.2 lr),
on weights carried by ``state_dict_from_jax``, for WT_PSE and the joint
variant. Whitening is off and the shape prior on, so each seg phase draws
one N(0, 1) map (phases 1 and 3) and no shape phase runs: the step is held
whole, and no metric is read through a teacher after its update. JAX's two
draws are replaced by the same maps while its step is traced.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.joint import JointShapeReg as JaxJoint
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu.train.step import StepConfig as JaxStepConfig
from wt_pse_tpu.train.step import make_train_step as jax_make_train_step
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.graph import GraphedStep
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step

from test_torch_step import (B, DOMAINS, HW, PDB, assert_net_close, load_port_state,
                             make_batch, shift_od, to_port_batch)
from torch_port import nchw, torch_single_thread  # noqa: F401


def _jax_nets(algorithm, cfg):
    main = JaxJoint if algorithm == JOINT else JaxWTPSE
    return main(cfg), JaxStudent(cfg), main(cfg, two_step=True), JaxStudent(cfg)


@pytest.mark.parametrize("algorithm", ["WT_PSE", JOINT])
def test_body_on_fed_buffers_matches_jax_step(algorithm, monkeypatch):
    hp = dict(jax_default_hparams(algorithm), whitening=False, shape_prior=True)
    jcfg = JaxModelConfig.from_hparams(hp)
    jnets = _jax_nets(algorithm, jcfg)
    jstate, txs = jax_init_ensemble(*jnets, (B, HW, HW, 3), jax.random.PRNGKey(0))
    od = shift_od({"params": jstate.od.params, "batch_stats": jstate.od.batch_stats})
    jstate = jstate.replace(od=jstate.od.replace(params=jax.tree.map(jnp.asarray,
                                                                     od["params"])))
    php = dict(default_hparams(algorithm), whitening=False, shape_prior=True)
    pstate = init_ensemble(ModelConfig.from_hparams(php), device="cpu", algorithm=algorithm)
    load_port_state(pstate, jstate)

    batch = make_batch(seed=6)
    r = np.random.RandomState(7)
    draws = {k: r.randn(B, HW, HW, 1).astype(np.float32) for k in ("phase1", "phase3")}

    # JAX's step, its two N(0, 1) draws (one a seg phase) replaced by ours
    order, seen = ["phase1", "phase3"], []

    def normal(key, shape=(), dtype=jnp.float32):
        k = order[len(seen)]
        seen.append(tuple(shape))
        return jnp.asarray(draws[k], dtype).reshape(shape)

    monkeypatch.setattr(jax.random, "normal", normal)
    cfg_kw = dict(distill=algorithm != JOINT)
    step = jax.jit(jax_make_train_step(*jnets, txs, JaxStepConfig(hp, DOMAINS, PDB, **cfg_kw)))
    jnew, jm = step(jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    assert seen == [(B, HW, HW, 1)] * 2

    pbatch = to_port_batch(batch)
    gs = GraphedStep(pstate, make_train_step(StepConfig(php, DOMAINS, PDB, **cfg_kw),
                                             device="cpu"),
                     pbatch, capacity=1, eps_keys=order)
    for k, v in pbatch.items():
        gs.batch[k].copy_(v)
    for k, v in draws.items():
        gs.eps[k].copy_(nchw(v))
    gs.body()
    pm = {k: v[0] for k, v in gs.read(1).items()}

    assert set(pm) == set(jm)
    assert 0.0 < float(pm["train_dice"]) and float(jm["pos_weight_oc"]) != 1.0
    for k in ("loss_seg", "loss_seg_oc"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(pm["pos_weight_oc"]), float(jm["pos_weight_oc"]),
                               rtol=1e-4)
    assert pstate.step == 1
    assert_net_close(pstate.od.net, jnew.od)
    assert_net_close(pstate.oc.net, jnew.oc)
