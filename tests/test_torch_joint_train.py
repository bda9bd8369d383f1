"""The joint variant's training step in the port, on the CPU.

- One joint step (``StepConfig(distill=False)``: phases 1 and 3 only) with
  whitening on (and its weights at 1, so the covariance carries gradient)
  against a test-side JAX composition of ``wt_pse_tpu/train/step.py``'s seg
  phase, ROI and pos-weight with the same injected ``eps`` and the same
  starting weights; losses at class ``conv``, the nets after their Adam
  update at the bounds of ``tests/test_torch_step.py``.
- A joint step in bf16 keeps f32 parameters and finite losses.

The joint Trainer, eval CLI and ``load_predictor`` are in
``tests/test_torch_joint_eval.py``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.io.torch_import import convert_state_dict
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.joint import JointShapeReg as JaxJoint
from wt_pse_tpu.ops.whitening import main_whitening_loss
from wt_pse_tpu.train.state import NetState, reference_adam
from wt_pse_tpu.train.step import bce_logits_pos_weight, bce_probs
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step

from test_torch_step import B, HW, LR, OD_SHIFT, assert_net_close, make_batch, to_port_batch
from torch_port import CONV, nchw, torch_single_thread  # noqa: F401


def _jax_seg_phase(model, tx, net, image, target, od_pred, pos_w, first, eps):
    """The seg phase of ``wt_pse_tpu/train/step.py`` with the whitening
    losses at weight 1 and an injected draw: phase 1's BCE where ``first``,
    else phase 3's pos-weighted BCE of the logits masked by ``od_pred``. One
    traced function serves both phases, so it compiles once."""

    def loss(params):
        (out, _att, feats), mut = model.apply(
            {"params": params, "batch_stats": net.batch_stats}, image, target, image,
            True, eps, mutable=["batch_stats"])
        seg = jnp.where(first, bce_probs(out, target),
                        bce_logits_pos_weight(out * od_pred, target, pos_w))
        inst, dom = main_whitening_loss(feats, 3, 1, 0.0, True)
        return seg + inst + dom, (out, mut["batch_stats"], seg, inst, dom)

    grads, (out, bs, seg, inst, dom) = jax.grad(loss, has_aux=True)(net.params)
    return net.apply_updates(grads, tx, bs), out, {
        "loss_seg": seg, "loss_ins_wt": inst, "loss_dom_wt": dom}


def test_joint_step_matches_jax_phase_by_phase():
    hp = dict(default_hparams(JOINT), whitening=True, instance_wt_gm=1, domain_wt_gm=1)
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu",
                          generator=torch.Generator().manual_seed(1), algorithm=JOINT)
    with torch.no_grad():
        state.od.net.outc[0].bias += OD_SHIFT
    jm = JaxJoint(JaxModelConfig.from_hparams(hp))
    tx = reference_adam(LR)
    jstate = {k: NetState.create(jax.tree.map(jnp.asarray, convert_state_dict(
        getattr(state, k).net.state_dict())), tx) for k in ("od", "oc")}
    batch = make_batch(seed=3)
    r = np.random.RandomState(4)
    eps = {k: r.randn(B, HW, HW, 1).astype(np.float32) for k in ("phase1", "phase3")}
    jb, je = jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray, eps)

    metrics = make_train_step(StepConfig(hp, 3, 1, distill=False), device="cpu")(
        state, to_port_batch(batch), eps={k: nchw(v) for k, v in eps.items()})
    assert set(metrics) == {f"{k}{s}" for k in ("loss_seg", "loss_ins_wt", "loss_dom_wt",
                                                "train_dice") for s in ("", "_oc")} | {
        "pos_weight_oc"}  # no shape phases

    phase = jax.jit(lambda *a: _jax_seg_phase(jm, tx, *a))
    # phase 1 from the same weights
    jod, out_od, m1 = phase(jstate["od"], jb["image"], jb["target_od"],
                            jnp.ones_like(jb["target_od"]), jnp.float32(1.0), True, je["phase1"])
    # the ROI from the pre-update phase-1 logits, and phase 3 from the same weights
    pred = (jax.nn.sigmoid(out_od) > 0.75).astype(jnp.float32)
    roi = (jb["image"] + 1.0) * pred - 1.0
    pos_w = jnp.sum(pred) / jnp.sum(pred * jb["target_oc"])
    pos_w = jnp.where(jnp.isfinite(pos_w), pos_w, 1.0)
    assert 0.0 < float(pred.mean()) < 1.0 and float(pos_w) != 1.0  # not trivial
    joc, _, m3 = phase(jstate["oc"], roi, jb["target_oc"], pred, pos_w, False, je["phase3"])

    want = dict(m1, pos_weight_oc=pos_w, **{k + "_oc": v for k, v in m3.items()})
    rtol, atol = CONV
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, atol=atol,
                                   err_msg=f"{k} (class conv)")
    assert float(metrics["loss_ins_wt"]) > 0  # the whitening losses are on
    assert_net_close(state.od.net, jod)
    assert_net_close(state.oc.net, joc)


def test_joint_bf16_step_keeps_f32_state():
    hp = dict(default_hparams(JOINT), whitening=True, compute_dtype="bfloat16")
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu", algorithm=JOINT)
    batch = {k: v[:, :, :16, :16] for k, v in to_port_batch(make_batch(seed=5)).items()}
    gen = torch.Generator().manual_seed(0)
    step = make_train_step(StepConfig(hp, 3, 1, distill=False), device="cpu")
    for _ in range(2):
        metrics = step(state, batch, generator=gen)
        assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in metrics.values())
    assert all(p.dtype == torch.float32 for ns in state.net_states()
               for p in ns.net.parameters())
    out, _, feats = state.od.net(batch["image"], batch["target_od"], batch["image"],
                                 generator=gen)
    assert out.dtype == torch.bfloat16 and feats[0].dtype == torch.bfloat16
