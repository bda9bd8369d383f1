"""The four phases of the port's step with shape prior and whitening on, each
against a test-side JAX composition of that phase with the same injected ``eps``.

The composition calls the JAX modules' ``eps=`` paths, ``main_whitening_loss`` /
``student_whitening_loss``, ``bce_*`` and ``reference_adam`` (through
``NetState.apply_updates``) in the order ``wt_pse_tpu/train/step.py`` uses them;
the JAX step itself draws its noise from PRNG keys and cannot take injected draws.

Every phase starts both sides from the same weights: the JAX nets after the
previous phase, carried into the port. Chaining the phases instead compares
chaos: Adam's first step is about lr*sign(grad), a gradient at f32 noise flips
its sign between frameworks, and the train-mode teacher of phase 2 turns those
2*lr weight gaps into visibly different outputs. One more test holds the whole
``train_step`` to the chain of the port's own phases, bit for bit.

Losses compare at tolerance class ``conv`` (rtol 5e-4, atol 1e-5); the nets
after their updates at the parameter and BN-stat bounds of ``test_torch_step.py``.
This file holds the OD phases (1 and 2) and the ROI;
``test_torch_step_oc_phases.py`` the OC phases (3 and 4) and the whole step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.ops.whitening import main_whitening_loss, student_whitening_loss
from wt_pse_tpu.io.torch_import import convert_state_dict
from wt_pse_tpu.train.state import NetState, reference_adam
from wt_pse_tpu.train.step import bce_probs
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import (EPS_KEYS, StepConfig, _oc_roi,
                                         _seg_phase as port_seg_phase,
                                         _shape_phase as port_shape_phase,
                                         bce_probs as port_bce_probs)

from test_torch_step import (B, DOMAINS, HW, LR, OD_SHIFT, PDB, assert_net_close,
                             make_batch, to_port_batch)
from torch_port import CONV, nchw, torch_single_thread  # noqa: F401
from wt_pse_tpu_torch.io.convert import state_dict_from_jax


def _seg_phase(model, tx, net, image, target, loss_fn, eps):
    def loss(params):
        (out, _att, feats), mut = model.apply(
            {"params": params, "batch_stats": net.batch_stats}, image, target, image,
            True, eps, mutable=["batch_stats"])
        seg = loss_fn(out)
        inst, dom = main_whitening_loss(feats, DOMAINS, PDB, 0.0, True)
        return seg + inst + dom, (out, mut["batch_stats"], seg, inst, dom)

    grads, (out, bs, seg, inst, dom) = jax.grad(loss, has_aux=True)(net.params)
    return net.apply_updates(grads, tx, bs), out, {
        "loss_seg": seg, "loss_ins_wt": inst, "loss_dom_wt": dom}


def _shape_phase(main, student, tx, main_net, stud_net, image, mask, eps_t, eps_s):
    (_z, mu_t), mut = main.apply(
        {"params": main_net.params, "batch_stats": main_net.batch_stats}, image, mask,
        True, eps_t, mutable=["batch_stats"], method=JaxWTPSE.teacher_sample)
    main_net = main_net.replace(batch_stats=mut["batch_stats"])

    def loss(params):
        (_zs, mu_s, feats), smut = student.apply(
            {"params": params, "batch_stats": stud_net.batch_stats}, image, True, eps_s,
            mutable=["batch_stats"], method=JaxStudent.update_forward)
        kd = jnp.mean(jnp.square(mu_t - mu_s))
        tot, ij, ii, dom = student_whitening_loss(feats, DOMAINS, PDB, 0.0, True)
        return kd + tot + dom, (smut["batch_stats"], kd, tot, ij, ii, dom)

    grads, (bs, kd, tot, ij, ii, dom) = jax.grad(loss, has_aux=True)(stud_net.params)
    return main_net, stud_net.apply_updates(grads, tx, bs), {
        "loss_kd": kd, "loss_ins_wt_shape": tot, "loss_ins_wt_shape_ij": ij,
        "loss_ins_wt_shape_ii": ii, "loss_dom_wt_shape": dom}


def carry(port_ns, jax_ns):
    """Load a JAX NetState's weights into a port NetState."""
    port_ns.net.load_state_dict(state_dict_from_jax(
        {"params": jax_ns.params, "batch_stats": jax_ns.batch_stats}), strict=True)


def snapshot(port_ns):
    return copy.deepcopy(port_ns.net.state_dict())


def setup():
    """Both packages' nets with the same weights — drawn by the port (seed 1),
    carried into Flax variables by the JAX package's own importer — the same
    batch and the same draws. The OD head is lifted by OD_SHIFT so the ROI
    holds part of the image."""
    php = default_hparams("WT_PSE")
    pstate = init_ensemble(ModelConfig.from_hparams(php), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        pstate.od.net.outc[0].bias += OD_SHIFT
    jcfg = JaxModelConfig.from_hparams(jax_default_hparams("WT_PSE"))
    jnets = {"od": JaxWTPSE(jcfg), "od_shape": JaxStudent(jcfg),
             "oc": JaxWTPSE(jcfg, two_step=True), "oc_shape": JaxStudent(jcfg)}
    tx = reference_adam(LR)
    jstate = {name: NetState.create(jax.tree.map(jnp.asarray, convert_state_dict(
        getattr(pstate, name).net.state_dict())), tx) for name in jnets}
    batch = make_batch(seed=1)
    r = np.random.RandomState(2)
    eps = {k: r.randn(B, HW, HW, 1).astype(np.float32) for k in EPS_KEYS}
    return {"cfg": StepConfig(php, DOMAINS, PDB), "pstate": pstate, "jnets": jnets,
            "tx": tx, "jstate": jstate,
            "jb": jax.tree.map(jnp.asarray, batch), "je": jax.tree.map(jnp.asarray, eps),
            "pb": to_port_batch(batch), "pe": {k: nchw(v) for k, v in eps.items()}}


def jax_phase1(s):
    jb = s["jb"]
    return jax.jit(lambda net, e: _seg_phase(
        s["jnets"]["od"], s["tx"], net, jb["image"], jb["target_od"],
        lambda o: bce_probs(o, jb["target_od"]), e))(s["jstate"]["od"], s["je"]["phase1"])


def compare(pm, jm, nets, phase):
    rtol, atol = CONV
    assert set(jm) <= set(pm)
    for k in sorted(jm):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rtol, atol=atol,
                                   err_msg=f"{phase} {k} (class conv)")
    for have, jax_net in nets:
        assert_net_close(have, jax_net)


@pytest.fixture(scope="module")
def od_phases():
    s = setup()
    ps, pb, pe, jb, je, cfg = s["pstate"], s["pb"], s["pe"], s["jb"], s["je"], s["cfg"]
    out = {}

    # phase 1: OD segmentation
    jod, out_od, m1 = jax_phase1(s)
    _, pm1 = port_seg_phase(ps.od, pb["image"], pb["target_od"], pb["image"],
                            lambda o: port_bce_probs(o, pb["target_od"]), cfg,
                            pe["phase1"], None)
    out["phase1"] = (pm1, m1, [(snapshot(ps.od), jod)])

    # phase 2: OD shape distillation, the teacher on the post-update weights
    carry(ps.od, jod)
    jod, jod_shape, m2 = jax.jit(lambda a, b, et, es: _shape_phase(
        s["jnets"]["od"], s["jnets"]["od_shape"], s["tx"], a, b, jb["image"],
        jb["target_od"], et, es))(jod, s["jstate"]["od_shape"], je["phase2.teacher"],
                                  je["phase2.student"])
    pm2 = port_shape_phase(ps.od, ps.od_shape, pb["image"], pb["target_od"], cfg,
                           pe["phase2.teacher"], pe["phase2.student"], None)
    out["phase2"] = (pm2, m2, [(snapshot(ps.od), jod), (snapshot(ps.od_shape), jod_shape)])

    # the ROI of phase 3, from the pre-update phase-1 logits, as step.py builds it
    j_pred = (jax.nn.sigmoid(out_od) > 0.75).astype(jnp.float32)
    j_roi = (jb["image"] + 1.0) * j_pred - 1.0
    j_pos_w = jnp.sum(j_pred) / jnp.sum(j_pred * jb["target_oc"])
    j_pos_w = jnp.where(jnp.isfinite(j_pos_w), j_pos_w, 1.0)
    out["roi"] = (_oc_roi(nchw(out_od), pb["image"], pb["target_oc"]),
                  (j_pred, j_roi, j_pos_w))
    return out


@pytest.mark.parametrize("phase", ["phase1", "phase2"])
def test_od_phase_matches_jax_composition(od_phases, phase):
    compare(*od_phases[phase], phase)


def test_roi_and_pos_weight_match_jax(od_phases):
    (od_pred, roi, pos_w), (j_pred, j_roi, j_pos_w) = od_phases["roi"]
    assert torch.equal(od_pred, nchw(j_pred)) and torch.equal(roi, nchw(j_roi))
    np.testing.assert_allclose(float(pos_w), float(j_pos_w), rtol=1e-6)
    assert float(pos_w) != 1.0 and 0.0 < float(od_pred.mean()) < 1.0  # not trivial
