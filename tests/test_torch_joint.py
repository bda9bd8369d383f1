"""The port's joint variant (``wt_pse_tpu_torch/models/joint.py``,
``make_predict_fn_joint``) against the JAX package's ``JointShapeReg``, on the
CPU, with whitening off (its hparams) and on.

Weights are drawn by the port (a seed), carried into Flax variables by the JAX
package's importer, checked to have exactly the tree that a JAX init of
``JointShapeReg`` makes (``jax.eval_shape``: names and shapes), and carried
back into fresh port nets by ``state_dict_from_jax`` with a strict load.
Inputs and the injected ``eps`` are numpy draws from a seed. Logits, DeepWT
maps, BN running stats and the two-stage predict compare at tolerance class
``conv`` (rtol 5e-4, atol 1e-5). The joint step, Trainer, eval CLI and
``load_predictor`` are in ``tests/test_torch_joint_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.io.torch_import import convert_state_dict
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.joint import JointShapeReg as JaxJoint
from wt_pse_tpu.train.eval import make_predict_fn_joint as jax_make_predict_fn_joint
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.joint import JointShapeReg
from wt_pse_tpu_torch.train.eval import make_predict_fn_for, make_predict_fn_joint

from torch_port import assert_close, assert_stats_close, carry, nchw, nhwc
from torch_port import torch_single_thread  # noqa: F401

B, HW = 3, 32
OD_SHIFT = 1.1  # lifts the OD logits so part of the image lands in the ROI


def configs(whitening: bool, dtype=None):
    hp = dict(jax_default_hparams(JOINT), whitening=whitening, compute_dtype=dtype)
    php = dict(default_hparams(JOINT), whitening=whitening, compute_dtype=dtype)
    return JaxModelConfig.from_hparams(hp), ModelConfig.from_hparams(php)


def crossed(net: JointShapeReg, jcfg, image, mask) -> dict:
    """``net``'s weights as JAX variables, asserted to have the names and
    shapes of a JAX ``JointShapeReg`` init (traced, not run)."""
    shapes = jax.eval_shape(lambda: JaxJoint(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, image, mask, method=JaxJoint.initialize))
    v = convert_state_dict(net.state_dict())

    def flat(tree):
        return {jax.tree_util.keystr(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert flat(v) == flat(shapes)
    return jax.tree.map(jnp.asarray, v)


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(0)
    return {"image": r.rand(B, HW, HW, 3).astype(np.float32) * 2 - 1,
            "mask": (r.rand(B, HW, HW, 1) > 0.5).astype(np.float32),
            "eps": r.randn(B, HW, HW, 1).astype(np.float32)}


@pytest.mark.parametrize("whitening", [False, True])
def test_joint_forward_and_predict_match_jax(data, whitening):
    jcfg, pcfg = configs(whitening)
    img, mask, eps = (jnp.asarray(data[k]) for k in ("image", "mask", "eps"))
    v = crossed(JointShapeReg(pcfg, device="cpu", generator=torch.Generator().manual_seed(1)),
                jcfg, img, mask)
    pm = carry(JointShapeReg(pcfg, device="cpu"), v)  # state_dict_from_jax, strict
    assert ("prior_dist.inc.double_conv.0.weight" in pm.state_dict()) != whitening
    assert not any(k.startswith("prior_dist.wt_model") for k in pm.state_dict())

    (out, att, feats), mut = JaxJoint(jcfg).apply(v, img, mask, img, True, eps,
                                                  mutable=["batch_stats"])
    got_out, got_att, got_feats = pm(nchw(data["image"]), nchw(data["mask"]),
                                     nchw(data["image"]), eps=nchw(data["eps"]))
    assert_close(nhwc(got_out), out, what="joint logits")
    assert float((nhwc(got_att) != np.asarray(att)).mean()) <= 1e-3  # a threshold at 0.75
    assert len(got_feats) == len(feats) == (3 if whitening else 1)
    for i, (g, w) in enumerate(zip(got_feats, feats)):
        assert_close(nhwc(g), w, what=f"wt map {i}")
    assert_stats_close(pm, v["params"], mut["batch_stats"])

    want = JaxJoint(jcfg).apply(v, img, method=JaxJoint.predict)
    got = carry(JointShapeReg(pcfg, device="cpu"), v).eval().predict(nchw(data["image"]))
    assert_close(nhwc(got), want, what="joint predict")


def test_make_predict_fn_joint_matches_jax(data):
    """The two-stage predict with each net's own prior, the OD logits lifted
    so the OC stage sees part of the image."""
    jcfg, pcfg = configs(False)
    img, mask = jnp.asarray(data["image"]), jnp.asarray(data["mask"])
    nets = []
    for seed in (2, 3):
        net = JointShapeReg(pcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        if seed == 2:
            with torch.no_grad():
                net.outc[0].bias += OD_SHIFT
        nets.append(net)
    v_od, v_oc = (crossed(n, jcfg, img, mask) for n in nets)
    with jax.disable_jit():  # eager: a compile of both stages costs more here
        want = jax_make_predict_fn_joint(JaxJoint(jcfg), JaxJoint(jcfg, two_step=True))(
            v_od, None, v_oc, None, img)
    predict = make_predict_fn_joint(*nets, device="cpu")
    got = predict(nchw(data["image"]))
    assert all(t.dtype == torch.float32 for t in got)
    od_share = float((torch.sigmoid(got[0]) > 0.75).float().mean())
    assert 0.0 < od_share < 1.0  # both stages do work
    for g, w, name in zip(got, want, ("od", "oc")):
        assert_close(nhwc(g), w, what=f"joint two-stage {name}")
    # the dispatch the Trainer, the eval CLI and load_predictor use
    again = make_predict_fn_for(JOINT, [nets[0], None, nets[1], None], device="cpu")(
        nchw(data["image"]))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
