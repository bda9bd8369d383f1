"""The port's two-stage predict (``wt_pse_tpu_torch/train/eval.py::make_predict_fn``)
against the JAX ``make_predict_fn`` (``wt_pse_tpu/train/eval.py:37-86``): coarse
OD, ROI, fine OC, with JAX-initialised weights carried across and perturbed BN
running stats, at tolerance class ``conv`` (rtol 5e-4, atol 1e-5).
32x32 inputs, batch 3, base width 16.
"""

import numpy as np
import torch

import jax.numpy as jnp

from wt_pse_tpu.train.eval import make_predict_fn as jax_make_predict_fn
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.train.eval import make_predict_fn

from test_torch_networks import (B, CFG, HW, JCFG, JaxStudent, JaxWTPSE, data)  # noqa: F401
from torch_port import (assert_close, carry, jax_init, nchw, nhwc,  # noqa: F401
                        torch_single_thread)

OD_SHIFT = 1.1  # lifts the OD logits so part of the image lands in the ROI


def test_two_stage_predict(data):
    img = jnp.asarray(data["image"])
    mask = jnp.zeros((B, HW, HW, 1))
    jnets = (JaxWTPSE(JCFG), JaxStudent(JCFG), JaxWTPSE(JCFG, two_step=True), JaxStudent(JCFG))
    vs, pnets = [], []
    for i, jm in enumerate(jnets):
        if isinstance(jm, JaxWTPSE):
            v = jax_init(jm, JaxWTPSE.initialize, img, mask, seed=i)
            pm = WTPSE(CFG, device="cpu")
        else:
            v = jax_init(jm, JaxStudent.initialize, img, seed=i)
            pm = ShapeStudent(CFG, device="cpu")
        # non-trivial running stats so the eval path is exercised
        v = {"params": v["params"], "batch_stats": _perturb(v["batch_stats"], i)}
        if i == 0:
            outc = v["params"]["outc"]["c0"]
            v["params"]["outc"]["c0"] = {**outc, "bias": np.asarray(outc["bias"]) + OD_SHIFT}
        vs.append(v)
        pnets.append(carry(pm, v))
    want_od, want_oc = jax_make_predict_fn(*jnets)(*vs, img)
    got_od, got_oc = make_predict_fn(*pnets, device="cpu")(nchw(data["image"]))
    assert_close(nhwc(got_od), want_od, what="predict od logits")
    assert_close(nhwc(got_oc), want_oc, what="predict oc logits")
    in_roi = float(np.mean(np.asarray(want_od) > np.log(3.0)))  # sigmoid > 0.75
    assert 0.1 < in_roi < 0.9, in_roi
    assert float(torch.sum(got_oc != 0)) > 0


def _perturb(stats, seed):
    """Running stats away from their 0/1 initial values."""
    r = np.random.RandomState(100 + seed)

    def go(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = go(v)
            elif k == "var":
                out[k] = (np.asarray(v) + 0.1 * r.rand(*np.shape(v))).astype(np.float32)
            else:
                out[k] = (np.asarray(v) + 0.05 * r.randn(*np.shape(v))).astype(np.float32)
        return out

    return go(stats)
