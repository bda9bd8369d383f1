"""The port's networks (``wt_pse_tpu_torch/models``) against the JAX modules, with
JAX-initialised weights carried by ``io/convert.py::state_dict_from_jax``.

32x32 inputs, batch 3 (3 domains x 1), base width 16; inputs and the injected
``eps`` are numpy draws from a seed. Outputs and BN running stats compare at
tolerance class ``conv`` (rtol 5e-4, atol 1e-5, ``tests/test_goldens.py:49``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.deepwt import DeepWT as JaxDeepWT
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.shape_prior import TeacherShapePrior as JaxTeacher
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.deepwt import DeepWT
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent, TeacherShapePrior
from wt_pse_tpu_torch.models.wt_pse import WTPSE

from torch_port import (assert_close, assert_stats_close, carry, jax_init, nchw,  # noqa: F401
                        nhwc, torch_single_thread)

B, HW = 3, 32
JCFG = JaxModelConfig.from_hparams(jax_default_hparams("WT_PSE"))
CFG = ModelConfig.from_hparams(default_hparams("WT_PSE"))


@pytest.fixture
def data():
    r = np.random.RandomState(0)
    return {"image": r.rand(B, HW, HW, 3).astype(np.float32) * 2 - 1,
            "mask": (r.rand(B, HW, HW, 1) > 0.5).astype(np.float32),
            "feats": r.randn(B, HW, HW, 16).astype(np.float32),
            "eps": r.randn(B, HW, HW, 1).astype(np.float32)}


def test_deepwt(data):
    jm = JaxDeepWT(16)
    v = jax_init(jm, None, jnp.asarray(data["image"]))
    pm = carry(DeepWT(3, 16), v)
    want = jm.apply(v, jnp.asarray(data["image"]))
    got = pm(nchw(data["image"]))
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), w, what=f"DeepWT map {i}")


@pytest.mark.parametrize("train", [True, False])
def test_teacher(data, train):
    jm = JaxTeacher(JCFG)
    img, mask, feats, eps = (jnp.asarray(data[k]) for k in ("image", "mask", "feats", "eps"))
    v = jax_init(jm, JaxTeacher.initialize, feats, mask)
    pm = carry(TeacherShapePrior(CFG, device="cpu"), v).train(train)
    (jz, jmu), mut = jm.apply(v, feats, mask, train, True, eps, mutable=["batch_stats"])
    with torch.no_grad():
        z, mu = pm(nchw(data["feats"]), nchw(data["mask"]), eps=nchw(data["eps"]))
    assert_close(nhwc(mu), jmu, what="teacher mu")
    assert_close(nhwc(z), jz, what="teacher z")
    assert_stats_close(pm, v["params"], mut["batch_stats"])


@pytest.mark.parametrize("train", [True, False])
def test_student(data, train):
    jm = JaxStudent(JCFG)
    img, eps = jnp.asarray(data["image"]), jnp.asarray(data["eps"])
    v = jax_init(jm, JaxStudent.initialize, img)
    pm = carry(ShapeStudent(CFG, device="cpu"), v).train(train)
    (jz, jmu, jfeats), mut = jm.apply(v, img, train, eps, mutable=["batch_stats"],
                                      method=JaxStudent.update_forward)
    with torch.no_grad():
        z, mu, feats = pm.update_forward(nchw(data["image"]), eps=nchw(data["eps"]))
    assert_close(nhwc(mu), jmu, what="student mu")
    assert_close(nhwc(z), jz, what="student z")
    assert_close(nhwc(feats[1]), jfeats[1], what="student DeepWT map 1")
    assert_stats_close(pm, v["params"], mut["batch_stats"])
    if not train:
        with torch.no_grad():
            mu_eval = pm.sample_from_image(nchw(data["image"]))
        assert_close(nhwc(mu_eval), jm.apply(v, img, method=JaxStudent.sample_from_image),
                     what="student sample_from_image")


@pytest.mark.parametrize("train", [True, False])
def test_wtpse_forward(data, train):
    jm = JaxWTPSE(JCFG)
    img, mask, eps = (jnp.asarray(data[k]) for k in ("image", "mask", "eps"))
    v = jax_init(jm, JaxWTPSE.initialize, img, mask)
    pm = carry(WTPSE(CFG, device="cpu"), v).train(train)
    (jout, jatt, jfeats), mut = jm.apply(v, img, mask, img, train, eps,
                                         mutable=["batch_stats"])
    with torch.no_grad():
        out, att, feats = pm(nchw(data["image"]), nchw(data["mask"]), nchw(data["image"]),
                             eps=nchw(data["eps"]))
    assert_close(nhwc(out), jout, what="WTPSE logits")
    assert_close(nhwc(feats[0]), jfeats[0], what="WTPSE DeepWT map 0")
    assert float(torch.mean(torch.abs(nchw(np.asarray(jatt)) - att))) < 1e-2  # threshold flips
    assert_stats_close(pm, v["params"], mut["batch_stats"])


@pytest.mark.parametrize("shape_prior", [True, False])
def test_state_dict_from_jax_loads_strictly(shape_prior):
    hp = jax_default_hparams("WT_PSE")
    hp.update(shape_prior=shape_prior, whitening=shape_prior)
    jcfg, cfg = JaxModelConfig.from_hparams(hp), ModelConfig.from_hparams(hp)
    img = jnp.zeros((1, HW, HW, 3))
    mask = jnp.zeros((1, HW, HW, 1))
    nets = [(JaxWTPSE(jcfg), JaxWTPSE.initialize, (img, mask), WTPSE(cfg, device="cpu")),
            (JaxStudent(jcfg), JaxStudent.initialize, (img,), ShapeStudent(cfg, device="cpu"))]
    for jm, method, args, pm in nets:
        v = jax_init(jm, method, *args)
        carry(pm, v)  # raises on a missing or unexpected key
        n_jax = sum(np.size(a) for a in _leaves(v))
        n_port = sum(t.numel() for k, t in pm.state_dict().items()
                     if not k.endswith("num_batches_tracked"))
        assert n_port == n_jax


def _leaves(tree):
    for value in tree.values():
        if hasattr(value, "values"):
            yield from _leaves(value)
        else:
            yield value
