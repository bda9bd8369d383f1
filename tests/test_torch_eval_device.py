"""The port's validation on the device (``wt_pse_tpu_torch/train/eval_device.py``)
against the JAX package's ``train/eval_device.py`` and the host metrics, on
the CPU.

- ``device_metrics`` on shared logits: Dice exactly JAX's (integer counts,
  the same f32 division), ASD and HD95 at ``f32_reduce`` (the sum order and
  the square roots differ), and each within 1e-4 of the host scipy metrics;
- the empty-prediction and empty-ground-truth 100.0 sentinels, and HD95 as
  the percentile of the pooled distances;
- ``Trainer(fast_validation=True, device="cpu").validate()`` against JAX's
  ``evaluate_domain_device`` with the Trainer's weights carried over by a
  checkpoint: Dice within 1e-6, HD / ASD at ``f32_reduce`` relative (the
  logits agree at class ``conv``, the masks pixel for pixel).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wt_pse_tpu.io.torch_import import load_into_variables
from wt_pse_tpu.io.torch_import import load_reference_checkpoint as jax_load_reference
from wt_pse_tpu.train.eval import make_predict_fn as jax_make_predict_fn
from wt_pse_tpu.train.eval_device import device_metrics as jax_device_metrics
from wt_pse_tpu.train.eval_device import evaluate_domain_device as jax_evaluate_domain_device
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.io.checkpoint import NET_KEYS, save_ensemble
from wt_pse_tpu_torch.ops import metrics as M
from wt_pse_tpu_torch.ops.postprocess import largest_component_fill_holes_scipy
from wt_pse_tpu_torch.train.eval_device import device_metrics
from wt_pse_tpu_torch.train.trainer import Trainer

from test_torch_networks import JCFG, JaxStudent, JaxWTPSE
from torch_port import F32_REDUCE, jax_init, torch_single_thread  # noqa: F401

DICE = ("disc_dice", "cup_dice")
SURFACE = ("disc_asd", "cup_asd", "disc_hd", "cup_hd")


def _blob(hw, cy, cx, r):
    yy, xx = np.mgrid[0:hw, 0:hw]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _both(od_logits, oc_logits, od_gt, oc_gt):
    got = {k: v.numpy() for k, v in device_metrics(
        *(torch.from_numpy(a) for a in (od_logits, oc_logits, od_gt, oc_gt))).items()}
    want = {k: np.asarray(v) for k, v in jax_device_metrics(
        *(jnp.asarray(a) for a in (od_logits, oc_logits, od_gt, oc_gt))).items()}
    assert set(got) == set(want)
    for k in DICE:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in SURFACE:
        np.testing.assert_allclose(got[k], want[k], rtol=F32_REDUCE[0], atol=0, err_msg=k)
    return got


def test_device_metrics_match_jax_and_the_host():
    r = np.random.RandomState(0)
    hw, b = 64, 3
    od_logits = np.full((b, hw, hw), -8.0, np.float32)
    oc_logits = np.full((b, hw, hw), -8.0, np.float32)
    od_gt = np.zeros((b, hw, hw), np.float32)
    oc_gt = np.zeros((b, hw, hw), np.float32)
    for i in range(b):
        cy, cx = r.randint(20, 44, 2)
        od_logits[i][_blob(hw, cy, cx, 12)] = 8.0
        od_logits[i][_blob(hw, 5, 5, 2)] = 8.0  # a speck the LCC removes
        oc_logits[i][_blob(hw, cy, cx, 6)] = 8.0
        od_logits[i] += r.randn(hw, hw).astype(np.float32)  # ragged edges
        od_gt[i][_blob(hw, cy + 1, cx - 1, 12)] = 1.0
        oc_gt[i][_blob(hw, cy + 1, cx - 2, 6)] = 1.0
    got = _both(od_logits, oc_logits, od_gt, oc_gt)
    for i in range(b):
        for name, logits, gt in (("disc", od_logits, od_gt), ("cup", oc_logits, oc_gt)):
            pred = largest_component_fill_holes_scipy(
                (1 / (1 + np.exp(-logits[i].astype(np.float64))) > 0.75).astype(np.uint8))
            assert got[f"{name}_dice"][i] == pytest.approx(M.dice_binary(pred, gt[i]), rel=1e-6)
            assert got[f"{name}_asd"][i] == pytest.approx(
                M.asd(pred, gt[i] > 0.5, backend="scipy"), rel=1e-4, abs=1e-4)
            assert got[f"{name}_hd"][i] == pytest.approx(
                M.hd95(pred, gt[i] > 0.5, backend="scipy"), rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("empty", ["prediction", "ground_truth"])
def test_empty_masks_score_the_sentinel(empty):
    hw = 32
    logits = np.full((1, hw, hw), -8.0, np.float32)
    gt = np.zeros((1, hw, hw), np.float32)
    if empty == "prediction":
        gt[0][_blob(hw, 16, 16, 6)] = 1.0
    else:
        logits[0][_blob(hw, 16, 16, 6)] = 8.0
    got = _both(logits, logits, gt, gt)
    for k in SURFACE:
        assert got[k][0] == 100.0, k


def test_hd95_is_the_percentile_of_the_pooled_distances():
    hw = 64
    logits = np.full((1, hw, hw), -8.0, np.float32)
    logits[0, 10:36, 10:36] = 8.0
    gt = np.zeros((1, hw, hw), np.float32)
    gt[0, 10:36, 10:36] = 1.0
    gt[0, 45:48, 45:48] = 1.0  # over 5% of d(gt -> pred), under 5% pooled
    got = _both(logits, logits, gt, gt)
    assert M.hd95(logits[0] > 0, gt[0] > 0.5, backend="scipy") == 0.0
    assert got["disc_hd"][0] == 0.0


def test_trainer_fast_validation_matches_jax_with_carried_weights(tmp_path):
    r = np.random.RandomState(6)
    yy, xx = np.mgrid[0:32, 0:32]
    gray = np.full((32, 32), 255, np.uint8)
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 90] = 128
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 25] = 0
    train = [FundusDomain(images=r.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8),
                          labels=gray[None]) for _ in range(3)]
    val = FundusDomain(images=r.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8),
                       labels=[np.kron(gray, np.ones((k, k), np.uint8)) for k in (2, 2, 3)])
    t = Trainer(default_hparams("WT_PSE"), train, val, str(tmp_path / "run"), batch_size=3,
                max_epoch=1, image_size=32, eval_batch_size=2, fast_validation=True,
                val_visualization=False, device="cpu")
    with torch.no_grad():  # lift the OD logits so that part of each image is in the ROI
        t.state.od.net.outc[0].bias += 1.1
    got = t.validate()
    assert t.scoring_backend == "device" and set(t.validation_seconds[-1]) == {"device"}
    assert t._val_od_256.shape == (3, 32, 32)

    path = str(tmp_path / "nets.pth.tar")
    save_ensemble(path, t.state)
    trees = jax_load_reference(path)
    img = jnp.zeros((1, 32, 32, 3))
    jnets = (JaxWTPSE(JCFG), JaxStudent(JCFG), JaxWTPSE(JCFG, two_step=True), JaxStudent(JCFG))
    variables = []
    for key, jm in zip(NET_KEYS, jnets):
        args = (img, jnp.zeros((1, 32, 32, 1))) if isinstance(jm, JaxWTPSE) else (img,)
        template = jax_init(jm, type(jm).initialize, *args)
        variables.append(load_into_variables(template, trees[key], strict=True)[0])
    want = jax_evaluate_domain_device(jax_make_predict_fn(*jnets), tuple(variables),
                                      np.asarray(val.images), t._val_od_256, t._val_oc_256,
                                      "OD", batch_size=2)
    assert set(got) == set(want)
    for k in DICE + ("objective",):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6), k
    for k in SURFACE:
        assert got[k] == pytest.approx(want[k], rel=F32_REDUCE[0]), k
    assert got["disc_dice"] > 0.05 and got["disc_hd"] < 100.0  # a non-empty OD prediction
