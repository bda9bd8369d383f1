"""The port's evaluation at native resolution (``wt_pse_tpu_torch/train/eval.py``,
``ops/metrics.py``, ``ops/postprocess.py``) against the JAX package's, on the
CPU: the host upsample within 1e-12; the metric and post-processing copies
exactly equal to the JAX package's scipy path; ``evaluate_domain`` of both
packages on the same stub logits, Dice within 1e-9 and HD/ASD within 1e-5
relative (the JAX side may take its float32 native engine); the validation
montage's pieces equal the JAX package's, down to the PNG's bytes.
"""

import os

import numpy as np
import pytest
import torch

import wt_pse_tpu.native as jax_native
from wt_pse_tpu.ops import metrics as JM
from wt_pse_tpu.ops import postprocess as JP
from wt_pse_tpu.train import eval as JE
from wt_pse_tpu_torch import native as port_native
from wt_pse_tpu_torch.ops import metrics as M
from wt_pse_tpu_torch.ops import postprocess as PP
from wt_pse_tpu_torch.train import eval as E
from wt_pse_tpu_torch.utils.trace import Tracer

from torch_port import torch_single_thread  # noqa: F401


@pytest.fixture
def scipy_only(monkeypatch):
    """Both packages' metrics on their scipy paths: the port's copy of the
    JAX package's."""
    monkeypatch.setattr(jax_native, "AVAILABLE", False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def _disk(hw, cy, cx, r):
    yy, xx = np.mgrid[0:hw, 0:hw]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


@pytest.mark.parametrize("out_hw", [(48, 48), (64, 80), (32, 32)])
def test_resize_host_matches_jax(out_hw):
    x = np.random.RandomState(0).randn(3, 2, 32, 32).astype(np.float32) * 4
    got = E._resize_host(x, out_hw)
    want = JE._resize_host(np.transpose(x, (0, 2, 3, 1)), out_hw)
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)), rtol=0, atol=1e-12)


def test_metrics_match_jax_scipy_path(scipy_only):
    r = np.random.RandomState(1)
    for _ in range(6):
        hw = int(r.choice([40, 64]))
        a = _disk(hw, *r.uniform(12, hw - 12, 2), r.uniform(4, 10)) | (r.rand(hw, hw) > 0.995)
        b = _disk(hw, *r.uniform(12, hw - 12, 2), r.uniform(4, 10))
        assert M.dice_binary(a, b) == JM.dice_binary(a, b)
        np.testing.assert_array_equal(M.surface_distances(a, b), JM.surface_distances(a, b))
        for fn in ("asd", "assd", "hd95"):
            assert getattr(M, fn)(a, b) == getattr(JM, fn)(a, b), fn
        pred2, gt2 = np.stack([a, b]), np.stack([b, a])
        for label in ("OD", None):
            assert M.dice_coeff_2label(pred2, gt2, label) == JM.dice_coeff_2label(pred2, gt2, label)
    with pytest.raises(ValueError, match="empty"):
        M.hd95(np.zeros((8, 8), bool), np.ones((8, 8), bool))


def test_postprocess_matches_jax_scipy_path(scipy_only):
    r = np.random.RandomState(2)
    for _ in range(5):
        m = (r.rand(48, 48) > 0.6) | _disk(48, 20, 24, 9)
        m[22:25, 22:25] = False  # a hole to fill
        np.testing.assert_array_equal(PP.largest_component_fill_holes(m),
                                      JP.largest_component_fill_holes_scipy(m))
        logits = r.randn(2, 48, 48) * 3
        for label in ("OD", "OC", None):
            np.testing.assert_array_equal(PP.postprocess_logits(logits, label=label),
                                          JP.postprocess_logits(logits, label=label))
    # two components of equal area: the first label wins
    tie = np.zeros((10, 10), np.uint8)
    tie[1:3, 1:3] = tie[6:8, 6:8] = 1
    np.testing.assert_array_equal(PP.largest_component_fill_holes(tie),
                                  JP.largest_component_fill_holes_scipy(tie))


def _stub_domain(n=6, hw=32):
    """Images whose channels 0 and 1 carry an OD and an OC disk (image 2 has an
    empty OD channel: an empty prediction), and GT masks at native 48x48
    (images 0-3) and 64x64 (images 4-5)."""
    r = np.random.RandomState(4)
    images = np.zeros((n, hw, hw, 3), np.uint8)
    od_masks, oc_masks = [], []
    for i in range(n):
        cy, cx = r.uniform(0.4, 0.6, 2)
        rad = r.uniform(0.2, 0.3)
        images[i, ..., 0] = 255 * _disk(hw, cy * hw, cx * hw, rad * hw) * (i != 2)
        images[i, ..., 1] = 255 * _disk(hw, cy * hw + 1, cx * hw, 0.5 * rad * hw)
        images[i, ..., 2] = r.randint(0, 255, (hw, hw))
        native = 48 if i < 4 else 64
        gy, gx = (cy + r.uniform(-0.03, 0.03)) * native, cx * native
        od_masks.append(_disk(native, gy, gx, rad * native).astype(np.float32))
        oc_masks.append(_disk(native, gy, gx, 0.5 * rad * native).astype(np.float32))
    return images, od_masks, oc_masks


@pytest.mark.parametrize("label", ["OD", "OC"])
def test_evaluate_domain_matches_jax_on_shared_logits(label):
    images, od_masks, oc_masks = _stub_domain()

    def jax_predict(*args):  # (variables..., NHWC image)
        img = args[-1]
        return 8.0 * img[..., 0:1], 8.0 * img[..., 1:2]

    def port_predict(img):  # NCHW
        return 8.0 * img[:, 0:1], 8.0 * img[:, 1:2]

    tracer = Tracer()
    with tracer.span("validate") as validate:
        got = E.evaluate_domain(port_predict, images, od_masks, oc_masks, label, batch_size=3,
                                tracer=tracer)
    timings = tracer.child_seconds(validate)
    want = JE.evaluate_domain(jax_predict, (), images, od_masks, oc_masks, label, batch_size=3)
    assert set(got) == set(want) == {"cup_dice", "disc_dice", "cup_hd", "disc_hd",
                                     "cup_asd", "disc_asd", "objective"}
    assert set(timings) == {"predict", "upsample", "score"}
    for k in ("cup_dice", "disc_dice", "objective"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9), k
    for k in ("cup_hd", "disc_hd", "cup_asd", "disc_asd"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    # image 2's empty OD prediction scored the 100.0 sentinel
    assert 100.0 / 6 < got["disc_hd"] and got["objective"] == got[
        "disc_dice" if label == "OD" else "cup_dice"]
    # the same through a device-side tensor of images (how the Trainer calls it)
    again = E.evaluate_domain(port_predict, torch.from_numpy(images), od_masks, oc_masks,
                              label, batch_size=4)
    assert again == got


def test_score_one_sentinel_first_then_empty_gt_raises():
    logits = np.full((1, 16, 16), -9.0)
    gt = np.zeros((16, 16))
    res = E._score_one(logits, logits, gt, gt, "OD")  # empty prediction: no raise
    assert res["disc_hd"] == res["cup_asd"] == 100.0
    logits[0, 4:9, 4:9] = 9.0
    with pytest.raises(ValueError, match="empty ground-truth"):
        E._score_one(logits, np.full((1, 16, 16), -9.0), gt, gt, "OD")
    assert E.objective_from_means({"cup_dice": 0.2, "disc_dice": 0.6}, None) == pytest.approx(0.4)


def test_validation_montage_matches_jax(tmp_path):
    from wt_pse_tpu.utils import visualization as JV
    from wt_pse_tpu_torch.utils import visualization as V

    r = np.random.RandomState(5)
    image = (r.rand(40, 40, 3) * 2 - 1).astype(np.float32)
    pred = np.stack([_disk(40, 20, 21, 6), _disk(40, 19, 20, 12)]).astype(np.float32)
    gt = np.stack([_disk(40, 21, 20, 7), _disk(40, 20, 20, 13)]).astype(np.float32)
    smooth = r.rand(40, 40)
    np.testing.assert_array_equal(V.find_contour_points(smooth), JV.find_contour_points(smooth))
    np.testing.assert_array_equal(V.mask_boundary(gt[1]), JV.mask_boundary(gt[1]))
    np.testing.assert_array_equal(V.untransform(image), JV.untransform(image))
    u8 = V.untransform(image)
    np.testing.assert_array_equal(V.overlay_contours(u8, pred, gt),
                                  JV.overlay_contours(u8, pred, gt))
    montage = V.joint_val_image(image, pred, gt)
    np.testing.assert_array_equal(montage, JV.joint_val_image(image, pred, gt))
    got = V.save_val_img(str(tmp_path / "port"), 3, [montage, montage])
    want = JV.save_val_img(str(tmp_path / "jax"), 3, [montage, montage])
    assert got.endswith(os.path.join("visualization", "epoch_3.png"))
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("out_hw", [(512, 512), (640, 640)])
def test_resize_device_matches_jax_and_the_host_f64(out_hw):
    """The device upsample (two f32 products with the host's resize
    matrices) against the f64 host upsample at the Fundus label sizes:
    within ``f32_reduce``. This decides the formulation:
    ``F.interpolate(mode="bilinear", align_corners=False)`` and the JAX
    package's device ``_resize_logits`` take the same taps but weigh them
    from f32 coordinates, and at 640 land 2e-5 of the range away: they are
    held at 1e-4."""
    import torch.nn.functional as F

    from torch_port import F32_REDUCE, assert_close

    x = np.random.RandomState(7).randn(2, 1, 256, 256).astype(np.float32) * 6
    got = E.resize_device(torch.from_numpy(x), out_hw).numpy()
    interp = F.interpolate(torch.from_numpy(x), size=out_hw, mode="bilinear",
                           align_corners=False).numpy()
    assert_close(interp, got, (1e-4, 0), "F.interpolate, at a looser class")
    host = E._resize_host(x, out_hw)
    jax_dev = np.transpose(np.asarray(JE._resize_logits(np.transpose(x, (0, 2, 3, 1)), out_hw)),
                           (0, 3, 1, 2))
    assert_close(got, host, F32_REDUCE, "device vs host f64")
    assert_close(jax_dev, got, (1e-4, 0), "JAX _resize_logits, at a looser class")


def test_evaluate_domain_resize_device_scores_as_the_host():
    images, od_masks, oc_masks = _stub_domain()

    def port_predict(img):
        return 8.0 * img[:, 0:1], 8.0 * img[:, 1:2]

    host = E.evaluate_domain(port_predict, images, od_masks, oc_masks, "OD", batch_size=3)
    tracer = Tracer()
    with tracer.span("validate") as validate:
        dev = E.evaluate_domain(port_predict, images, od_masks, oc_masks, "OD", batch_size=3,
                                tracer=tracer, resize="device")
    timings = tracer.child_seconds(validate)
    assert timings["upsample"] < timings["predict"]
    for k in host:
        assert dev[k] == pytest.approx(host[k], rel=1e-6, abs=1e-9), k
    with pytest.raises(ValueError, match="resize"):
        E.evaluate_domain(port_predict, images, od_masks, oc_masks, resize="gpu")
