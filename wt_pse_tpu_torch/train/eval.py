"""Two-stage prediction and its evaluation at native resolution (counterpart
of ``wt_pse_tpu/train/eval.py``):

  out_od   = main_od.predict(student_od, image)             # 256x256 logits
  od_pred  = sigmoid(out_od) > 0.75
  roi      = (image + 1) * od_pred - 1
  out_oc   = main_oc.predict(student_oc, roi) * od_pred
  both -> bilinear upsample to the native label resolution (host, f64)
       -> sigmoid > 0.75 -> largest CC -> fill holes -> Dice / HD95 / ASD
  an empty prediction scores HD = ASD = 100                  (Trainer.py:221-233)

The joint variant's predict (:func:`make_predict_fn_joint`) is the same two
stages with each net's own prior and no student. The nets predict in their
compute dtype; the predict returns the logits as f32, for the upsample and
the scoring.

The predict runs on the card in chunks of ``batch_size`` images of one native
resolution, with one device-to-host copy a chunk. The upsample runs on the
host in f64 (``resize='host'``, the default, as in the JAX package) or on the
card (``resize='device'``: the same half-pixel resize matrices applied in
f32). The scoring runs on the host, on the native C++ operators or scipy
(``native.scoring_backend``).
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch

from wt_pse_tpu_torch import native
from wt_pse_tpu_torch.config.hparams import JOINT
from wt_pse_tpu_torch.models.joint import JointShapeReg
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.ops import metrics as M
from wt_pse_tpu_torch.ops.postprocess import postprocess_logits
from wt_pse_tpu_torch.runtime import resolve_device
from wt_pse_tpu_torch.utils.trace import Tracer


def make_predict_fn(main_od: WTPSE, stud_od: ShapeStudent, main_oc: WTPSE,
                    stud_oc: ShapeStudent, *, device: str | torch.device = "cuda"):
    """``predict(image) -> (od_logits, oc_logits)`` for an NCHW image batch
    (tensor or array, moved to ``device``), with every net in eval mode and no
    gradient. The nets must live on ``device``."""
    dev = resolve_device(device)
    shape_prior = main_od.cfg.shape_prior
    nets = (main_od, stud_od, main_oc, stud_oc)

    def stage(main: WTPSE, stud: ShapeStudent, x: torch.Tensor) -> torch.Tensor:
        if shape_prior:
            return main.predict_with_shape(x, stud.sample_from_image(x))
        return main.predict_no_shape(x)

    return _two_stage(nets, lambda x: stage(main_od, stud_od, x),
                      lambda x: stage(main_oc, stud_oc, x), dev)


def make_predict_fn_joint(main_od: JointShapeReg, main_oc: JointShapeReg, *,
                          device: str | torch.device = "cuda"):
    """The joint variant's two-stage predict (``wt_pse_tpu/train/eval.py:89-116``):
    each net through its own prior, at the prior's mean; no student."""
    return _two_stage((main_od, main_oc), main_od.predict, main_oc.predict,
                      resolve_device(device))


def make_predict_fn_for(algorithm: str, nets, *, device: str | torch.device = "cuda"):
    """The predict of ``algorithm`` over the 4 nets (od, od_shape, oc, oc_shape);
    the joint variant uses only od and oc."""
    if algorithm == JOINT:
        return make_predict_fn_joint(nets[0], nets[2], device=device)
    return make_predict_fn(*nets, device=device)


def _two_stage(nets, stage_od, stage_oc, dev: torch.device):
    """``predict(image)``: OD logits, then the OC logits on the ROI that the
    thresholded OD logits cut, masked by it; both returned as f32."""

    @torch.no_grad()
    def predict(image) -> tuple[torch.Tensor, torch.Tensor]:
        for net in nets:
            net.eval()
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        out_od = stage_od(image)
        od_pred = (torch.sigmoid(out_od) > 0.75).to(image.dtype)
        roi = (image + 1.0) * od_pred - 1.0
        return out_od.float(), stage_oc(roi).float() * od_pred

    return predict


@functools.lru_cache(maxsize=32)
def _resize_matrix_f64(in_size: int, out_size: int) -> np.ndarray:
    """The f64 resize matrix, cached: every chunk of a resolution reuses it.
    Callers must not mutate it."""
    return _linear_resize_matrix_np(in_size, out_size).astype(np.float64)


def _linear_resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Half-pixel bilinear resize matrix (out_size, in_size), built in f32 as
    the JAX package builds it."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    w_lo = 1.0 - w_hi
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo), w_lo)
    np.add.at(m, (np.arange(out_size), hi), w_hi)
    return m


def _resize_host(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear upsample of NCHW logits on the host, accumulated in f64."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    mh = _resize_matrix_f64(h, oh)
    mw = _resize_matrix_f64(w, ow)
    y = np.einsum("oh,nchw->ncow", mh, x.astype(np.float64))
    return np.einsum("pw,ncow->ncop", mw, y).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resize_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_linear_resize_matrix_np(in_size, out_size)).to(device)


def resize_device(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW logits where they lie, as two f32 products
    with the host upsample's half-pixel resize matrices. ``F.interpolate``
    (like the JAX package's device ``_resize_logits``) weighs the same taps
    from f32 coordinates and lands 2e-5 of the range away at 256 -> 640
    (``tests/test_torch_eval.py``), so it is not used."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    mh = _resize_matrix_on(h, oh, x.device)
    mw = _resize_matrix_on(w, ow, x.device)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def evaluate_domain(predict_fn, images_u8, od_masks: list[np.ndarray],
                    oc_masks: list[np.ndarray], label: str | None = "OD",
                    batch_size: int = 8, tracer: Tracer | None = None,
                    resize: str = "host", backend: str = "auto") -> dict[str, float]:
    """Evaluate one test domain.

    Args:
      predict_fn: from :func:`make_predict_fn`.
      images_u8: (N, 256, 256, 3) uint8 test images, a numpy array or a
        tensor (on the card, the chunks are normalised there).
      od_masks / oc_masks: per-image native-resolution binary masks.
      label: the validation objective ('OD' / 'OC' / None), Trainer.py:269-274.
      tracer: if given, each chunk's predict (to the end of its
        device-to-host copy), upsample and host scoring are its spans
        ``predict``, ``upsample`` and ``score`` (``utils/trace.py``). With
        ``resize='device'`` the upsample on the card is inside ``predict``
        and ``upsample`` is the host's no-op.
      resize: 'host' (f64 on the host) or 'device' (:func:`resize_device`).
      backend: the scoring engine, 'auto', 'native' or 'scipy'
        (``native.scoring_backend``).

    Returns the means of cup_dice, disc_dice, cup_hd, disc_hd, cup_asd,
    disc_asd, and ``objective`` keyed by ``label``.
    """
    if resize not in ("host", "device"):
        raise ValueError(f"resize must be 'host' or 'device', got {resize!r}")
    backend = native.scoring_backend(backend)
    n = len(images_u8)
    images = torch.as_tensor(images_u8)
    tracer = tracer if tracer is not None else Tracer()
    sums = defaultdict(float)
    groups: dict[tuple[int, int], list[int]] = defaultdict(list)
    for i in range(n):
        groups[od_masks[i].shape[-2:]].append(i)

    for native_hw, idxs in groups.items():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            with tracer.span("predict"):
                sel = torch.as_tensor(chunk, device=images.device)
                img = images[sel].permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
                out_od, out_oc = predict_fn(img)
                if resize == "device":
                    out_od = resize_device(out_od, native_hw)
                    out_oc = resize_device(out_oc, native_hw)
                logits = torch.stack([out_od, out_oc]).cpu().numpy()
            with tracer.span("upsample"):
                od_native = _resize_host(logits[0], native_hw)  # no-op after the device
                oc_native = _resize_host(logits[1], native_hw)
            with tracer.span("score"):
                for j, i in enumerate(chunk):
                    res = _score_one(od_native[j], oc_native[j],
                                     np.asarray(od_masks[i]).squeeze(),
                                     np.asarray(oc_masks[i]).squeeze(), label, backend)
                    for k, v in res.items():
                        sums[k] += v

    out = {k: v / n for k, v in sums.items()}
    out["objective"] = objective_from_means(out, label)
    return out


def objective_from_means(out: dict, label: str | None) -> float:
    """The model-selection objective from domain means (Trainer.py:269-288):
    the trained label's Dice, or the cup/disc mean for the 2-class mode."""
    if label == "OD":
        return out["disc_dice"]
    if label == "OC":
        return out["cup_dice"]
    return (out["cup_dice"] + out["disc_dice"]) / 2


def _score_one(od_logits: np.ndarray, oc_logits: np.ndarray, od_gt: np.ndarray,
               oc_gt: np.ndarray, label: str | None,
               backend: str = "auto") -> dict[str, float]:
    """Score one image from (C, H, W) logits.

    ``label`` set: C == 1 and channel 0 carries the stage's class.
    ``label=None`` (the reference's 2-class validation mode): C == 2 in the
    reference's channel order [cup, disc]; Dice reads disc from the OD model's
    channel 1 and cup from the OC model's channel 0, while HD/ASD compare
    channel 0 of each model against the cup GT (Trainer.py:221-239, the
    reference's own channel choice). ``backend`` is the scoring engine."""
    if label is None:
        pred_od = postprocess_logits(od_logits, label=None, backend=backend)
        pred_oc = postprocess_logits(oc_logits, label=None, backend=backend)
        gt2 = np.stack([oc_gt, od_gt])
        _, disc_dice = M.dice_coeff_2label(pred_od, gt2, None)
        cup_dice, _ = M.dice_coeff_2label(pred_oc, gt2, None)
        pred_od, od_gt = pred_od[0], gt2[0]
        pred_oc, oc_gt = pred_oc[0], gt2[0]
    else:
        pred_od = postprocess_logits(od_logits, label=label, backend=backend)[0]
        pred_oc = postprocess_logits(oc_logits, label=label, backend=backend)[0]
        _, disc_dice = M.dice_coeff_2label(pred_od[None], od_gt[None], label)
        cup_dice, _ = M.dice_coeff_2label(pred_oc[None], oc_gt[None], label)

    as_bool = lambda x: np.asarray(x, dtype=bool)

    def require_nonempty_gt(name, gt):
        # the empty-prediction sentinel is checked first (Trainer.py:219-233);
        # medpy meets an empty ground truth only under a non-empty prediction,
        # and fails there: say why instead
        if np.asarray(gt).sum() < 1:
            raise ValueError(
                f"empty ground-truth mask in the {name} surface-distance "
                "comparison: the metric is undefined (the reference's medpy "
                "path fails here too)")

    if pred_oc.sum() < 1e-4:
        cup_hd = cup_asd = 100.0
    else:
        require_nonempty_gt("OC", oc_gt)
        cup_hd = M.hd95(as_bool(pred_oc), as_bool(oc_gt), backend)
        cup_asd = M.asd(as_bool(pred_oc), as_bool(oc_gt), backend)
    if pred_od.sum() < 1e-4:
        disc_hd = disc_asd = 100.0
    else:
        require_nonempty_gt("OD", od_gt)
        disc_hd = M.hd95(as_bool(pred_od), as_bool(od_gt), backend)
        disc_asd = M.asd(as_bool(pred_od), as_bool(od_gt), backend)
    return {"cup_dice": cup_dice, "disc_dice": disc_dice, "cup_hd": cup_hd,
            "disc_hd": disc_hd, "cup_asd": cup_asd, "disc_asd": disc_asd}
