"""Validation on the device at network resolution (counterpart of
``wt_pse_tpu/train/eval_device.py``): the two-stage predict, then largest
component and hole fill (``ops/postprocess_device.py``), then Dice, ASD and
HD95 with the exact separable EDT (``ops/losses.distance_transform``) and
medpy's surface semantics (4-connected border = mask ^ erosion).

The predict hands over f32 logits whatever the nets' compute dtype.

Model selection needs a consistent, cheap objective every few epochs, not
the native-resolution numbers a paper reports; the host path
(``train/eval.py``) stays the evaluator for those. Here the host receives
one stacked copy of the per-image metrics a chunk and nothing else.

An empty prediction or an empty ground truth scores HD = ASD = 100 (the
host path raises on an empty ground truth; this path keeps model selection
running instead, as the JAX package does). Chunks are not padded: the port
runs any batch size, so no padded row exists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wt_pse_tpu_torch.ops.losses import distance_transform
from wt_pse_tpu_torch.ops.postprocess_device import postprocess_logits_device
from wt_pse_tpu_torch.train.eval import objective_from_means
from wt_pse_tpu_torch.utils.trace import Tracer

METRIC_KEYS = ("disc_dice", "cup_dice", "disc_asd", "cup_asd", "disc_hd", "cup_hd")


def _erode4(m: torch.Tensor) -> torch.Tensor:
    """4-connected erosion with a zero border (scipy ``border_value=0``);
    bool (B, H, W)."""
    pad = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    return (m & pad[:, :-2, 1:-1] & pad[:, 2:, 1:-1]
            & pad[:, 1:-1, :-2] & pad[:, 1:-1, 2:])


def _surface(m: torch.Tensor) -> torch.Tensor:
    return m & ~_erode4(m)


def _surface_stats(pred: torch.Tensor, gt: torch.Tensor):
    """(asd, hd95) for each item, medpy semantics. HD95 is the 95th
    percentile of the *pooled* distances both ways, with numpy's linear
    interpolation between order statistics."""
    sp = _surface(pred)
    sg = _surface(gt)
    dt_g = distance_transform(sg)  # distance to the GT surface
    dt_p = distance_transform(sp)
    b = pred.shape[0]
    n_p = torch.sum(sp, dim=(1, 2))
    n_g = torch.sum(sg, dim=(1, 2))
    asd_pg = (torch.sum(torch.where(sp, dt_g, 0.0), dim=(1, 2))
              / torch.clamp(n_p, min=1))
    # the surface distances first, every other entry +inf, so a sort packs
    # the n valid distances of a row at its front
    both = torch.cat([torch.where(sp, dt_g, torch.inf).reshape(b, -1),
                      torch.where(sg, dt_p, torch.inf).reshape(b, -1)], dim=1)
    srt = torch.sort(both, dim=1).values
    n = n_p + n_g
    rank = 0.95 * torch.clamp(n - 1, min=0).to(torch.float32)
    lo = torch.floor(rank).long()
    hi = torch.ceil(rank).long()
    v_lo = torch.gather(srt, 1, lo[:, None])[:, 0]
    v_hi = torch.gather(srt, 1, hi[:, None])[:, 0]
    frac = rank - lo.to(torch.float32)
    hd95 = torch.where(torch.isfinite(v_hi), v_lo + frac * (v_hi - v_lo), v_lo)
    empty = (torch.sum(pred, dim=(1, 2)) < 1) | (torch.sum(gt, dim=(1, 2)) < 1)
    return torch.where(empty, 100.0, asd_pg), torch.where(empty, 100.0, hd95)


def device_metrics(od_logits: torch.Tensor, oc_logits: torch.Tensor,
                   od_gt: torch.Tensor, oc_gt: torch.Tensor) -> dict[str, torch.Tensor]:
    """(B, H, W) logits and binary ground truths -> the per-item metrics,
    each a (B,) float32 tensor on the logits' device."""
    pred_od = postprocess_logits_device(od_logits).bool()
    pred_oc = postprocess_logits_device(oc_logits).bool()
    gt_od = od_gt > 0.5
    gt_oc = oc_gt > 0.5

    def dice(p, g):
        inter = torch.sum(p & g, dim=(1, 2)).to(torch.float32)
        return (2 * inter + 1) / (1 + torch.sum(p, dim=(1, 2)) + torch.sum(g, dim=(1, 2)))

    asd_od, hd_od = _surface_stats(pred_od, gt_od)
    asd_oc, hd_oc = _surface_stats(pred_oc, gt_oc)
    return {"disc_dice": dice(pred_od, gt_od), "cup_dice": dice(pred_oc, gt_oc),
            "disc_asd": asd_od, "cup_asd": asd_oc, "disc_hd": hd_od, "cup_hd": hd_oc}


def evaluate_domain_device(predict_fn, images_u8, od_gt_256, oc_gt_256,
                           label: str | None = "OD", batch_size: int = 8,
                           tracer: Tracer | None = None) -> dict[str, float]:
    """Validation at network resolution, on the device of ``predict_fn``.

    ``images_u8``: (N, H, W, 3) uint8, a numpy array or a tensor (on the
    card, the chunks are normalised there); ``od_gt_256`` / ``oc_gt_256``:
    (N, H, W) binary masks at the same resolution (the labels resized once
    at load). ``tracer``, if given, records the chunks as one span,
    ``device`` (to the end of the last chunk's one device-to-host copy;
    ``utils/trace.py``).
    """
    n = len(images_u8)
    images = torch.as_tensor(images_u8)
    sums = dict.fromkeys(METRIC_KEYS, 0.0)
    tracer = tracer if tracer is not None else Tracer()
    with tracer.span("device"):
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            img = images[start:stop].permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
            out_od, out_oc = predict_fn(img)
            dev = out_od.device
            god = torch.as_tensor(np.asarray(od_gt_256[start:stop]), dtype=torch.float32,
                                  device=dev)
            goc = torch.as_tensor(np.asarray(oc_gt_256[start:stop]), dtype=torch.float32,
                                  device=dev)
            m = device_metrics(out_od[:, 0], out_oc[:, 0], god, goc)
            per_item = torch.stack([m[k] for k in METRIC_KEYS]).cpu().numpy()  # the one copy
            for j, k in enumerate(METRIC_KEYS):
                sums[k] += float(per_item[j].sum())
    out = {k: v / n for k, v in sums.items()}
    out["objective"] = objective_from_means(out, label)
    return out
