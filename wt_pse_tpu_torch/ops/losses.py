"""Auxiliary segmentation losses and the exact distance transform (counterpart
of ``wt_pse_tpu/ops/losses.py``; the reference's ``metrics.py:6-65,161-185``).

Tensors are NCHW. The WT-PSE step itself uses only BCE; these are the
reference's loss zoo, and :func:`distance_transform` also serves the
on-device validation (``train/eval_device.py``).

The distance transform is the exact separable squared EDT
(Felzenszwalb-Huttenlocher): a min-plus convolution with a parabola along
the rows, then along the columns, each a broadcast minimum over lines taken
in chunks of :data:`EDT_CHUNK` rows so the (rows, n, n) temporary stays
bounded on the card (at 256x256 and batch 8, one pass over all 2048 lines at
once would build a 537 MB tensor; a chunk is 134 MB). ``1e12`` stands in for
infinity inside the passes, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EDT_CHUNK = 512
_BIG = 1e12  # a finite stand-in for inf: min-plus safe in f32


def dice_loss_flat(probs: torch.Tensor, target: torch.Tensor, smooth: float = 1.0):
    """DiceLoss (metrics.py:161-174); inputs already in [0, 1]."""
    i = probs.reshape(-1)
    t = target.reshape(-1)
    inter = torch.sum(i * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(i) + torch.sum(t) + smooth)


def balanced_dice_loss(logits: torch.Tensor, target: torch.Tensor):
    """Balanced_DiceLoss (metrics.py:176-185): NCHW with 2 channels (cup,
    disc); the sigmoid is applied here."""
    p = torch.sigmoid(logits)
    return 0.5 * (dice_loss_flat(p[:, 0], target[:, 0])
                  + dice_loss_flat(p[:, 1], target[:, 1]))


def _minplus_parabola(f_sq: torch.Tensor) -> torch.Tensor:
    """Exact 1-D squared-distance transform along the last axis:
    ``out[i] = min_j (f[j] + (i - j)^2)``."""
    n = f_sq.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=f_sq.device)
    parab = torch.square(idx[:, None] - idx[None, :])  # (i, j)
    flat = f_sq.reshape(-1, n)
    out = [torch.amin(chunk[:, None, :] + parab[None], dim=-1)
           for chunk in torch.split(flat, EDT_CHUNK)]
    return torch.cat(out).reshape(f_sq.shape)


def distance_transform(bitmap: torch.Tensor) -> torch.Tensor:
    """Euclidean distance to the nearest True pixel for each item of a
    (B, H, W) map: 0 inside the mask, growing outside, inf where the item
    has no True pixel."""
    f = torch.where(bitmap > 0, 0.0, _BIG).to(torch.float32)
    f = _minplus_parabola(f)                                   # along W
    f = _minplus_parabola(f.transpose(-1, -2)).transpose(-1, -2)  # along H
    return torch.sqrt(torch.where(f >= _BIG, torch.inf, f))


def watershed_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """WatershedCrossEntropy (metrics.py:26-45), NCHW with channels [disc,
    cup]: BCE-with-logits weighted by ``target + 1``, to which the
    reference's ``map * (1 - DT / max(DT)) + 1`` reduces (DT is 0 wherever
    ``map`` is 1; ``wt_pse_tpu/ops/losses.py:76-91`` gives the argument)."""
    weights = target + 1.0
    ce = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
    return torch.mean(weights[:, 0] * ce[:, 0] + weights[:, 1] * ce[:, 1])


def cross_entropy2d(logits: torch.Tensor, target: torch.Tensor, weight=None,
                    size_average: bool = False) -> torch.Tensor:
    """cross_entropy2d (metrics.py:47-65): softmax CE over the channel axis,
    ignoring ``target < 0``; NCHW logits, (N, H, W) integer target."""
    logp = F.log_softmax(logits, dim=1)
    valid = target >= 0
    tgt = torch.clamp(target, min=0).long()
    picked = torch.gather(logp, 1, tgt[:, None])[:, 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logp.dtype, device=logp.device)[tgt]
        picked = picked * w
        denom = torch.sum(w * valid)
    else:
        denom = torch.sum(valid)
    loss = -torch.sum(picked * valid) / torch.clamp(denom, min=1)
    if size_average:
        loss = loss / torch.clamp(torch.sum(valid), min=1)
    return loss
