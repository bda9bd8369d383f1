"""Post-processing on the device: largest connected component and hole fill
(counterpart of ``wt_pse_tpu/ops/postprocess_device.py``), batched over B.

- :func:`label_components`: 8- (or 4-) neighbour max-propagation of unique
  seed ids (the linear pixel index + 1) to a fixpoint, at most ``max_iters``
  iterations (H + W by default). Equals scipy's labelling for every
  component whose geodesic diameter fits the cap.
- :func:`largest_component`: component areas by one scatter-add over the id
  map; of equal areas the lowest id wins, as ``jnp.argmax`` (and
  ``torch.argmax``) pick the first maximum.
- :func:`fill_holes`: a 4-connected background flood from the border
  (scipy ``binary_fill_holes``), complemented, with the same H + W cap.

Dilations are ``F.max_pool2d`` with stride 1 and padding 1, which pads with
-inf as the JAX package's ``reduce_window`` does; the 4-connected cross is the
maximum of a (3, 1) and a (1, 3) pool.

The fixpoint loop checks for a change only every ``check_every`` iterations
(one host sync a check, not one an iteration). Past the fixpoint the
propagation changes nothing, so the result is the JAX loop's, which stops at
the first unchanged iteration; and it never runs past ``max_iters``, where the
JAX loop stops too, so a shape whose geodesic length exceeds the cap gives
the JAX package's capped result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHECK_EVERY = 16


def _maxpool8(x: torch.Tensor) -> torch.Tensor:
    """3x3 max (8-connectivity dilation), same size; x: (B, H, W)."""
    return F.max_pool2d(x[:, None], 3, stride=1, padding=1)[:, 0]


def _maxpool4(x: torch.Tensor) -> torch.Tensor:
    """Cross-shaped max (4-connectivity dilation); x: (B, H, W)."""
    a = F.max_pool2d(x[:, None], (3, 1), stride=1, padding=(1, 0))
    b = F.max_pool2d(x[:, None], (1, 3), stride=1, padding=(0, 1))
    return torch.maximum(a, b)[:, 0]


def _propagate(ids: torch.Tensor, mask: torch.Tensor, pool, max_iters: int,
               check_every: int = CHECK_EVERY) -> torch.Tensor:
    """The fixpoint of id max-propagation restricted to ``mask``, or the state
    after ``max_iters`` iterations, whichever comes first."""
    done = 0
    while done < max_iters:
        n = min(check_every, max_iters - done)
        before = ids
        for _ in range(n):
            ids = torch.where(mask, pool(ids), ids)
        done += n
        # values only grow, so no change over n iterations is the fixpoint
        if torch.equal(ids, before):
            break
    return ids


def label_components(mask: torch.Tensor, connectivity: int = 2,
                     max_iters: int | None = None,
                     check_every: int = CHECK_EVERY) -> torch.Tensor:
    """(B, H, W) binary -> (B, H, W) int32 component ids (0 = background):
    each component's largest linear pixel index + 1."""
    b, h, w = mask.shape
    # the seeds ride float32 through max_pool2d; they stay exact up to 2^24
    if h * w + 1 > 2 ** 24:
        raise ValueError(
            f"label_components supports at most 2^24-1 pixels (got {h}x{w}); "
            "use the host path (ops/postprocess.py) for larger masks")
    m = mask > 0
    seeds = (torch.arange(h * w, dtype=torch.float32, device=mask.device)
             .reshape(1, h, w) + 1.0) * m
    pool = _maxpool8 if connectivity == 2 else _maxpool4
    iters = max_iters if max_iters is not None else h + w
    return _propagate(seeds, m, pool, iters, check_every).to(torch.int32)


def largest_component(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Keep only the largest component of each item (bool (B, H, W))."""
    b, h, w = mask.shape
    ids = label_components(mask, connectivity)
    flat = ids.reshape(b, h * w).long()
    areas = torch.zeros(b, h * w + 1, dtype=torch.int64, device=mask.device)
    areas.scatter_add_(1, flat, torch.ones_like(flat))
    areas[:, 0] = 0
    best = torch.argmax(areas, dim=1)  # the first maximum: the lowest id
    return (ids == best[:, None, None]) & (mask > 0)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy ``binary_fill_holes`` (4-connected background flood from the
    border, at most H + W steps: a background corridor longer than that is
    read as a hole)."""
    b, h, w = mask.shape
    m = mask > 0
    bg = ~m
    border = torch.zeros((1, h, w), dtype=torch.bool, device=mask.device)
    border[:, 0, :] = border[:, -1, :] = True
    border[:, :, 0] = border[:, :, -1] = True
    reach0 = (border & bg).to(torch.float32)
    reach = _propagate(reach0, bg, _maxpool4, h + w) > 0
    return m | (bg & ~reach)


def postprocess_logits_device(logits: torch.Tensor, threshold: float = 0.75) -> torch.Tensor:
    """(B, H, W) logits -> uint8 masks after sigmoid > threshold, largest
    component and hole fill (the device twin of ``postprocess_logits``)."""
    binary = torch.sigmoid(logits) > threshold
    return fill_holes(largest_component(binary)).to(torch.uint8)
