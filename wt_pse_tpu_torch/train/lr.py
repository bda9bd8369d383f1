"""Learning-rate schedule: the reference's (disabled) ``lr_update``
(counterpart of ``wt_pse_tpu/train/lr.py:60-133``).

``Trainer.lr_update`` (``Trainer.py:989-1004``) is a linear warmup and
milestone step decay applied once an epoch:

    alpha  = epoch / warmup_steps
    factor = warmup_factor * (1 - alpha) + alpha
    lr     = base_lr * factor * gamma ** bisect_right(milestones, epoch)

Its call is commented out as shipped (``Trainer.py:1040``); the arguments it
would receive are defined above the epoch loop (``Trainer.py:1017-1022``):
``warmup_factor = 0.001``, ``Steps = (100, 150)``, ``gamma = 0.5``,
``warmup_steps = max_epoch * 2``. The od base lr drives the od seg and od
shape optimizers, the oc base lr the other two.

The call sits after ``train_epoch()``, so epoch 0 trains at each optimizer's
constructor lr (including ``lr_od_shape`` / ``lr_oc_shape``) and epoch
``e >= 1`` at the formula evaluated at ``e - 1``. The formula has no
``alpha <= 1`` clamp (``clamp_warmup=True`` adds one).

The port writes the epoch's lr into each optimizer's ``param_groups`` at the
start of the epoch (:func:`epoch_lrs`). The JAX package evaluates the same
schedule at every update from the update count divided by the updates an
epoch (``iter_per_epoch``, times ``multi-turn`` for the shape students); an lr
constant over an epoch gives the same value at every update.
:func:`reference_lr_schedule` is that per-update form, in f32 as JAX's.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Sequence

import torch

REF_WARMUP_FACTOR = 0.001
REF_GAMMA = 0.5
REF_MILESTONES = (100, 150)


def reference_lr_kwargs(max_epoch: int) -> dict:
    """The ``lr_update`` arguments of the reference's call site
    (``Trainer.py:1017-1022``)."""
    return dict(warmup_steps=max_epoch * 2, warmup_factor=REF_WARMUP_FACTOR,
                gamma=REF_GAMMA, milestones=REF_MILESTONES)


def reference_lr_value(base_lr: float, epoch: int, warmup_steps: int,
                       warmup_factor: float = REF_WARMUP_FACTOR,
                       gamma: float = REF_GAMMA,
                       milestones: Sequence[int] = REF_MILESTONES,
                       clamp_warmup: bool = False,
                       applied_after_epoch: bool = True,
                       first_epoch_lr: float | None = None) -> float:
    """The lr in effect during training epoch ``epoch``. With
    ``applied_after_epoch`` (the default), epoch 0 returns ``first_epoch_lr``
    (default ``base_lr``) and epoch e the formula at e - 1."""
    if warmup_steps < 1:
        raise ValueError(f"warmup_steps must be >= 1 (got {warmup_steps})")
    if applied_after_epoch:
        if epoch <= 0:
            return base_lr if first_epoch_lr is None else first_epoch_lr
        epoch = epoch - 1
    alpha = epoch / warmup_steps
    if clamp_warmup:
        alpha = min(alpha, 1.0)
    factor = warmup_factor * (1.0 - alpha) + alpha
    return base_lr * factor * gamma ** bisect_right(sorted(milestones), epoch)


def reference_lr_schedule(base_lr: float, updates_per_epoch: int, warmup_steps: int,
                          warmup_factor: float = REF_WARMUP_FACTOR,
                          gamma: float = REF_GAMMA,
                          milestones: Sequence[int] = REF_MILESTONES,
                          clamp_warmup: bool = False,
                          applied_after_epoch: bool = True,
                          first_epoch_lr: float | None = None):
    """``schedule(count) -> lr``, the JAX package's per-update schedule
    (``wt_pse_tpu/train/lr.py:92-133``) as an f32 tensor: ``epoch = count //
    updates_per_epoch``; the decays counted as ``bisect_right`` counts them
    (``searchsorted(side='right')``: a milestone epoch already decays); with
    ``applied_after_epoch``, epoch 0 at ``first_epoch_lr`` (default
    ``base_lr``) and epoch e at the formula at e - 1. ``count`` may be a
    tensor of counts."""
    if warmup_steps < 1:
        raise ValueError(f"warmup_steps must be >= 1 (got {warmup_steps})")
    if updates_per_epoch < 1:
        raise ValueError(f"updates_per_epoch must be >= 1 (got {updates_per_epoch})")
    ms = torch.tensor(sorted(milestones), dtype=torch.int32)
    lr0 = base_lr if first_epoch_lr is None else first_epoch_lr

    def schedule(count) -> torch.Tensor:
        epoch = torch.as_tensor(count, dtype=torch.int32) // updates_per_epoch
        f_epoch = torch.clamp(epoch - 1, min=0) if applied_after_epoch else epoch
        alpha = f_epoch.to(torch.float32) / warmup_steps
        if clamp_warmup:
            alpha = torch.clamp(alpha, max=1.0)
        factor = warmup_factor * (1.0 - alpha) + alpha
        n_decays = torch.searchsorted(ms.to(f_epoch.device), f_epoch, right=True)
        lr = base_lr * factor * torch.tensor(gamma, dtype=torch.float32) ** n_decays
        if applied_after_epoch:
            lr = torch.where(epoch == 0, torch.tensor(lr0, dtype=torch.float32), lr)
        return lr

    return schedule


def epoch_lrs(epoch: int, lr_od: float, lr_od_shape: float, lr_oc: float,
              lr_oc_shape: float, **schedule) -> tuple[float, float, float, float]:
    """The lr of each optimizer (od, od_shape, oc, oc_shape) during ``epoch``:
    each constructor lr in epoch 0, then the od base lr's schedule for od and
    od_shape and the oc base lr's for oc and oc_shape (Trainer.py:996-1004).
    ``schedule`` holds the :func:`reference_lr_value` arguments."""
    return (reference_lr_value(lr_od, epoch, first_epoch_lr=lr_od, **schedule),
            reference_lr_value(lr_od, epoch, first_epoch_lr=lr_od_shape, **schedule),
            reference_lr_value(lr_oc, epoch, first_epoch_lr=lr_oc, **schedule),
            reference_lr_value(lr_oc, epoch, first_epoch_lr=lr_oc_shape, **schedule))
