"""Training state (counterpart of ``wt_pse_tpu/train/state.py``).

Four disjoint nets, each with its own Adam (``betas=(0.9, 0.99)``, eps 1e-8,
the reference's ``train.py:120-138``). Unlike the JAX pytree, the state is
mutable: the step updates the nets and optimizers in place. The parameters
are f32 in either compute dtype (Adam updates f32 master weights).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from wt_pse_tpu_torch.config.hparams import JOINT
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.joint import JointShapeReg
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.runtime import resolve_device


def reference_adam(params, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam(lr, betas=(0.9, 0.99), eps=1e-8)``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-8)


@dataclasses.dataclass
class NetState:
    net: nn.Module
    opt: torch.optim.Optimizer

    @classmethod
    def create(cls, net: nn.Module, lr: float) -> "NetState":
        return cls(net=net, opt=reference_adam(net.parameters(), lr))


@dataclasses.dataclass
class WTPSETrainState:
    """OD seg + OD shape student, OC seg + OC shape student (train.py:91-114)."""

    od: NetState
    od_shape: NetState
    oc: NetState
    oc_shape: NetState
    step: int = 0

    def net_states(self) -> tuple[NetState, NetState, NetState, NetState]:
        """(od, od_shape, oc, oc_shape), the order of the reference's
        checkpoint keys and of ``make_predict_fn``'s arguments."""
        return self.od, self.od_shape, self.oc, self.oc_shape


def init_ensemble(cfg: ModelConfig, *, device: str | torch.device = "cuda",
                  generator: torch.Generator | None = None,
                  lr_od: float = 5e-4, lr_od_shape: float = 5e-4,
                  lr_oc: float = 5e-4, lr_oc_shape: float = 5e-4,
                  algorithm: str = "WT_PSE") -> WTPSETrainState:
    """Build all four nets with Flax-style initial weights drawn in the order
    od, od_shape, oc, oc_shape from ``generator`` (seed 0 when omitted), on
    ``device``, each with its Adam. Default learning rates match train.py:197-200.
    For the joint algorithm the od and oc nets are :class:`JointShapeReg`; the
    two students are built as the JAX Trainer builds them (they are in the
    checkpoint layout) and never trained (``wt_pse_tpu/train/trainer.py:208-220``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    main = JointShapeReg if algorithm == JOINT else WTPSE
    od = main(cfg, device=dev, generator=generator)
    od_shape = ShapeStudent(cfg, device=dev, generator=generator)
    oc = main(cfg, device=dev, generator=generator)
    oc_shape = ShapeStudent(cfg, device=dev, generator=generator)
    return WTPSETrainState(
        od=NetState.create(od, lr_od), od_shape=NetState.create(od_shape, lr_od_shape),
        oc=NetState.create(oc, lr_oc), oc_shape=NetState.create(oc_shape, lr_oc_shape))
