"""Training state (counterpart of ``wt_pse_tpu/train/state.py``).

Four disjoint nets, each with its own Adam (``betas=(0.9, 0.99)``, eps 1e-8,
the reference's ``train.py:120-138``). Unlike the JAX pytree, the state is
mutable: the step updates the nets and optimizers in place. The parameters
are f32 in either compute dtype (Adam updates f32 master weights).

A step that a CUDA graph replays (``train/graph.py``) needs Adams that a
graph can hold: ``capturable=True``, the lr a 0-d tensor on the parameters'
device, and the state created before capture (:func:`init_adam_state`).
Such an Adam computes its bias corrections in f32 on the device, as optax
does, where the eager one computes them in Python floats: the two differ in
the last ulps of an update. Whatever holds a captured tensor is updated in
place (:func:`copy_state_`, :func:`load_adam_state_`, :func:`set_lr_`),
never rebound: a graph keeps writing the storage it captured.
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


# the param-group key that keeps the float a tensor lr was last filled from:
# the f32 tensor rounds it, and a checkpoint writes the float
LR_FLOAT = "lr_float"


def reference_adam(params, lr: float, capturable: bool = False) -> torch.optim.Adam:
    """``torch.optim.Adam(lr, betas=(0.9, 0.99), eps=1e-8)``. With
    ``capturable`` the Adam a CUDA graph can hold: ``capturable=True`` and
    ``lr`` as a 0-d f32 tensor on the parameters' device (its float kept
    under ``LR_FLOAT``)."""
    params = list(params)
    if not capturable:
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-8)
    opt = torch.optim.Adam(params, lr=torch.tensor(float(lr), device=params[0].device),
                           betas=(0.9, 0.99), eps=1e-8, capturable=True)
    for g in opt.param_groups:
        g[LR_FLOAT] = float(lr)
    return opt


def init_adam_state(opt: torch.optim.Adam, params) -> None:
    """Create the state of ``params`` in ``opt`` as Adam's first step would
    (zero ``exp_avg`` and ``exp_avg_sq``, a zero f32 ``step``: on the
    parameter's device for a capturable Adam, on the CPU otherwise), without
    taking a step; a parameter that has state keeps it. A graph captured
    afterwards finds the state there instead of creating it inside the
    capture."""
    capturable = _is_capturable(opt)
    for p in params:
        st = opt.state[p]
        if st:
            continue
        st["step"] = torch.zeros((), dtype=torch.float32,
                                 device=p.device if capturable else "cpu")
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _params(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    """The parameters of ``opt`` in the order of its ``state_dict`` ids."""
    return [p for g in opt.param_groups for p in g["params"]]


def _is_capturable(opt: torch.optim.Optimizer) -> bool:
    return any(g.get("capturable", False) for g in opt.param_groups)


def adam_state_for_file(opt: torch.optim.Adam) -> dict:
    """``opt.state_dict()`` in the layout an eager Adam writes, the
    reference's: each group's ``lr`` the float it was set to and
    ``capturable`` False, each ``step`` a CPU tensor. A file written from a
    capturable Adam then loads into an eager one as if an eager run had
    written it; an eager Adam's dict comes back unchanged."""
    sd = opt.state_dict()
    groups = []
    for g in sd["param_groups"]:
        g = dict(g, capturable=False)
        g["lr"] = g.pop(LR_FLOAT, g["lr"])
        groups.append(g)
    return {"state": {i: dict(s, step=s["step"].detach().cpu())
                      for i, s in sd["state"].items()},
            "param_groups": groups}


def load_adam_state_(opt: torch.optim.Adam, saved: dict) -> None:
    """Load an Adam state_dict ``saved`` into ``opt``. An eager Adam takes it
    through ``load_state_dict``. A capturable one keeps its tensors and its
    flags: each state tensor is copied into the one it holds (created first
    where missing) and each group's ``lr`` tensor is filled with the saved
    value, so a graph that captured them reads the loaded values."""
    if not _is_capturable(opt):
        opt.load_state_dict(saved)
        return
    params = _params(opt)
    groups = saved["param_groups"]
    if len(groups) != len(opt.param_groups) or any(
            len(g["params"]) != len(s["params"]) for g, s in zip(opt.param_groups, groups)):
        raise ValueError("the saved optimizer state has another parameter layout")
    with torch.no_grad():
        for g, s in zip(opt.param_groups, groups):
            set_lr_(g, float(s["lr"]))
        for i, st in saved["state"].items():
            p = params[i]
            init_adam_state(opt, [p])
            for k, v in st.items():
                opt.state[p][k].copy_(v)


def set_lr_(opt: torch.optim.Optimizer | dict, lr: float) -> None:
    """Set the lr of every group of ``opt`` (or of one param group): a
    tensor lr (a capturable Adam) is filled in place, a float one
    replaced."""
    for g in [opt] if isinstance(opt, dict) else opt.param_groups:
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].fill_(lr)
            g[LR_FLOAT] = lr
        else:
            g["lr"] = lr


@dataclasses.dataclass
class NetState:
    net: nn.Module
    opt: torch.optim.Optimizer

    @classmethod
    def create(cls, net: nn.Module, lr: float, capturable: bool = False) -> "NetState":
        return cls(net=net, opt=reference_adam(net.parameters(), lr, capturable))


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


@torch.no_grad()
def copy_state_(dst: WTPSETrainState, src: WTPSETrainState) -> None:
    """Make ``dst`` hold the values of ``src`` (a copy of it, e.g. from
    ``copy.deepcopy``) without rebinding any of its tensors: each net's
    parameters and buffers, each optimizer's state and tensor lr are copied
    in place, the step count assigned. A CUDA graph captured on ``dst``
    reads the copied values."""
    for d, s in zip(dst.net_states(), src.net_states()):
        for t, v in zip(d.net.state_dict().values(), s.net.state_dict().values()):
            t.copy_(v)
        d_params, s_params = _params(d.opt), _params(s.opt)
        if [p in d.opt.state for p in d_params] != [p in s.opt.state for p in s_params]:
            raise ValueError("the two optimizers hold state for other parameters")
        for p, q in zip(d_params, s_params):
            for k, v in s.opt.state.get(q, {}).items():
                d.opt.state[p][k].copy_(v)
        for g, h in zip(d.opt.param_groups, s.opt.param_groups):
            set_lr_(g, h.get(LR_FLOAT, h["lr"]))
    dst.step = src.step


def init_ensemble(cfg: ModelConfig, *, device: str | torch.device = "cuda",
                  generator: torch.Generator | None = None,
                  lr_od: float = 5e-4, lr_od_shape: float = 5e-4,
                  lr_oc: float = 5e-4, lr_oc_shape: float = 5e-4,
                  algorithm: str = "WT_PSE", capturable: bool = False) -> WTPSETrainState:
    """Build all four nets with Flax-style initial weights drawn in the order
    od, od_shape, oc, oc_shape from ``generator`` (seed 0 when omitted), on
    ``device``, each with its Adam (a capturable one with ``capturable``, for
    a step that a CUDA graph replays). Default learning rates match
    train.py:197-200.
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
        od=NetState.create(od, lr_od, capturable),
        od_shape=NetState.create(od_shape, lr_od_shape, capturable),
        oc=NetState.create(oc, lr_oc, capturable),
        oc_shape=NetState.create(oc_shape, lr_oc_shape, capturable))
