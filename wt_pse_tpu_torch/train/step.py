"""The 4-phase WT-PSE training iteration (counterpart of
``wt_pse_tpu/train/step.py::make_train_step``, lines 190-275).

  phase 1  OD seg:      BCE(sigmoid(out), target_od) + whitening losses -> Adam(od)
  phase 2  OD shape KD: teacher (post-phase-1 weights, GT mask) vs student;
                        MSE(mu_t, mu_s) + student whitening -> Adam(od_shape),
                        repeated hparams['multi-turn'] times
  phase 3  OC seg:      ROI = (image+1)*(sigmoid(out_od)>0.75)-1;
                        pos-weighted BCE-with-logits on out_oc*od_pred
                        + whitening -> Adam(oc)
  phase 4  OC shape KD: as phase 2 on the ROI -> Adam(oc_shape)

Order of operations, as in the JAX step:

- the phase-2/4 teacher runs after ``optimizer.step()`` of phase 1/3, in train
  mode under ``torch.no_grad()``, so it updates the main net's BN running
  stats a second time with the same batch;
- the ROI comes from the pre-update phase-1 logits, detached;
- a non-finite ``pos_weight`` becomes 1.0;
- the shape phases run only when ``distill``, whitening and shape_prior are
  all on; ``distill`` is off for the joint variant, whose prior trains inside
  its seg phases, which add the whitening losses over its own DeepWT maps
  when whitening is on (``wt_pse_tpu/train/step.py:65-73,229,260``).

bf16 mode (``compute_dtype='bfloat16'``): the nets return bf16 logits and
maps; the seg, KD and whitening losses are computed in f32 from them (the
covariance kernels take the bf16 maps and return f32), and Adam updates the
f32 parameters. The train Dice and the ROI threshold the sigmoid of the
compute-dtype logits, as the JAX step does; the ROI keeps the image's type
(``step.py:235``).

f64: the batch keeps its type if it is wider than f32 (the JAX step keeps the
batch's dtype, ``step.py:201-204``), so f64 nets (``net.double()``) on an f64
batch run the whole step, losses included, in f64; an f32 or bf16 batch is
taken as f32, as before. Nothing pins f32 by hand: the logits, ``mu`` and
the zero whitening terms are widened to at least f32.

Data parallelism (``StepConfig(..., mesh=...)``, built by ``parallel/dp.py``):
each rank runs this step on its own domain-contiguous share of the global
batch, with nets whose BatchNorm is synchronised over the mesh. Each phase
replaces its net's gradients by their mean over the ranks before
``opt.step()`` (one all-reduce, ``step.py:135,182``); ``pos_weight``'s
numerator and denominator are summed over the ranks before the division
(``step.py:244-248``); the whitening losses gather their MMD vectors. Every
branch that decides whether a collective runs (``wt_feats is None``, the
shape phases, ``multi-turn``) depends on the configuration alone, so every
rank reaches every collective in the same order.

Metrics stay device tensors (f32; f64 in an f64 step): the step makes no
``.item()`` call. Tensors are NCHW; the batch is domain-contiguous (domain d
holds rows ``[d*per_domain_batch, (d+1)*per_domain_batch)``), which the MMD
slicing needs.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from wt_pse_tpu_torch.ops.whitening import main_whitening_loss, student_whitening_loss
from wt_pse_tpu_torch.parallel.collectives import all_reduce_sum, mean_grads_
from wt_pse_tpu_torch.runtime import resolve_device
from wt_pse_tpu_torch.train.state import NetState, WTPSETrainState

# Names of the N(0, 1) draws a caller may inject through ``eps=`` (each
# (B, 1, H, W)); a missing name is drawn from the step's generator. One
# injected draw serves every turn of a multi-turn shape phase.
EPS_KEYS = ("phase1", "phase2.teacher", "phase2.student",
            "phase3", "phase4.teacher", "phase4.student")


def bce_probs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``BCELoss()(sigmoid(x), t)`` in logit space — the JAX form
    (``step.py:46-50``)."""
    return F.binary_cross_entropy_with_logits(logits, targets)


def bce_logits_pos_weight(logits: torch.Tensor, targets: torch.Tensor,
                          pos_weight: torch.Tensor) -> torch.Tensor:
    """``F.binary_cross_entropy_with_logits(x, t, pos_weight=w)``: the mean of
    ``w*t*softplus(-x) + (1-t)*softplus(x)``."""
    return F.binary_cross_entropy_with_logits(logits, targets, pos_weight=pos_weight)


class StepConfig:
    """Python-level configuration of the step (``step.py:53-103``). The hparams
    ``use_pallas_whitening`` and ``space_to_depth`` are accepted and ignored.
    ``distill=False`` (the joint variant) skips the shape phases 2 and 4.
    ``mesh``: the data mesh of a data-parallel step (JAX: ``axis_name`` and
    ``axis_size``), whose size it carries; ``per_domain_batch`` is then this
    rank's share."""

    def __init__(self, hparams: dict, domain_num: int, per_domain_batch: int,
                 replicate_ref_quirks: bool = True, distill: bool = True, mesh=None):
        self.whitening = bool(hparams.get("whitening", True))
        self.shape_prior = bool(hparams.get("shape_prior", True))
        self.distill = distill
        self.instance_wt_gm = float(hparams.get("instance_wt_gm", 1))
        self.domain_wt_gm = float(hparams.get("domain_wt_gm", 1))
        self.margin = float(hparams.get("margin", 0))
        self.multi_turn = int(hparams.get("multi-turn", 1))
        self.domain_num = domain_num
        self.per_domain_batch = per_domain_batch
        self.replicate_ref_quirks = replicate_ref_quirks
        self.mesh = mesh


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least f32: bf16 widens, f32 and f64 stay as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _seg_phase(ns: NetState, image, target, wt_input, seg_loss_fn, cfg: StepConfig,
               eps, generator):
    """One segmentation phase (1 or 3). Returns (detached logits, metrics)."""
    net, opt = ns.net, ns.opt
    net.train()
    opt.zero_grad(set_to_none=True)
    out, _att, wt_feats = net(image, target, wt_input, eps=eps, generator=generator)
    loss_seg = seg_loss_fn(_wide(out))
    if cfg.whitening and wt_feats is not None:
        inst, dom = main_whitening_loss(wt_feats, cfg.domain_num, cfg.per_domain_batch,
                                        cfg.margin, cfg.replicate_ref_quirks, cfg.mesh)
    else:
        inst = dom = torch.zeros((), dtype=loss_seg.dtype, device=out.device)
    total = loss_seg + cfg.instance_wt_gm * inst + cfg.domain_wt_gm * dom
    total.backward()
    if cfg.mesh is not None:
        mean_grads_(net.parameters(), cfg.mesh)
    opt.step()
    out = out.detach()
    # train Dice (smoothed) at the reference's 0.75 threshold
    pred = (torch.sigmoid(out) > 0.75).to(loss_seg.dtype)
    dice = (2.0 * torch.sum(pred * target) + 1.0) / (1.0 + torch.sum(pred)
                                                      + torch.sum(target))
    metrics = {"loss_seg": loss_seg.detach(), "loss_ins_wt": inst.detach(),
               "loss_dom_wt": dom.detach(), "train_dice": dice}
    return out, metrics


def _shape_phase(main: NetState, stud: NetState, image, mask, cfg: StepConfig,
                 eps_teacher, eps_student, generator):
    """One shape-distillation phase (2 or 4), multi-turn times. Returns metrics."""
    metrics = {}
    for _ in range(cfg.multi_turn):
        main.net.train()
        with torch.no_grad():  # teacher: updates BN stats, gradients discarded
            _z_t, mu_t = main.net.teacher_sample(image, mask, eps=eps_teacher,
                                                 generator=generator)
        stud.net.train()
        stud.opt.zero_grad(set_to_none=True)
        _z_s, mu_s, wt_feats = stud.net.update_forward(image, eps=eps_student,
                                                       generator=generator)
        kd = torch.mean(torch.square(_wide(mu_t) - _wide(mu_s)))
        inst_total, inst_ij, inst_ii, dom = student_whitening_loss(
            wt_feats, cfg.domain_num, cfg.per_domain_batch, cfg.margin,
            cfg.replicate_ref_quirks, cfg.mesh)
        total = kd + cfg.instance_wt_gm * inst_total + cfg.domain_wt_gm * dom
        total.backward()
        if cfg.mesh is not None:
            mean_grads_(stud.net.parameters(), cfg.mesh)
        stud.opt.step()
        metrics = {"loss_kd": kd, "loss_ins_wt_shape": inst_total,
                   "loss_ins_wt_shape_ij": inst_ij, "loss_ins_wt_shape_ii": inst_ii,
                   "loss_dom_wt_shape": dom}
    return {k: v.detach() for k, v in metrics.items()}


def _oc_roi(out_od: torch.Tensor, image: torch.Tensor, target_oc: torch.Tensor,
            mesh=None):
    """(od_pred, ROI image, pos_weight) from the detached phase-1 logits; a
    non-finite pos_weight becomes 1.0. With a ``mesh``, the numerator and the
    denominator are the sums over its ranks."""
    od_pred = (torch.sigmoid(out_od) > 0.75).to(image.dtype)
    image_roi = (image + 1.0) * od_pred - 1.0
    num, den = torch.sum(od_pred), torch.sum(od_pred * target_oc)
    if mesh is not None:
        num, den = all_reduce_sum(torch.stack([num, den]), mesh)
    pos_w = num / den
    pos_w = torch.where(torch.isfinite(pos_w), pos_w, torch.ones_like(pos_w))
    return od_pred, image_roi, pos_w


def make_train_step(cfg: StepConfig, *, device: str | torch.device = "cuda"):
    """Build the 4-phase iteration on ``device``.

    Returns ``train_step(state, batch, generator=None, eps=None) -> metrics``.
    ``batch`` holds ``image`` (B, 3, H, W) in [-1, 1] and ``target_od`` /
    ``target_oc`` (B, 1, H, W), as tensors or arrays; they are moved to
    ``device``. ``state`` (on ``device``) is updated in place. ``eps`` maps
    names of :data:`EPS_KEYS` to injected draws; the rest come from
    ``generator`` (a ``torch.Generator`` on ``device``).
    """
    dev = resolve_device(device)
    shape_phases = cfg.distill and cfg.whitening and cfg.shape_prior

    def train_step(state: WTPSETrainState, batch: dict[str, Any],
                   generator: torch.Generator | None = None,
                   eps: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        eps = eps or {}
        image, target_od, target_oc = (
            _wide(torch.as_tensor(batch[k], device=dev))
            for k in ("image", "target_od", "target_oc"))

        # ---- phase 1: OD segmentation ---------------------------------------
        out_od, m1 = _seg_phase(state.od, image, target_od, image,
                                lambda out: bce_probs(out, target_od), cfg,
                                eps.get("phase1"), generator)

        # ---- phase 2: OD shape distillation ---------------------------------
        m2 = {}
        if shape_phases:
            m2 = _shape_phase(state.od, state.od_shape, image, target_od, cfg,
                              eps.get("phase2.teacher"), eps.get("phase2.student"),
                              generator)

        # ---- phase 3: OC segmentation on the OD ROI -------------------------
        od_pred, image_roi, pos_w = _oc_roi(out_od, image, target_oc, cfg.mesh)
        _, m3 = _seg_phase(
            state.oc, image_roi, target_oc, image_roi,
            lambda out: bce_logits_pos_weight(out * od_pred, target_oc, pos_w),
            cfg, eps.get("phase3"), generator)

        # ---- phase 4: OC shape distillation ---------------------------------
        m4 = {}
        if shape_phases:
            m4 = _shape_phase(state.oc, state.oc_shape, image_roi, target_oc, cfg,
                              eps.get("phase4.teacher"), eps.get("phase4.student"),
                              generator)

        metrics = dict(m1)
        metrics.update(m2)
        metrics.update({k + "_oc": v for k, v in m3.items()})
        metrics.update({k + "_oc": v for k, v in m4.items()})
        metrics["pos_weight_oc"] = pos_w
        state.step += 1
        return metrics

    return train_step
