"""The joint (non-distilled) shape-regularization variant (counterpart of
``wt_pse_tpu/models/joint.py``).

Reference: ``Unet_nips2023_joint_shape_regularization`` (the reference's
``algorithms.py:1357-1657``; selected with ``--algorithm
Unet_nips2023_joint_shape_regularization``, dispatched at
``Trainer.py:1032-1035``): the WT-PSE U-Net and embedding head, but the shape
prior is one x-conditioned net (no mask-conditioned teacher, no distilled
student), sampled while training and taken at its mean at test time. Its
hparams block turns the whitening losses off (``hparams_registry.py:126-131``);
with ``whitening=True`` the seg phases add them over this net's own DeepWT
maps.

**Reference breakage, repaired here (documented, not replicated):** as
shipped, the reference class cannot run — ``ShapeVariationalDist_x`` is an
undefined name inside ``algorithms.py`` (it lives only in
``shape_networks.py`` and is never imported; construction raises
``NameError``, ``algorithms.py:1416``), and even with the import fixed the
call ``sample_forward(feats, None, training=True)`` passes three arguments to
a two-parameter method (``algorithms.py:1473``). The intent is unambiguous
from the surrounding code: an x-only prior sampled with the quirk
reparameterisation (``algorithms.py:1435-1440``) gating the embedding through
the shared attention layer. That is what the JAX package and this module
implement.

State_dict names are the reference's (``inc``, ``down1..4``, ``up1..4``,
``wt_model``, ``prior_dist``, ``attention_layer``, ``mu``, ``outc``). The
prior (``prior_dist``, a :class:`ShapeStudent` without a ``wt_model`` of its
own) reads this net's DeepWT maps, or the image when whitening is off, as
the JAX module's does; its children exist exactly where the JAX module
creates parameters, so a converted JAX tree loads strictly.
"""

from __future__ import annotations

import torch
from torch import nn

from wt_pse_tpu_torch.models.common import ModelConfig, attention_fuse, place, unet_run
from wt_pse_tpu_torch.models.deepwt import DeepWT
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import seg_heads, seg_trunk


class JointShapeReg(nn.Module):
    """U-Net segmenter with a jointly trained x-conditioned shape prior."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        seg_trunk(self, cfg)
        if cfg.shape_prior:
            self.wt_model = DeepWT(cfg.n_channels, cfg.base_width, whitening=cfg.whitening,
                                   dtype=cfg.dtype)
            # placed on the CPU here; the whole net is initialised and moved below
            self.prior_dist = ShapeStudent(cfg, device="cpu", generator=generator,
                                           own_wt=False)
        seg_heads(self, cfg)
        place(self, device, generator)

    def embed(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.mu(unet_run(self, self.inc(inputs)))

    def _fuse(self, embedding: torch.Tensor, z: torch.Tensor):
        return attention_fuse(self.cfg, getattr(self, "attention_layer", None), embedding, z)

    def _prior_input(self, wt_inputs: torch.Tensor):
        """(DeepWT maps, the prior's input): the last map, or the image
        itself when whitening is off (``joint.py:98``)."""
        wt_feats = self.wt_model(wt_inputs)
        return wt_feats, (wt_feats[-1] if self.cfg.whitening else wt_inputs)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, wt_inputs: torch.Tensor,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """Training forward, with :class:`WTPSE`'s signature. ``mask`` is
        ignored: the prior is x-conditioned only. Returns (logits,
        attention>0.75 mask or None, wt feature list or None); the caller
        takes the whitening losses over the wt features when whitening is on."""
        del mask
        embedding = self.embed(inputs)
        att_mask = None
        wt_feats = None
        if self.cfg.shape_prior:
            wt_feats, x = self._prior_input(wt_inputs)
            z, _mu = self.prior_dist(x, sample=True, eps=eps, generator=generator)
            embedding, att = self._fuse(embedding, z)
            if att is not None:
                att_mask = (att > 0.75).float()
        return self.outc(embedding), att_mask, wt_feats

    def predict(self, inputs: torch.Tensor,
                wt_inputs: torch.Tensor | None = None) -> torch.Tensor:
        """Eval forward: the prior's mean (no draw), the same fusion."""
        wt_inputs = inputs if wt_inputs is None else wt_inputs
        embedding = self.embed(inputs)
        if self.cfg.shape_prior:
            _, x = self._prior_input(wt_inputs)
            embedding, _ = self._fuse(embedding, self.prior_dist(x, sample=False))
        return self.outc(embedding)
