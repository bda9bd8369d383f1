"""The WT-PSE segmentation network (counterpart of ``wt_pse_tpu/models/wt_pse.py``).

5-level ConvD/ConvU U-Net + 8-dim 1x1 embedding head ``mu`` + 1x1 ``outc``; a
DeepWT front-end feeds a mask-conditioned teacher shape prior whose sample
gates the embedding through a sigmoid attention layer:

    fuse = coef * embedding + attention(z) * embedding      (algorithms.py:1248-1249)

Children exist exactly where the JAX module creates parameters, so a converted
JAX variable tree loads with ``load_state_dict(strict=True)``: ``wt_model``,
``prior_dist`` and ``attention_layer`` only under ``shape_prior`` (the last
also needs ``shape_attention``).
"""

from __future__ import annotations

import torch
from torch import nn

from wt_pse_tpu_torch.models.common import ModelConfig, attention_fuse, place, unet_run
from wt_pse_tpu_torch.models.deepwt import DeepWT
from wt_pse_tpu_torch.models.layers import AttentionLayer, ConvD, ConvStack1x1, ConvU
from wt_pse_tpu_torch.models.shape_prior import TeacherShapePrior


def seg_trunk(m: nn.Module, cfg: ModelConfig) -> None:
    """The segmentation U-Net's blocks (``inc``, ``down1..4``, ``up1..4``),
    shared by :class:`WTPSE` and the joint variant."""
    n, dt = cfg.base_width, cfg.dtype
    m.inc = ConvD(cfg.n_channels, n, first=True, dtype=dt)
    m.down1 = ConvD(n, 2 * n, dtype=dt)
    m.down2 = ConvD(2 * n, 4 * n, dtype=dt)
    m.down3 = ConvD(4 * n, 8 * n, dtype=dt)
    m.down4 = ConvD(8 * n, 16 * n, dtype=dt)
    m.up1 = ConvU(16 * n, first=True, dtype=dt)
    m.up2 = ConvU(8 * n, dtype=dt)
    m.up3 = ConvU(4 * n, dtype=dt)
    m.up4 = ConvU(2 * n, dtype=dt)


def seg_heads(m: nn.Module, cfg: ModelConfig) -> None:
    """The attention gate (under ``shape_prior`` and ``shape_attention``), the
    embedding head ``mu`` and ``outc``, in the order the state_dict lists them."""
    n, dt = cfg.base_width, cfg.dtype
    if cfg.shape_prior and cfg.shape_attention:
        m.attention_layer = AttentionLayer(1, 1, dt)
    m.mu = ConvStack1x1(2 * n, [2 * n, cfg.feature_dim], dt)
    fused = cfg.feature_dim + (1 if cfg.shape_prior and cfg.cat_shape else 0)
    m.outc = ConvStack1x1(fused, [cfg.n_classes], dt)


class WTPSE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        seg_trunk(self, cfg)
        if cfg.shape_prior:
            self.wt_model = DeepWT(cfg.n_channels, cfg.base_width, whitening=cfg.whitening,
                                   dtype=cfg.dtype)
            # placed on the CPU here; the whole net is initialised and moved below
            self.prior_dist = TeacherShapePrior(cfg, device="cpu", generator=generator)
        seg_heads(self, cfg)
        place(self, device, generator, cfg.bn_mesh)

    def embed(self, inputs: torch.Tensor) -> torch.Tensor:
        """U-Net trunk -> 8-dim embedding (algorithms.py:1218-1227)."""
        return self.mu(unet_run(self, self.inc(inputs)))

    def _fuse(self, embedding: torch.Tensor, z_posterior: torch.Tensor):
        return attention_fuse(self.cfg, getattr(self, "attention_layer", None),
                              embedding, z_posterior)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, wt_inputs: torch.Tensor,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """Training forward. ``wt_inputs`` is the image fed to the DeepWT
        front-end. Returns (logits, attention>0.75 mask or None, wt feature
        list or None)."""
        embedding = self.embed(inputs)
        att_mask = None
        wt_feats = None
        if self.cfg.shape_prior:
            wt_feats = self.wt_model(wt_inputs)
            z_posterior, _ = self.prior_dist(wt_feats[-1], mask, sample=True,
                                             eps=eps, generator=generator)
            embedding, att = self._fuse(embedding, z_posterior)
            if att is not None:
                att_mask = (att > 0.75).float()
        return self.outc(embedding), att_mask, wt_feats

    def predict_with_shape(self, inputs: torch.Tensor,
                           z_posterior: torch.Tensor) -> torch.Tensor:
        """Eval forward given the student's shape sample."""
        embedding = self.embed(inputs)
        if self.cfg.shape_prior:
            embedding, _ = self._fuse(embedding, z_posterior)
        return self.outc(embedding)

    def predict_no_shape(self, inputs: torch.Tensor) -> torch.Tensor:
        """Eval forward with shape_prior disabled (seg-only configuration)."""
        return self.outc(self.embed(inputs))

    def teacher_sample(self, wt_inputs: torch.Tensor, mask: torch.Tensor,
                       eps: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """DeepWT + teacher sample, used inside the student update. Returns
        (z, mu)."""
        wt_feats = self.wt_model(wt_inputs)
        return self.prior_dist(wt_feats[-1], mask, sample=True, eps=eps,
                               generator=generator)
