"""Teacher and student variational shape priors
(counterpart of ``wt_pse_tpu/models/shape_prior.py``).

Sampling semantics (both trained into the released checkpoint):

- teacher: textbook reparameterisation ``z = mu + exp(logvar/2) * eps``, no
  NaN scrubbing (``shape_prior.py:89-93``);
- student: ``mu`` and ``std`` go through ``nan_to_num``, then the quirk
  ``z = (mu + std*eps) * std + mu`` (``shape_prior.py:152-160``).

Every draw takes an injected ``eps`` or an explicit ``torch.Generator``, and
the scrubs, the draw and the reparameterisations are in the compute dtype
(``shape_prior.py:89-93,152-160``). Train/eval mode is the module's own
``training`` flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wt_pse_tpu_torch.models.common import ModelConfig, normal_like, place, unet_run
from wt_pse_tpu_torch.models.deepwt import DeepWT
from wt_pse_tpu_torch.models.layers import ConvD, ConvStack1x1, ConvU, DoubleConv


def _trunk(m: nn.Module, n: int, dt: torch.dtype | None) -> None:
    m.down1 = ConvD(n, 2 * n, dtype=dt)
    m.down2 = ConvD(2 * n, 4 * n, dtype=dt)
    m.down3 = ConvD(4 * n, 8 * n, dtype=dt)
    m.down4 = ConvD(8 * n, 16 * n, dtype=dt)
    m.up1 = ConvU(16 * n, first=True, dtype=dt)
    m.up2 = ConvU(8 * n, dtype=dt)
    m.up3 = ConvU(4 * n, dtype=dt)
    m.up4 = ConvU(2 * n, dtype=dt)
    m.mu_prior = ConvStack1x1(2 * n, [2 * n, 8, 1], dt)
    m.logvar_prior = ConvStack1x1(2 * n, [2 * n, 8, 1], dt)


class TeacherShapePrior(nn.Module):
    """Mask-conditioned prior over the DeepWT features ``inputs``.

    With ``whitening`` the mask goes through ``inc`` (DoubleConv 1->n) and is
    fused with the n-channel features by a 1x1 conv + ReLU; otherwise mask and
    image are concatenated before ``inc``.
    """

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        n, dt = cfg.base_width, cfg.dtype
        if cfg.whitening:  # the mask has one channel
            self.inc = DoubleConv(1, n, dt)
            self.fusion = ConvStack1x1(2 * n, [n], dt)
        else:
            self.inc = DoubleConv(1 + cfg.n_channels, n, dt)
        _trunk(self, n, dt)
        place(self, device, generator, cfg.bn_mesh)

    def extract(self, inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.cfg.whitening:
            x1 = torch.cat([self.inc(mask), inputs], dim=1)
            x1 = F.relu(self.fusion(x1))
        else:
            x1 = self.inc(torch.cat([mask, inputs], dim=1))
        return unet_run(self, x1)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor, sample: bool = True,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(z, mu) when sampling (training path) else mu."""
        fm = self.extract(inputs, mask)
        mu = self.mu_prior(fm)
        if not sample:
            return mu
        std = torch.exp(self.logvar_prior(fm) / 2)
        return mu + std * normal_like(std, eps, generator), mu


class ShapeStudent(nn.Module):
    """Test-time shape net over its own DeepWT features (no mask input).

    ``own_wt=False`` builds it without a ``wt_model``: the joint variant's
    x-conditioned prior reads the DeepWT maps of the net that owns it, and
    the JAX ``JointShapeReg`` creates no ``prior_dist.wt_model`` parameters
    (``wt_pse_tpu/models/joint.py:96-100``)."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, own_wt: bool = True):
        super().__init__()
        self.cfg = cfg
        n, dt = cfg.base_width, cfg.dtype
        if own_wt:
            self.wt_model = DeepWT(cfg.n_channels, n, whitening=cfg.whitening, dtype=dt)
        if not cfg.whitening:
            self.inc = DoubleConv(cfg.n_channels, n, dt)
        _trunk(self, n, dt)
        place(self, device, generator, cfg.bn_mesh)

    def extract(self, inputs: torch.Tensor) -> torch.Tensor:
        x1 = inputs if self.cfg.whitening else self.inc(inputs)
        return unet_run(self, x1)

    def forward(self, inputs: torch.Tensor, sample: bool = True,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(z, mu) when sampling else the scrubbed mu."""
        fm = self.extract(inputs)
        mu = torch.nan_to_num(self.mu_prior(fm))
        if not sample:
            return mu
        std = torch.nan_to_num(torch.exp(self.logvar_prior(fm) / 2))
        sampled_z = mu + std * normal_like(std, eps, generator)
        return sampled_z * std + mu, mu  # deliberate reference quirk

    def sample_from_image(self, image: torch.Tensor) -> torch.Tensor:
        """wt_model -> trunk -> mu, the full student inference path."""
        return self(self.wt_model(image)[-1], sample=False)

    def update_forward(self, image: torch.Tensor, eps: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """The student half of the distillation step: own DeepWT -> trunk ->
        sampled (z, mu). Returns (z, mu, wt_feats) so the caller can take the
        student whitening losses on wt_feats[0:2]."""
        feats = self.wt_model(image)
        x = feats[-1] if self.cfg.whitening else image
        z, mu = self(x, sample=True, eps=eps, generator=generator)
        return z, mu, feats
