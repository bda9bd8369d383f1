"""Core layer library (PyTorch, NCHW) — counterpart of ``wt_pse_tpu/models/layers.py``.

Module and child names follow the reference's ``state_dict`` (as
``tests/torch_ref.py`` does), so a reference ``.pth.tar`` loads with a plain
``load_state_dict``: DoubleConv children are ``double_conv.{0,1,3,4}``,
DoubleConvWT children ``double_conv.{0,2}``, and the 1x1 heads are
``nn.Sequential`` with convs at indices ``0, 2, 4``.

BatchNorm is ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1, unbiased variance in
the running estimate) and the 2x upsample is ``F.interpolate(bilinear,
align_corners=False)`` — the reference's own ops, which the JAX package
re-implements for parity.

Parameters are initialised the way the JAX package's Flax modules initialise
them (:func:`init_like_flax_`), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax.linen.initializers.lecun_normal: truncated normal on [-2, 2] standard
# deviations, rescaled by this constant so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 same-padding conv with bias (reference convs are all bias=True)."""
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=True)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, 1, 0, bias=True)


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw ``module``'s parameters as Flax initialises them: conv kernels
    lecun-normal (truncated normal, variance 1/fan_in), biases zero, BatchNorm
    scale one / shift zero, running mean zero / variance one. Draws happen on
    the CPU, in module order, so a seed gives the same weights on any device."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module


class ConvD(nn.Module):
    """Encoder block: [maxpool if not first] -> conv/bn -> conv/bn/act -> conv/bn/act.
    No activation after bn1 (``wt_pse_tpu/models/layers.py:282-283``)."""

    def __init__(self, cin: int, planes: int, first: bool = False):
        super().__init__()
        self.first = first
        self.conv1, self.bn1 = conv3x3(cin, planes), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = conv3x3(planes, planes), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = conv3x3(planes, planes), nn.BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = F.max_pool2d(x, 2)
        x = self.bn1(self.conv1(x))
        y = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(y)))


class ConvU(nn.Module):
    """Decoder block: [conv/bn/act if not first] -> up2x -> 1x1 conv/bn/act ->
    concat ``[prev, y]`` -> conv/bn/act (``layers.py:292-339``). The input has
    ``planes`` channels when first, else ``2 * planes``."""

    def __init__(self, planes: int, first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.conv1, self.bn1 = conv3x3(2 * planes, planes), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = conv1x1(planes, planes // 2), nn.BatchNorm2d(planes // 2)
        self.conv3, self.bn3 = conv3x3(planes, planes), nn.BatchNorm2d(planes)

    def forward(self, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        if not self.first:
            x = F.relu(self.bn1(self.conv1(x)))
        y = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        y = F.relu(self.bn2(self.conv2(y)))
        y = torch.cat([prev, y], dim=1)
        return F.relu(self.bn3(self.conv3(y)))


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2 (``layers.py:342-356``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            conv3x3(cin, features), nn.BatchNorm2d(features), nn.ReLU(),
            conv3x3(features, features), nn.BatchNorm2d(features), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class DoubleConvWT(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, no normalisation (``layers.py:359-372``).
    The output is pre-activation so the covariance loss sees the raw map."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            conv3x3(cin, features), nn.ReLU(), conv3x3(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class ConvStack1x1(nn.Sequential):
    """A stack of 1x1 convs with ReLU between (not after) — the ``mu`` /
    ``mu_prior`` / ``logvar_prior`` / ``outc`` / ``fusion`` heads
    (``layers.py:375-390``); convs sit at Sequential indices 0, 2, 4, ..."""

    def __init__(self, cin: int, features: Sequence[int]):
        mods: list[nn.Module] = []
        for i, f in enumerate(features):
            if i > 0:
                mods.append(nn.ReLU())
            mods.append(conv1x1(cin, f))
            cin = f
        super().__init__(*mods)


class AttentionLayer(nn.Module):
    """1x1 conv + sigmoid gate (``layers.py:393-404``). Returns
    (sigmoid(logits), logits)."""

    def __init__(self, cin: int = 1, features: int = 1):
        super().__init__()
        self.layer1 = conv1x1(cin, features)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        logits = self.layer1(x)
        return torch.sigmoid(logits), logits
