"""DeepWT whitening front-end (counterpart of ``wt_pse_tpu/models/deepwt.py``).

Two un-normalised DoubleConvWT blocks; returns the three maps the whitening
loss and the shape nets consume: ``[z1, z2, relu(z2)]``. ``z1`` and ``z2`` are
saved by the covariance ``autograd.Function``, so nothing here (or in a
caller) may modify them in place. With ``whitening=False`` it returns ``[x]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wt_pse_tpu_torch.models.layers import DoubleConvWT


class DeepWT(nn.Module):
    def __init__(self, cin: int = 3, features: int = 16, whitening: bool = True):
        super().__init__()
        self.whitening = whitening
        if whitening:
            self.DoubleConv = DoubleConvWT(cin, features)
            self.DoubleConv2 = DoubleConvWT(features, features)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if not self.whitening:
            return [x]
        z1 = self.DoubleConv(x)
        z2 = self.DoubleConv2(F.relu(z1))
        return [z1, z2, F.relu(z2)]
