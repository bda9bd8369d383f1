"""Determinism utilities (counterpart of ``wt_pse_tpu/utils/seed.py``).

Seeds python's, numpy's and torch's global generators. The port's own draws
(weights, sampling, augmentation, the step's N(0, 1) draws) come from explicit
``torch.Generator`` objects that the Trainer seeds itself, so this covers only
code that reads the global generators.

``torch.backends.cudnn.deterministic`` and ``cudnn.benchmark`` are left as
they are: either would change which convolution algorithms cuDNN picks, and
so the step whose time the port measures.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_initialization(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
