"""Carry one net's weights from the JAX package's Flax variables into the port.

The port's own copy of the mapping in ``wt_pse_tpu/io/checkpoint.py:80-143``
and ``wt_pse_tpu/io/torch_import.py:32-47`` (it imports neither):

- conv kernels HWIO -> OIHW ``weight``; ``bias`` unchanged;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, batch stats
  ``mean``/``var`` -> ``running_mean``/``running_var``, plus a
  ``num_batches_tracked`` of 0 (Flax keeps no such count);
- ``c{k}`` in the 1x1 heads -> ``nn.Sequential`` index ``2k``;
- DoubleConv children ``conv1/bn1/conv2/bn2`` -> ``double_conv.{0,1,3,4}``
  and DoubleConvWT children ``conv1/conv2`` -> ``double_conv.{0,2}``.

The block kinds are read from the tree, so one mapping serves every net of
either algorithm: ``WTPSE``, ``ShapeStudent`` and the joint variant's
``JointShapeReg``, whose ``prior_dist`` is a student without a ``wt_model``
(``tests/test_torch_joint.py`` loads its converted tree strictly).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_SEQ_HEADS = ("mu", "outc", "mu_prior", "logvar_prior", "fusion")
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` nested dicts of arrays -> a
    ``state_dict`` that the port's net loads with ``load_state_dict(strict=True)``."""
    leaves = []  # (collection, module path, leaf name, array)
    for coll in ("params", "batch_stats"):
        for (*mods, leaf), arr in _flatten(variables.get(coll, {})).items():
            leaves.append((coll, tuple(mods), leaf, arr))

    # Block kinds, inferred from the tree: ConvD/ConvU own a conv3 and keep
    # their names; of the other parents of conv1..bn2, a bn1 marks DoubleConv
    parents_conv3 = {m[:-1] for _, m, _, _ in leaves if m and m[-1] == "conv3"}
    parents_bn1 = {m[:-1] for _, m, _, _ in leaves if m and m[-1] == "bn1"}

    out: dict[str, torch.Tensor] = {}
    bn_modules = set()
    for coll, mods, leaf, arr in leaves:
        parts = list(mods)
        parent, child = tuple(parts[:-1]), parts[-1] if parts else ""
        if len(parts) >= 2 and parts[-2] in _SEQ_HEADS and re.fullmatch(r"c\d+", child):
            parts[-1] = str(2 * int(child[1:]))
        elif child in ("conv1", "bn1", "conv2", "bn2") and parent not in parents_conv3:
            dc = parent in parents_bn1
            idx = {"conv1": "0", "bn1": "1", "conv2": "3" if dc else "2", "bn2": "4"}[child]
            parts[-1:] = ["double_conv", idx]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if leaf == "scale":
            bn_modules.add(".".join(parts))
        key = ".".join(parts + [_LEAF[(coll, leaf)]])
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    for m in sorted(bn_modules):
        out[f"{m}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out
