"""Hyperparameter defaults for ``WT_PSE`` — the port's own copy of
``wt_pse_tpu/config/hparams.py:17-71`` (``default_hparams("WT_PSE")``).

The full default surface is kept so configs written for the JAX package load
unchanged. Keys the port accepts but ignores:

- ``use_pallas_whitening``: a TPU choice. On CUDA the covariance always runs
  the hand-written kernels (``ops/covariance_cuda.py``).
- ``space_to_depth`` / ``space_to_depth_levels``: a TPU lane layout with the
  same math; the port runs unpacked.
- ``compute_dtype``: only ``None``/``"float32"`` runs in this port so far.
"""

from __future__ import annotations

_COMMON = {
    "eval_steps": 400,
    "training_fraction": 0.8,
    "data_augmentation": True,
    "val_augment": False,
    "resnet18": False,
    "resnet_dropout": 0.5,
    "class_balanced": False,
    "optimizer": "adam",
    "freeze_bn": True,
    "pretrained": True,
    "lr_gm": 1e-3,
    "lr_sc": 1e-3,
    "batch_size": 9,
    "weight_decay": 0.0,
    "compute_dtype": None,
    "space_to_depth": False,
    "space_to_depth_levels": 2,
    "use_pallas_whitening": False,
}

_WT_PSE = {
    "eval_steps": 90,
    "margin": 0,
    "shape_attention": True,
    "shape_prior": True,
    "cat_shape": False,
    "shape_attention_coeffient": 0.3,
    "shape_start": 0.5,
    "whitening": True,
    "shape_weight": 0,
    "instance_wt_gm": 1,
    "domain_wt_gm": 1,
    "instance_wt_sc": 1,
    "domain_wt_sc": 1,
    "multi-turn": 1,
    "sg_type": "oc",
    "whitening_type": "instance_wt",
    "wt_type_inference": "instance_wt",
}

ALGORITHMS = ("WT_PSE",)


def default_hparams(algorithm: str = "WT_PSE", dataset: str = "fundus") -> dict:
    """Default hparams for ``algorithm``; only ``WT_PSE`` is ported so far."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm {algorithm!r} is not ported; have {ALGORITHMS}")
    hp = dict(_COMMON)
    hp.update(_WT_PSE)
    return hp
