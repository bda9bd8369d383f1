"""Hyperparameter defaults of the two algorithms, ``WT_PSE`` and
``Unet_nips2023_joint_shape_regularization`` — the port's own copy of
``wt_pse_tpu/config/hparams.py:17-124`` (``default_hparams``).

The full default surface is kept so configs written for the JAX package load
unchanged. ``compute_dtype`` is ``None``/``"float32"`` (f32) or
``"bfloat16"`` (mixed precision, ``models/layers.py``). Keys the port accepts
but ignores:

- ``use_pallas_whitening``: a TPU choice. On CUDA the covariance always runs
  the hand-written kernels (``ops/covariance_cuda.py``).
- ``space_to_depth`` / ``space_to_depth_levels``: a TPU lane layout with the
  same math; the port runs unpacked.
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

_JOINT = {
    "num_mc": 10,
    "num_monte_carlo": 40,
    "moped_delta_factor": 0.1,
    "bnn_rho_init": -3,
    "kl_weight": 1,
    "ce_weight": 1,
    "global_weight": 0.1,
    "p_weight1": 2,
    "classifier": "SGP",
    "contrastive_type": "contrastive_plain_v2_segmentation",
    "contrastive_type_global": "contrastive_plain_v2_segmentation",
    "margin": 0,
    "pairs_number": 200,
    "global_loss": False,
    "global_metric": [True],
    "metric_dimension": 8,
    "level2_gamma": [1],
    "level1_gamma_global": [1],
    "level1_gamma": [1],
    "eval_steps": 90,
    "shape_attention": True,
    "shape_prior": True,
    "cat_shape": False,
    "shape_attention_coeffient": 0,
    "shape_start": 0.5,
    "whitening": False,
    "shape_weight": 0,
    "instance_wt_gm": 0,
    "domain_wt_gm": 0,
    "instance_wt_sc": 0,
    "domain_wt_sc": 0,
    "multi-turn": 1,
    "sg_type": "oc",
    "whitening_type": "instance_wt",
    "wt_type_inference": "instance_wt",
    "CCA_type": "cca_all",
    "CCA_transform_type": "ZCA",
    "posterior_transform_follow_prior": False,
}

JOINT = "Unet_nips2023_joint_shape_regularization"
ALGORITHMS = ("WT_PSE", JOINT)
COMPUTE_DTYPES = (None, "float32", "bfloat16")


def default_hparams(algorithm: str = "WT_PSE", dataset: str = "fundus") -> dict:
    """Default hparams for ``algorithm``, one of :data:`ALGORITHMS`."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; have {ALGORITHMS}")
    hp = dict(_COMMON)
    hp.update(_WT_PSE if algorithm == "WT_PSE" else _JOINT)
    return hp
