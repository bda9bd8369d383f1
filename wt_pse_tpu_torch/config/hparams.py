"""Hyperparameter defaults of the two algorithms, ``WT_PSE`` and
``Unet_nips2023_joint_shape_regularization``, and their seeded random-search
draws — the port's own copy of ``wt_pse_tpu/config/hparams.py``
(``default_hparams``, ``random_hparams``).

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

import numpy as np

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


def random_hparams(algorithm: str, dataset: str = "fundus", seed: int = 0) -> dict:
    """Random-search hparams (the reference's ``hparams_registry.random_hparams``):
    the defaults, with every drawn key replaced by a ``np.random.RandomState(seed)``
    draw, in the registry's order and with its expressions, so a seeded draw
    equals the JAX package's (``wt_pse_tpu/config/hparams.py:127-207``) key
    for key. A constant ``(x, x)`` entry of the registry consumes no draw, and
    the random side is not "defaults plus overrides": the joint variant's
    ``global_metric`` is ``True`` and ``posterior_transform_follow_prior``
    ``True`` (hparams_registry.py:120,146)."""
    rs = np.random.RandomState(seed)
    choice = rs.choice
    hp = default_hparams(algorithm, dataset)

    # the common block (hparams_registry.py:14-24), fundus is not SMALL_IMAGES (32-47)
    hp["eval_steps"] = float(choice([1, 0.1, 0.01]))
    hp["training_fraction"] = float(choice([1, 0.1, 0.01]))
    hp["resnet_dropout"] = float(choice([0.0, 0.1, 0.5]))
    hp["lr_gm"] = float(10 ** rs.uniform(-5, -3.5))
    hp["lr_sc"] = float(10 ** rs.uniform(-5, -3.5))
    hp["batch_size"] = int(2 ** rs.uniform(3, 5.5))
    hp["weight_decay"] = float(10 ** rs.uniform(-6, -2))

    shared = [  # lines 75-93 for WT_PSE; the tail of 97-146 for the joint variant
        ("eval_steps", float, [1, 0.1, 0.01]),
        ("shape_attention_coeffient", float, [1, 0.1, 0.01]),
        ("shape_start", float, [1, 0.1, 0.01]),
        ("shape_weight", float, [1, 0.1, 0.25, 0.75]),
        ("instance_wt_gm", float, [1, 0.1, 0.25, 0.75]),
        ("domain_wt_gm", float, [1, 0.1, 0.25, 0.75]),
        ("instance_wt_sc", float, [1, 0.1, 0.25, 0.75]),
        ("domain_wt_sc", float, [1, 0.1, 0.25, 0.75]),
        ("multi-turn", float, [1, 0.1, 0.25, 0.75]),
        ("sg_type", str, ["oc", "od"]),
        ("whitening_type", str, ["cca", "instance_wt"]),
        ("wt_type_inference", str, ["instance_wt", "instance_wt"]),
    ]
    if algorithm == "WT_PSE":
        draws = shared[:1] + [("margin", float, [1, 0.1, 0.01])] + shared[1:]
    else:
        draws = [
            ("num_mc", int, [1, 1, 1]),
            ("num_monte_carlo", int, [20, 30, 40, 50]),
            ("moped_delta_factor", float, [0.1, 0.2, 0.3]),
            ("bnn_rho_init", float, [-1, -2, -3, -4, -5]),
            ("kl_weight", float, [1, 0.1, 0.5, 0.25, 0.75]),
            ("ce_weight", float, [1, 0.1, 0.5, 0.25, 0.75]),
            ("global_weight", float, [1, 0.1, 0.25, 0.75]),
            ("p_weight1", float, [1, 0.1, 0.25, 0.75]),
            ("classifier", str, ["SGP", "NO"]),
            ("contrastive_type", str, ["contrastive", "triplet", "contrastive_plain"]),
            ("contrastive_type_global", str, ["contrastive", "triplet", "contrastive_plain"]),
            ("margin", float, [1, 0.1, 0.01]),
            ("pairs_number", float, [1, 0.1, 0.01]),
            ("metric_dimension", float, [1, 10, 0.1]),
            ("level2_gamma", float, [1, 10, 0.1]),
            ("level1_gamma_global", float, [1, 0.01, 0.1]),
            ("level1_gamma", float, [1, 0.1, 10]),
            *shared,
            ("CCA_type", str, ["cca_all", "caa_random_2"]),
            ("CCA_transform_type", str, ["ZCA", "CCA"]),
        ]
        hp["global_metric"] = True  # ([True], True): constant, no draw
        hp["posterior_transform_follow_prior"] = True  # (False, True), no draw
    for key, cast, opts in draws:
        hp[key] = cast(choice(opts))
    return hp
