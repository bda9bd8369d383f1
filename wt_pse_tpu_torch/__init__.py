"""wt_pse_tpu_torch — the PyTorch/CUDA port of ``wt_pse_tpu``.

The JAX package beside it is the reference this package is tested against; the
module layout mirrors it so each counterpart is easy to find:

config    own copies of the hparam registry defaults and the config loader
data      the Fundus loader; sampling and augmentation on the device
models    ``nn.Module`` networks in NCHW: U-Net segmenter, DeepWT, shape priors
ops       whitening losses, the hand-written covariance kernels (CUDA C++),
          metrics and post-processing
io        weight conversion from the JAX package's variables; checkpoints
train     train state, the 4-phase step, the two-stage predict and its
          evaluation, the LR schedule and the Trainer
utils     run logging, seeding, the code snapshot and the validation montage
parallel  data parallelism across ranks, sharded inference, the sweep
cli       ``python -m wt_pse_tpu_torch.cli.{train,test_visualization,sweep}``

The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``wt_pse_tpu``. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; see :func:`wt_pse_tpu_torch.runtime.resolve_device`.
"""

__version__ = "0.1.0"

_API = {
    "Trainer": ("wt_pse_tpu_torch.train.trainer", "Trainer"),
    "WTPSE": ("wt_pse_tpu_torch.models.wt_pse", "WTPSE"),
    "ShapeStudent": ("wt_pse_tpu_torch.models.shape_prior", "ShapeStudent"),
    "TeacherShapePrior": ("wt_pse_tpu_torch.models.shape_prior", "TeacherShapePrior"),
    "JointShapeReg": ("wt_pse_tpu_torch.models.joint", "JointShapeReg"),
    "ModelConfig": ("wt_pse_tpu_torch.models.common", "ModelConfig"),
    "load_fundus": ("wt_pse_tpu_torch.data.fundus", "load_fundus"),
    "load_train_domains": ("wt_pse_tpu_torch.data.fundus", "load_train_domains"),
    "default_hparams": ("wt_pse_tpu_torch.config", "default_hparams"),
    "load_config": ("wt_pse_tpu_torch.config", "load_config"),
    "load_reference_checkpoint": ("wt_pse_tpu_torch.io.checkpoint", "load_reference_checkpoint"),
    "load_predictor": ("wt_pse_tpu_torch.api", "load_predictor"),
    "Predictor": ("wt_pse_tpu_torch.api", "Predictor"),
}


def __getattr__(name):
    """The top-level API, imported at first use (the JAX package's 13 names,
    ``wt_pse_tpu/__init__.py:33-56``): ``import wt_pse_tpu_torch`` imports no
    module of the port."""
    if name in _API:
        import importlib

        mod, attr = _API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
