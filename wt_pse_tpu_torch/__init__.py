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
cli       ``python -m wt_pse_tpu_torch.cli.train``

The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``wt_pse_tpu``. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; see :func:`wt_pse_tpu_torch.runtime.resolve_device`.
"""

__version__ = "0.1.0"
