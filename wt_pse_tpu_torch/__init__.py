"""wt_pse_tpu_torch — the PyTorch/CUDA port of ``wt_pse_tpu``.

The JAX package beside it is the reference this package is tested against; the
module layout mirrors it so each counterpart is easy to find:

config    an own copy of the hparam registry defaults the port reads
models    ``nn.Module`` networks in NCHW: U-Net segmenter, DeepWT, shape priors
ops       whitening losses and the hand-written covariance kernels (CUDA C++)
io        weight conversion from the JAX package's variables
train     train state, the 4-phase step and the two-stage predict

The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``wt_pse_tpu``. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; see :func:`wt_pse_tpu_torch.runtime.resolve_device`.
"""

__version__ = "0.1.0"
