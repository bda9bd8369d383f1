"""Shared model configuration and the U-Net trunk runner
(counterpart of ``wt_pse_tpu/models/common.py:14-114``, unpacked layout only:
the ``space_to_depth*`` hparams, a TPU lane layout with the same math, are
ignored)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from wt_pse_tpu_torch.config.hparams import COMPUTE_DTYPES
from wt_pse_tpu_torch.models.layers import BatchNorm2d, init_like_flax_
from wt_pse_tpu_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_channels: int = 3
    n_classes: int = 1
    base_width: int = 16  # 'n' in the reference
    feature_dim: int = 8
    shape_prior: bool = True
    shape_attention: bool = True
    cat_shape: bool = False
    shape_attention_coeffient: float = 0.3
    whitening: bool = True
    # None (f32) or 'bfloat16': mixed-precision training, bf16 convs from f32
    # master weights, f32 BatchNorm statistics and losses (hparam
    # `compute_dtype`; the policy is in models/layers.py)
    compute_dtype: str | None = None
    # the data mesh whose ranks the BatchNorm layers synchronise over (sync
    # BN; JAX: `bn_axis_name`), or None: set only by data-parallel training
    # (parallel/dp.py)
    bn_mesh: object | None = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def dtype(self) -> torch.dtype | None:
        """The torch type the convs compute in; ``None`` for f32."""
        return None if self.compute_dtype is None else getattr(torch, self.compute_dtype)

    @classmethod
    def from_hparams(cls, hparams: dict, n_channels: int = 3, n_classes: int = 1,
                     bn_mesh=None) -> "ModelConfig":
        dtype = hparams.get("compute_dtype", None)
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={dtype!r}: the port takes one of "
                             f"{COMPUTE_DTYPES}")
        return cls(
            n_channels=n_channels,
            n_classes=n_classes,
            shape_prior=bool(hparams.get("shape_prior", True)),
            shape_attention=bool(hparams.get("shape_attention", True)),
            cat_shape=bool(hparams.get("cat_shape", False)),
            shape_attention_coeffient=float(hparams.get("shape_attention_coeffient", 0.3)),
            whitening=bool(hparams.get("whitening", True)),
            compute_dtype=None if dtype in (None, "float32") else dtype,
            bn_mesh=bn_mesh,
        )


def place(module: nn.Module, device: str | torch.device,
          generator: torch.Generator | None, bn_mesh=None) -> None:
    """Initialise a top-level net as Flax would (from ``generator``, or from
    a generator seeded with 0), hand its BatchNorm layers ``bn_mesh`` (sync
    BN under data parallelism; None: plain BatchNorm) and move it to
    ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_like_flax_(module, generator)
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = bn_mesh
    module.to(resolve_device(device))


def normal_like(t: torch.Tensor, eps: torch.Tensor | None,
                generator: torch.Generator | None) -> torch.Tensor:
    """The N(0, 1) draw of a sampling call, in ``t``'s type: the injected
    ``eps`` if given, else a draw from ``generator`` (on ``t``'s device). One
    of the two is required — the port makes no draw from torch's global
    generator."""
    if eps is not None:
        return eps.to(t.dtype)
    if generator is None:
        raise ValueError("a sampling call needs eps= or generator=")
    return torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype)


def unet_run(m, x1: torch.Tensor) -> torch.Tensor:
    """The shared 5-level encoder/decoder trunk of a module ``m`` exposing
    down1..down4 / up1..up4 (reference trunk: ``algorithms.py:1218-1226``).
    Returns the final 2n-channel decoder map at input resolution."""
    x2 = m.down1(x1)
    x3 = m.down2(x2)
    x4 = m.down3(x3)
    x5 = m.down4(x4)
    x = m.up1(x5, x4)
    x = m.up2(x, x3)
    x = m.up3(x, x2)
    return m.up4(x, x1)


def attention_fuse(cfg: ModelConfig, attention_layer, embedding: torch.Tensor,
                   z_posterior: torch.Tensor):
    """Attention-gated fusion (algorithms.py:1241-1253): ``coef*emb + attn*emb``,
    optional ``cat_shape`` concat. Returns (fused embedding, attention or None)."""
    if cfg.shape_attention:
        att, _ = attention_layer(z_posterior)
        fused = cfg.shape_attention_coeffient * embedding + att * embedding
    else:
        att = None
        fused = embedding
    if cfg.cat_shape:
        fused = torch.cat([fused, z_posterior], dim=1)
    return fused, att
