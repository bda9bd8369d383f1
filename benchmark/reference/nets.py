"""The four WT-PSE networks in plain PyTorch, NCHW: the benchmark's frozen
reference, written from the published description (tonyckc/WT-PSE-code,
``algorithms.py`` and ``shape_networks.py``) and the precision policy the
configuration states. Parameter names follow the published checkpoint's
``state_dict``, so the benchmark's weights load into this copy and into the
program under test alike.

Precision (``Policy``):

- ``float32``: every op in f32 (the caller turns TF32 off);
- ``bfloat16``: convs take bf16 operands, accumulate in f32, round to bf16
  and add the bf16 bias (two roundings); BatchNorm keeps f32 statistics and
  returns bf16; the 2x bilinear upsample runs one axis at a time, rounding to
  bf16 after each; ReLU, max-pool, concat and sigmoid in bf16;
- ``tf32``: as ``float32`` with every conv and matmul operand rounded to TF32
  (10 explicit mantissa bits, round to nearest), the precision a later change
  might drop to;
- ``fp8``: as ``bfloat16`` with every conv operand rounded to float8 e4m3
  under a per-tensor power-of-two scale (amax to at most 448), accumulated in
  f32, the step below bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str  # float32 | bfloat16 | tf32 | fp8

    @property
    def dtype(self) -> torch.dtype:
        """The type activations are kept in."""
        return torch.bfloat16 if self.name in ("bfloat16", "fp8") else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A conv operand as this precision computes with it."""
        if self.name == "tf32":
            return round_tf32(t)
        if self.name == "fp8":
            return round_fp8(t).to(torch.bfloat16)
        return t.to(self.dtype)

    def matmul(self, t: torch.Tensor) -> torch.Tensor:
        """An f32 operand of an f32 matmul (the augmentation's resampling,
        the covariance, the MMD's distances): rounded to TF32 under ``tf32``,
        kept as it is otherwise."""
        return round_tf32(t) if self.name == "tf32" else t


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 (the low 13 mantissa bits cleared, to
    nearest), differentiable as the identity."""
    t = t.float()
    bits = t.detach().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t.detach())


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor power-of-two scale that
    brings its largest magnitude to at most 448, back in f32; differentiable
    as the identity."""
    t = t.float()
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
    r = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (r - t.detach())


class Conv(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, policy: Policy):
        super().__init__(cin, cout, k, 1, k // 2, bias=True)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.policy
        if p.dtype == torch.float32:
            return F.conv2d(p.operand(x), p.operand(self.weight), self.bias, 1, self.padding)
        y = F.conv2d(p.operand(x), p.operand(self.weight), None, 1, self.padding)
        return y + self.bias.to(torch.bfloat16)[:, None, None]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, scale_factor=(2, 1), mode="bilinear", align_corners=False)
        return F.interpolate(x, scale_factor=(1, 2), mode="bilinear", align_corners=False)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class ConvD(nn.Module):
    def __init__(self, cin, planes, p, first=False):
        super().__init__()
        self.first = first
        self.conv1, self.bn1 = Conv(cin, planes, 3, p), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, p), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = Conv(planes, planes, 3, p), nn.BatchNorm2d(planes)

    def forward(self, x):
        if not self.first:
            x = F.max_pool2d(x, 2)
        x = self.bn1(self.conv1(x))  # no activation after bn1
        y = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(y)))


class ConvU(nn.Module):
    def __init__(self, planes, p, first=False):
        super().__init__()
        self.first = first
        if not first:
            self.conv1, self.bn1 = Conv(2 * planes, planes, 3, p), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = Conv(planes, planes // 2, 1, p), nn.BatchNorm2d(planes // 2)
        self.conv3, self.bn3 = Conv(planes, planes, 3, p), nn.BatchNorm2d(planes)

    def forward(self, x, prev):
        if not self.first:
            x = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(upsample2x(x))))
        y = torch.cat([prev.to(y.dtype), y], 1)
        return F.relu(self.bn3(self.conv3(y)))


class DoubleConv(nn.Module):
    def __init__(self, cin, f, p):
        super().__init__()
        self.double_conv = nn.Sequential(Conv(cin, f, 3, p), nn.BatchNorm2d(f), nn.ReLU(),
                                         Conv(f, f, 3, p), nn.BatchNorm2d(f), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class DoubleConvWT(nn.Module):
    def __init__(self, cin, f, p):
        super().__init__()
        self.double_conv = nn.Sequential(Conv(cin, f, 3, p), nn.ReLU(), Conv(f, f, 3, p))

    def forward(self, x):
        return self.double_conv(x)


def head(cin, features, p) -> nn.Sequential:
    """1x1 convs with ReLU between them (convs at indices 0, 2, 4, ...)."""
    mods = []
    for i, f in enumerate(features):
        if i:
            mods.append(nn.ReLU())
        mods.append(Conv(cin, f, 1, p))
        cin = f
    return nn.Sequential(*mods)


class DeepWT(nn.Module):
    def __init__(self, cin, f, p):
        super().__init__()
        self.DoubleConv = DoubleConvWT(cin, f, p)
        self.DoubleConv2 = DoubleConvWT(f, f, p)

    def forward(self, x):
        z1 = self.DoubleConv(x)
        z2 = self.DoubleConv2(F.relu(z1))
        return [z1, z2, F.relu(z2)]


def trunk(m, n, p):
    m.down1, m.down2 = ConvD(n, 2 * n, p), ConvD(2 * n, 4 * n, p)
    m.down3, m.down4 = ConvD(4 * n, 8 * n, p), ConvD(8 * n, 16 * n, p)
    m.up1, m.up2 = ConvU(16 * n, p, first=True), ConvU(8 * n, p)
    m.up3, m.up4 = ConvU(4 * n, p), ConvU(2 * n, p)


def run_trunk(m, x1):
    x2 = m.down1(x1)
    x3 = m.down2(x2)
    x4 = m.down3(x3)
    x5 = m.down4(x4)
    return m.up4(m.up3(m.up2(m.up1(x5, x4), x3), x2), x1)


def draw(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The N(0, 1) draw of a sampling call, in ``t``'s type and shape."""
    return torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype)


class Teacher(nn.Module):
    """Mask-conditioned shape prior over the DeepWT features."""

    def __init__(self, n, p):
        super().__init__()
        self.inc = DoubleConv(1, n, p)
        self.fusion = head(2 * n, [n], p)
        trunk(self, n, p)
        self.mu_prior = head(2 * n, [2 * n, 8, 1], p)
        self.logvar_prior = head(2 * n, [2 * n, 8, 1], p)

    def forward(self, feats, mask, generator):
        x1 = F.relu(self.fusion(torch.cat([self.inc(mask), feats], 1)))
        fm = run_trunk(self, x1)
        mu = self.mu_prior(fm)
        std = torch.exp(self.logvar_prior(fm) / 2)
        return mu + std * draw(std, generator), mu


class Student(nn.Module):
    """Image-conditioned shape student with its own DeepWT."""

    def __init__(self, cin, n, p):
        super().__init__()
        self.wt_model = DeepWT(cin, n, p)
        trunk(self, n, p)
        self.mu_prior = head(2 * n, [2 * n, 8, 1], p)
        self.logvar_prior = head(2 * n, [2 * n, 8, 1], p)

    def forward(self, image, generator):
        """(z, mu, DeepWT maps) of the distillation update."""
        feats = self.wt_model(image)
        fm = run_trunk(self, feats[-1])
        mu = torch.nan_to_num(self.mu_prior(fm))
        std = torch.nan_to_num(torch.exp(self.logvar_prior(fm) / 2))
        z = mu + std * draw(std, generator)
        return z * std + mu, mu, feats  # the published student's sampling


class Segmenter(nn.Module):
    """The WT-PSE segmenter: U-Net with an 8-dim embedding, a DeepWT front
    end, the teacher prior and the attention gate on the embedding."""

    def __init__(self, cin, n, feature_dim, n_classes, coef, p):
        super().__init__()
        self.coef = coef
        self.inc = ConvD(cin, n, p, first=True)
        trunk(self, n, p)
        self.wt_model = DeepWT(cin, n, p)
        self.prior_dist = Teacher(n, p)
        self.attention_layer = nn.Module()
        self.attention_layer.layer1 = Conv(1, 1, 1, p)
        self.mu = head(2 * n, [2 * n, feature_dim], p)
        self.outc = head(feature_dim, [n_classes], p)

    def forward(self, image, mask, wt_input, generator):
        """(logits, DeepWT maps)."""
        emb = self.mu(run_trunk(self, self.inc(image)))
        feats = self.wt_model(wt_input)
        z, _ = self.prior_dist(feats[-1], mask, generator)
        att = torch.sigmoid(self.attention_layer.layer1(z))
        return self.outc(self.coef * emb + att * emb), feats

    def teacher_sample(self, image, mask, generator):
        feats = self.wt_model(image)
        return self.prior_dist(feats[-1], mask, generator)


NETS = ("od", "od_shape", "oc", "oc_shape")


def build(cfg: dict, policy: Policy, device) -> dict[str, nn.Module]:
    """The four nets of ``cfg`` (a configuration file's ``widths``), by
    :data:`NETS` name, their parameters f32 and uninitialised on ``device``."""
    w = cfg["widths"]
    with torch.device(device):
        seg = lambda: Segmenter(w["n_channels"], w["base_width"], w["feature_dim"],  # noqa: E731
                                w["n_classes"], w["shape_attention_coeffient"], policy)
        stud = lambda: Student(w["n_channels"], w["base_width"], policy)  # noqa: E731
        return {"od": seg(), "od_shape": stud(), "oc": seg(), "oc_shape": stud()}
