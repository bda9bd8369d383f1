"""What the benchmark makes from ``--seed`` and hands to both sides: the
training pools and the four nets' weights. Both are made on the run's device
in a few large calls, so set-up stays short and the same seed gives the same
inputs."""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F


def derive(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one ``purpose`` of a run's ``seed``."""
    digest = hashlib.sha256(f"wtbench:{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def make_pools(sizes: list[int], hw: int, seed: int, device) -> dict:
    """Fundus-like training pools, one a site: uint8 RGB images (N, hw, hw, 3)
    and gray labels (N, hw, hw) with 255 background, 128 optic disc and 0 cup
    (the published label coding, which Normalize_tf thresholds at 200 and 50).
    Each image has a disc at a seeded centre and radius, a cup of a seeded
    share of it, a smooth seeded background and pixel noise, and a colour
    shift a site. Returns the stacked device tensors the reference samples
    from: ``images`` (D, Nmax, hw, hw, 3) and ``labels`` (D, Nmax, hw, hw),
    each site padded with zeros to Nmax, and ``sizes`` (D,)."""
    g = generator(seed, "pools", device)
    nmax = max(sizes)
    images = torch.zeros((len(sizes), nmax, hw, hw, 3), dtype=torch.uint8, device=device)
    labels = torch.zeros((len(sizes), nmax, hw, hw), dtype=torch.uint8, device=device)
    coords = (torch.arange(hw, device=device, dtype=torch.float32) + 0.5) / hw
    base = torch.tensor([150.0, 70.0, 30.0], device=device)[None, :, None, None]
    for site, n in enumerate(sizes):  # the padding rows stay 0 and are never drawn
        u = torch.rand((4, n), generator=g, device=device)
        cy, cx = (0.35 + 0.3 * u[0])[:, None, None], (0.35 + 0.3 * u[1])[:, None, None]
        rad = (0.10 + 0.08 * u[2])[:, None, None]
        cup = rad * (0.35 + 0.35 * u[3])[:, None, None]
        r2 = (coords[None, :, None] - cy) ** 2 + (coords[None, None, :] - cx) ** 2
        lab = torch.full((n, hw, hw), 255, dtype=torch.uint8, device=device)
        lab[r2 < rad ** 2] = 128
        lab[r2 < cup ** 2] = 0
        smooth = F.interpolate(torch.randn((n, 3, 8, 8), generator=g, device=device),
                               size=(hw, hw), mode="bilinear", align_corners=False)
        img = (base + 12.0 * site + 30.0 * smooth
               + 8.0 * torch.randn((n, 3, hw, hw), generator=g, device=device)
               + 70.0 * (lab < 255)[:, None].float())
        images[site, :n] = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        labels[site, :n] = lab
    return {"images": images, "labels": labels,
            "sizes": torch.tensor(sizes, dtype=torch.int64, device=device)}


def make_weights(shapes: dict[str, dict[str, tuple]], seed: int, device,
                 init: dict[str, float] | None = None) -> dict:
    """Initial weights of each net, by parameter and buffer name: conv
    kernels N(0, 1 / fan_in) (one draw a net), conv biases and BatchNorm
    shifts 0, BatchNorm scales 1, running means 0 and variances 1, counts 0;
    ``init`` sets whole tensors, by "net.name", to a constant. ``shapes``
    maps net -> name -> shape."""
    out = {}
    for net, named in shapes.items():
        kernels = [k for k, s in named.items() if len(s) == 4]
        total = sum(math.prod(named[k]) for k in kernels)
        flat = torch.randn(total, generator=generator(seed, f"weights:{net}", device),
                           device=device)
        tensors, at = {}, 0
        for k, s in named.items():
            if len(s) == 4:
                n = math.prod(s)
                fan_in = math.prod(s[1:])
                tensors[k] = (flat[at:at + n] / fan_in ** 0.5).reshape(s)
                at += n
            elif k.endswith("num_batches_tracked"):
                tensors[k] = torch.zeros(s, dtype=torch.int64, device=device)
            elif k.endswith("running_var") or (k.endswith("weight") and len(s) == 1):
                tensors[k] = torch.ones(s, device=device)
            else:
                tensors[k] = torch.zeros(s, device=device)
        out[net] = tensors
    for key, value in (init or {}).items():
        net, name = key.split(".", 1)
        out[net][name].fill_(value)
    return out
