"""Augmentation and normalisation on the device (counterpart of
``wt_pse_tpu/data/augment.py:32-161``).

The reference's per-sample PIL chain (RandomScaleCrop: scale up 1-1.5x,
bilinear for the image and nearest for the mask, then a random 256 crop;
Normalize_tf; ToTensor) becomes, for the whole batch on the card, two
interpolation matrices a sample (one for H, one for W) applied as batched
products: scaling up by s and cropping equals resizing a 256/s window back to
256, with the offsets unchanged. Masks go through one-hot nearest matrices, so
the 255/128/0 gray levels survive exactly and the threshold encode (OD =
gray <= 200, OC = gray <= 50) runs after, as in the reference.

The dataset stays on the card as uint8 (D, Nmax, 256, 256, 3); a batch is
gathered, augmented and normalised there, in NCHW, with no host work and no
host sync. The products are f32 GEMMs with TF32 off (set by
``runtime.resolve_device``), the counterpart of the JAX package's
``Precision.HIGHEST`` pin. Every draw comes from the ``torch.Generator`` the
caller passes, on the batch's device.
"""

from __future__ import annotations

import torch

from wt_pse_tpu_torch.runtime import resolve_device


def axis_matrices(scaled: torch.Tensor, offset: torch.Tensor, size: int):
    """The interpolation matrices of one axis for a batch, each (B, size, size).

    ``scaled`` (B,) is the scaled length in [size, 1.5*size) and ``offset``
    (B,) the crop offset, both f32 integers. Output pixel j samples the scaled
    image at ``offset + j``, the original at ``src = (offset + j + 0.5) *
    size/scaled - 0.5`` (PIL's half-pixel bilinear); nearest takes
    ``floor((offset + j + 0.5) * size / scaled)``, multiply first. The f32
    operations are those of the JAX version, in its order.
    """
    scaled = scaled.to(torch.float32)[:, None]
    offset = offset.to(torch.float32)[:, None]
    j = torch.arange(size, dtype=torch.float32, device=scaled.device)
    ratio = size / scaled
    src = (offset + j + 0.5) * ratio - 0.5
    src = torch.clamp(src, 0.0, size - 1)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    w_hi = src - lo.to(torch.float32)
    cols = torch.arange(size, device=scaled.device)
    m_bilin = ((cols == lo[..., None]) * (1.0 - w_hi)[..., None]
               + (cols == hi[..., None]) * w_hi[..., None])
    near = torch.clamp(torch.floor((offset + j + 0.5) * size / scaled).to(torch.int64),
                       0, size - 1)
    m_near = (cols == near[..., None]).to(torch.float32)
    return m_bilin, m_near


def sample_params(batch: int, size: int, generator: torch.Generator,
                  device: torch.device):
    """The reference's RandomScaleCrop draws for ``batch`` samples
    (custom_transforms.py:344-348, 167-168): apply ~ Bern(0.5); per axis a
    scaled length ``floor(U(1, 1.5) * size)`` (``size`` when not applied) and
    an offset ``floor(U(0, 1) * (scaled - size + 1))``. Returns f32
    ``(sh, sw, oy, ox)``, each (B,)."""
    u = torch.rand((5, batch), generator=generator, device=device)
    apply = u[0] < 0.5
    sw = torch.floor((u[1] * 0.5 + 1.0) * size)
    sh = torch.floor((u[2] * 0.5 + 1.0) * size)
    sw = torch.where(apply, sw, float(size))
    sh = torch.where(apply, sh, float(size))
    ox = torch.floor(u[3] * (sw - size + 1))
    oy = torch.floor(u[4] * (sh - size + 1))
    return sh, sw, oy, ox


def normalize_tf(img: torch.Tensor, lab_gray: torch.Tensor):
    """Normalize_tf: image / 127.5 - 1; gray label (B, H, W) -> (od, oc)
    binary masks (B, 1, H, W) with OD = gray <= 200, OC = gray <= 50."""
    od = (lab_gray <= 200.0).to(torch.float32)[:, None]
    oc = (lab_gray <= 50.0).to(torch.float32)[:, None]
    return img / 127.5 - 1.0, od, oc


def augment_batch(images_u8: torch.Tensor, labels_u8: torch.Tensor,
                  generator: torch.Generator | None = None, train: bool = True,
                  draws: tuple[torch.Tensor, ...] | None = None) -> dict:
    """Augment and normalise a batch.

    ``images_u8`` (B, H, W, 3) and ``labels_u8`` (B, H, W) uint8 gray labels,
    on one device. ``draws`` injects ``(sh, sw, oy, ox)``; otherwise they come
    from ``generator``. With ``train=False`` no augmentation is applied.
    Returns ``image`` (B, 3, H, W) in [-1, 1] and ``target_od`` /
    ``target_oc`` (B, 1, H, W), f32 NCHW.
    """
    img = images_u8.permute(0, 3, 1, 2).to(torch.float32)  # NCHW
    lab = labels_u8.to(torch.float32)
    if train:
        size = img.shape[-1]
        if draws is None:
            if generator is None:
                raise ValueError("augment_batch needs draws= or generator=")
            draws = sample_params(img.shape[0], size, generator, img.device)
        sh, sw, oy, ox = draws
        mh_b, mh_n = axis_matrices(sh, oy, size)
        mw_b, mw_n = axis_matrices(sw, ox, size)
        # H, then W, as the JAX version contracts them
        img = torch.einsum("bph,bchw->bcpw", mh_b, img)
        img = torch.einsum("bqw,bcpw->bcpq", mw_b, img)
        lab = torch.bmm(torch.bmm(mh_n, lab), mw_n.transpose(1, 2))
    image, od, oc = normalize_tf(img, lab)
    return {"image": image.contiguous(), "target_od": od, "target_oc": oc}


def sample_domain_batch(images_u8: torch.Tensor, labels_u8: torch.Tensor,
                        sizes: torch.Tensor, per_domain_batch: int,
                        generator: torch.Generator):
    """Uniform per-domain sampling with replacement, on the device.

    ``images_u8`` (D, Nmax, H, W, 3) and ``labels_u8`` (D, Nmax, H, W) hold
    the domains padded to Nmax; ``sizes`` (D,) their true sizes. An index is
    ``randint(0, 2**31 - 1) % size``, as in the JAX version (a modulo bias of
    about size / 2**31). Returns (B = D * per_domain_batch, ...) tensors laid
    out domain-contiguously, as the MMD slicing needs (Trainer.py:1013).
    """
    d = images_u8.shape[0]
    idx = torch.randint(0, 2 ** 31 - 1, (d, per_domain_batch), generator=generator,
                        device=images_u8.device)
    idx = idx % sizes[:, None]
    dom = torch.arange(d, device=images_u8.device)[:, None]
    imgs, labs = images_u8[dom, idx], labels_u8[dom, idx]
    b = d * per_domain_batch
    return imgs.reshape((b,) + imgs.shape[2:]), labs.reshape((b,) + labs.shape[2:])


def make_device_batch_fn(per_domain_batch: int, *, device: str | torch.device = "cuda"):
    """``fn(data, generator) -> batch``: sampling, augmentation and
    normalisation on ``device``. ``data`` holds ``images``, ``labels`` and
    ``sizes`` on that device (``train/trainer.py::stack_domains``). Its
    time is the ``sample`` span (``utils/trace.py``): a device span of the
    graph's step, a host span of the eager loop's."""
    resolve_device(device)

    def fn(data: dict, generator: torch.Generator) -> dict:
        imgs, labs = sample_domain_batch(data["images"], data["labels"],
                                         data["sizes"], per_domain_batch, generator)
        return augment_batch(imgs, labs, generator, train=True)

    return fn
