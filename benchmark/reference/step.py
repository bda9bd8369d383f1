"""The WT-PSE training iteration in plain PyTorch: batch sampling and
augmentation, the four phases and the Adam updates. The benchmark's frozen
reference, after the published ``Trainer.py`` (one iteration of
``train_epoch``) and ``custom_transforms.py`` (RandomScaleCrop, Normalize_tf),
with the covariance as an ``einsum``.

Randomness: every draw comes from one ``torch.Generator`` in a fixed order,
the order the program under test draws in (batch indices; the five
RandomScaleCrop draws; the six N(0, 1) maps of the shape priors, one each for
phase 1's teacher, phase 2's teacher and student, phase 3's teacher and
phase 4's teacher and student). Seeded alike on the same device, the two
sides see the same batches and noise.

The OC phases (3-4) train on a ROI cut from phase 1's detached OD logits:
``od_pred = sigmoid(out_od) > 0.75``, the image with every pixel outside it
set to -1, and the OC segmentation loss masked by ``od_pred`` with
``pos_weight`` = the ROI's pixels over its cup pixels (1 where that is not
finite). :func:`train_step` returns that ``pos_weight`` beside the losses.

``fault`` plants a known fault for the benchmark's own checks:

- ``"half_batch"``: every loss over the first half of the batch only;
- ``"roi_full"``: the OC phases see the whole image, ``od_pred`` all ones;
- ``"roi_threshold"``: the ROI cut at 0.5 in place of 0.75;
- ``"roi_post_update"``: the ROI from the OD logits after phase 1's Adam
  step, by one more forward of the OD net on the same batch, whose draws come
  from a generator of its own in the state phase 1 drew from: the batch and
  every later draw stay as a clean step's;
- ``"pos_weight_one"``: ``pos_weight`` fixed at 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.nets import Policy


# ---- batch: sampling, RandomScaleCrop, Normalize_tf ----------------------

def axis_matrices(scaled, offset, size):
    """(bilinear, nearest) resampling matrices of one axis, each (B, size,
    size): scale up to ``scaled`` then crop at ``offset`` (PIL half-pixel
    centres)."""
    scaled = scaled.to(torch.float32)[:, None]
    offset = offset.to(torch.float32)[:, None]
    j = torch.arange(size, dtype=torch.float32, device=scaled.device)
    src = torch.clamp((offset + j + 0.5) * (size / scaled) - 0.5, 0.0, size - 1)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    w_hi = src - lo.to(torch.float32)
    cols = torch.arange(size, device=scaled.device)
    bilin = ((cols == lo[..., None]) * (1.0 - w_hi)[..., None]
             + (cols == hi[..., None]) * w_hi[..., None])
    near = torch.clamp(torch.floor((offset + j + 0.5) * size / scaled).to(torch.int64),
                       0, size - 1)
    return bilin, (cols == near[..., None]).to(torch.float32)


def sample_batch(pools: dict, per_domain: int, generator, policy: Policy) -> dict:
    """A batch of ``per_domain`` images from each domain of ``pools``
    (``images`` (D, Nmax, H, W, 3) and ``labels`` (D, Nmax, H, W) uint8,
    ``sizes`` (D,)), drawn with replacement, domain-contiguous, augmented
    and normalised: ``image`` (B, 3, H, W) in [-1, 1], ``target_od`` /
    ``target_oc`` (B, 1, H, W)."""
    images, labels, sizes = pools["images"], pools["labels"], pools["sizes"]
    d, dev = images.shape[0], images.device
    idx = torch.randint(0, 2 ** 31 - 1, (d, per_domain), generator=generator, device=dev)
    idx = idx % sizes[:, None]
    dom = torch.arange(d, device=dev)[:, None]
    b = d * per_domain
    img = images[dom, idx].reshape((b,) + images.shape[2:]).permute(0, 3, 1, 2).float()
    lab = labels[dom, idx].reshape((b,) + labels.shape[2:]).float()
    size = img.shape[-1]
    u = torch.rand((5, b), generator=generator, device=dev)
    apply = u[0] < 0.5
    sw = torch.where(apply, torch.floor((u[1] * 0.5 + 1.0) * size), float(size))
    sh = torch.where(apply, torch.floor((u[2] * 0.5 + 1.0) * size), float(size))
    ox = torch.floor(u[3] * (sw - size + 1))
    oy = torch.floor(u[4] * (sh - size + 1))
    mh_b, mh_n = axis_matrices(sh, oy, size)
    mw_b, mw_n = axis_matrices(sw, ox, size)
    m = policy.matmul
    img = torch.einsum("bph,bchw->bcpw", m(mh_b), m(img))
    img = torch.einsum("bqw,bcpw->bcpq", m(mw_b), m(img))
    lab = torch.bmm(torch.bmm(mh_n, lab), mw_n.transpose(1, 2))
    return {"image": (img / 127.5 - 1.0).contiguous(),
            "target_od": (lab <= 200.0).float()[:, None],
            "target_oc": (lab <= 50.0).float()[:, None]}


# ---- whitening losses -----------------------------------------------------

def covariance(z, policy):
    """(B, C, C) = Z Zᵀ / (HW - 1) + 1e-5 I over an NCHW map, in f32."""
    b, c, h, w = z.shape
    f = policy.matmul(z.float().reshape(b, c, h * w))
    eye = torch.eye(c, dtype=torch.float32, device=z.device)
    return torch.einsum("bci,bdi->bcd", f, f) / (h * w - 1) + 1e-5 * eye


def instance_terms(cov, keep):
    b, c, _ = cov.shape
    upper = torch.triu(torch.ones(c, c, dtype=cov.dtype, device=cov.device), diagonal=1)
    off = torch.clamp(torch.sum(torch.abs(cov * upper), dim=(1, 2)) / (c * (c - 1) / 2.0),
                      min=0.0)
    diag = torch.clamp(torch.sum(torch.abs(torch.diagonal(cov, dim1=1, dim2=2) - 1.0), 1) / c,
                       min=0.0)
    return off[:keep].mean(), diag[:keep].mean()


def mmd(x, y, policy):
    def d2(a, b):
        return torch.clamp(torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
                           - 2.0 * (policy.matmul(a) @ policy.matmul(b).T), min=1e-30)

    return (torch.exp(-d2(x, x)).mean() + torch.exp(-d2(y, y)).mean()
            - 2 * torch.exp(-d2(x, y)).mean())


def whitening_single(z, domains, per_domain, policy, keep):
    """(off-diagonal term, diagonal term, domain MMD) of one map."""
    cov = covariance(z, policy)
    off, diag = instance_terms(cov, keep)
    c = cov.shape[1]
    iu, ju = torch.triu_indices(c, c, offset=1, device=cov.device)
    vec = cov[:, iu, ju]
    blocks = [vec[i * per_domain:(i + 1) * per_domain] for i in range(domains)]
    dom = 0.0
    for i in range(domains):
        for j in range(i + 1, domains):
            dom = dom + mmd(blocks[i], blocks[j], policy)
    return off, diag, dom / (domains * (domains - 1) / 2)


def main_whitening(feats, domains, per_domain, policy, keep):
    """Segmenter: the terms of maps 0..n-2 summed, divided by n (the
    published code's divisor)."""
    n = len(feats)
    inst = dom = 0.0
    for z in feats[:n - 1]:
        off, diag, d = whitening_single(z, domains, per_domain, policy, keep)
        inst, dom = inst + off + diag, dom + d
    return inst / n, dom / n


def student_whitening(feats, domains, per_domain, policy, keep):
    """Student: (total, off-diagonal, diagonal, domain); the published loop
    overwrites the diagonal term and doubles the last one."""
    n = len(feats)
    terms = [whitening_single(z, domains, per_domain, policy, keep) for z in feats[:n - 1]]
    off = sum(t[0] for t in terms) / n
    diag = 2.0 * terms[-1][1] / n
    dom = sum(t[2] for t in terms) / n
    return off + diag, off, diag, dom


# ---- the four phases -------------------------------------------------------

def wide(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def seg_phase(net, opt, image, target, loss_fn, domains, per_domain, policy, gen, keep):
    net.train()
    opt.zero_grad(set_to_none=True)
    out, feats = net(image, target, image, gen)
    loss = loss_fn(wide(out))
    inst, dom = main_whitening(feats, domains, per_domain, policy, keep)
    (loss + inst + dom).backward()
    opt.step()
    return out.detach(), {"loss_seg": loss.detach(), "loss_ins_wt": inst.detach(),
                          "loss_dom_wt": dom.detach()}


def shape_phase(main, stud, opt, image, mask, domains, per_domain, policy, gen, keep):
    main.train()
    with torch.no_grad():  # the teacher also moves the segmenter's BN statistics
        _, mu_t = main.teacher_sample(image, mask, gen)
    stud.train()
    opt.zero_grad(set_to_none=True)
    _, mu_s, feats = stud(image, gen)
    kd = torch.mean(torch.square(wide(mu_t) - wide(mu_s))[:keep])
    total, ij, ii, dom = student_whitening(feats, domains, per_domain, policy, keep)
    (kd + total + dom).backward()
    opt.step()
    return {"loss_kd": kd, "loss_ins_wt_shape": total, "loss_ins_wt_shape_ij": ij,
            "loss_ins_wt_shape_ii": ii, "loss_dom_wt_shape": dom}


def oc_roi(out_od, image, target_oc, threshold: float = 0.75):
    """(od_pred, ROI image, pos_weight) from the OD logits."""
    od_pred = (torch.sigmoid(out_od) > threshold).to(image.dtype)
    roi = (image + 1.0) * od_pred - 1.0
    pos_w = torch.sum(od_pred) / torch.sum(od_pred * target_oc)
    return od_pred, roi, torch.where(torch.isfinite(pos_w), pos_w, torch.ones_like(pos_w))


def train_step(nets: dict, opts: dict, pools: dict, domains: int, per_domain: int,
               policy: Policy, gen, fault: str | None = None):
    """One iteration: (the batch it trained on, its losses by the program's
    metric names, the OC loss's ``pos_weight``). ``nets`` and ``opts`` are
    keyed by ``nets.NETS``."""
    batch = sample_batch(pools, per_domain, gen, policy)
    image, t_od, t_oc = batch["image"], batch["target_od"], batch["target_oc"]
    keep = image.shape[0] // 2 if fault == "half_batch" else image.shape[0]
    common = (domains, per_domain, policy, gen, keep)
    if fault == "roi_post_update":
        replay = torch.Generator(device=image.device)
        replay.set_state(gen.get_state())

    out_od, m1 = seg_phase(
        nets["od"], opts["od"], image, t_od,
        lambda o: F.binary_cross_entropy_with_logits(o[:keep], t_od[:keep]), *common)
    if fault == "roi_post_update":
        with torch.no_grad():
            out_od, _ = nets["od"](image, t_od, image, replay)
    m2 = shape_phase(nets["od"], nets["od_shape"], opts["od_shape"], image, t_od, *common)

    if fault == "roi_full":
        out_od = torch.full_like(out_od, math.inf)
    od_pred, roi, pos_w = oc_roi(out_od, image, t_oc, 0.5 if fault == "roi_threshold" else 0.75)
    if fault == "pos_weight_one":
        pos_w = torch.ones_like(pos_w)
    _, m3 = seg_phase(
        nets["oc"], opts["oc"], roi, t_oc,
        lambda o: F.binary_cross_entropy_with_logits((o * od_pred)[:keep], t_oc[:keep],
                                                     pos_weight=pos_w), *common)
    m4 = shape_phase(nets["oc"], nets["oc_shape"], opts["oc_shape"], roi, t_oc, *common)

    losses = dict(m1, **m2)
    losses.update({k + "_oc": v for k, v in {**m3, **m4}.items()})
    return batch, {k: v.detach() for k, v in losses.items()}, pos_w.detach()
