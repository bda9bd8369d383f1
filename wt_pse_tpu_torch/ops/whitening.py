"""Whitening-transform (covariance) losses and the cross-domain MMD penalty
(counterpart of ``wt_pse_tpu/ops/whitening.py``).

- per-feature-map covariance ``f_cor = f fᵀ / (HW - 1) + 1e-5·I`` over an NCHW
  map, through the hand-written kernels of ``ops/covariance_cuda.py`` (on CUDA
  always; the hparam ``use_pallas_whitening`` is a TPU choice and is ignored).
  A bf16 map (the bf16 mode) goes into the kernels as bf16, with no f32 copy;
  the covariance comes back f32 and every loss below stays f32;
- instance loss = hinge(sum |upper-tri(f_cor)| - margin) / C(C-1)/2 plus
  hinge(sum |diag(f_cor) - 1| - margin) / C, each averaged over the batch;
- domain loss = mean pairwise Gaussian-kernel MMD (gamma 1) between the
  per-domain blocks of the (B, C(C-1)/2) upper-triangle vectors; the batch is
  laid out domain-contiguously.

Reference quirks, on by default and switched off by ``replicate_ref_quirks=False``:

1. main net: the sum over the first 2 of 3 DeepWT maps is divided by 3
   (``wt_pse_tpu/ops/whitening.py:178``);
2. student net: the diagonal term is clobbered each loop iteration and then
   added to itself, leaving ``2 * diag_loss(last map)`` (``whitening.py:209-210``).
"""

from __future__ import annotations

import torch

from wt_pse_tpu_torch.ops.covariance_cuda import Covariance


def feature_covariance(z: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) covariance, differentiable."""
    return Covariance.apply(z)


def instance_whitening_terms(cov: torch.Tensor, margin: float = 0.0):
    """(off-diagonal hinge term, diagonal hinge term), each averaged over the batch."""
    b, c, _ = cov.shape
    upper = torch.triu(torch.ones(c, c, dtype=cov.dtype, device=cov.device), diagonal=1)
    num_off = c * (c - 1) / 2.0
    off_sum = torch.sum(torch.abs(cov * upper), dim=(1, 2)) - margin
    off_term = torch.mean(torch.clamp(off_sum / num_off, min=0.0))

    diag = torch.abs(torch.diagonal(cov, dim1=1, dim2=2) - 1.0)
    diag_sum = torch.sum(diag, dim=1) - margin
    diag_term = torch.mean(torch.clamp(diag_sum / c, min=0.0))
    return off_term, diag_term


def upper_triangle_vectors(cov: torch.Tensor) -> torch.Tensor:
    """(B, C(C-1)/2) row-major upper-triangle entries (``torch.triu_indices`` order)."""
    c = cov.shape[1]
    iu, ju = torch.triu_indices(c, c, offset=1, device=cov.device)
    return cov[:, iu, ju]


def _gaussian_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gaussian-kernel (gamma 1) MMD between two (n, d) sets; squared
    distances clamped at 1e-30."""

    def cdist2(a, b):
        d = (torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
             - 2.0 * (a @ b.T))
        return torch.clamp(d, min=1e-30)

    kxx = torch.mean(torch.exp(-cdist2(x, x)))
    kyy = torch.mean(torch.exp(-cdist2(y, y)))
    kxy = torch.mean(torch.exp(-cdist2(x, y)))
    return kxx + kyy - 2 * kxy


def domain_mmd(vectors: torch.Tensor, domain_num: int,
               per_domain_batch: int) -> torch.Tensor:
    """Mean pairwise MMD over domain-contiguous blocks of ``vectors``; 0 with
    one domain."""
    if domain_num <= 1:
        return torch.zeros((), dtype=vectors.dtype, device=vectors.device)
    blocks = [vectors[i * per_domain_batch:(i + 1) * per_domain_batch]
              for i in range(domain_num)]
    penalty = 0.0
    for i in range(domain_num):
        for j in range(i + 1, domain_num):
            penalty = penalty + _gaussian_mmd(blocks[i], blocks[j])
    return penalty / (domain_num * (domain_num - 1) / 2)


def whitening_loss_single(z: torch.Tensor, domain_num: int, per_domain_batch: int,
                          margin: float = 0.0):
    """One feature map -> (off_term, diag_term, domain_term)."""
    cov = feature_covariance(z)
    off_term, diag_term = instance_whitening_terms(cov, margin)
    dom = domain_mmd(upper_triangle_vectors(cov), domain_num, per_domain_batch)
    return off_term, diag_term, dom


def main_whitening_loss(wt_feats, domain_num: int, per_domain_batch: int,
                        margin: float = 0.0, replicate_ref_quirks: bool = True):
    """Main-net whitening loss over the DeepWT list. Returns (instance, domain).
    Sums maps 0..len-2; divides by len (quirk 1) or by the number summed."""
    num = len(wt_feats)
    inst = 0.0
    dom = 0.0
    for z in wt_feats[: num - 1]:
        off_t, diag_t, dom_t = whitening_loss_single(z, domain_num, per_domain_batch,
                                                     margin)
        inst = inst + off_t + diag_t
        dom = dom + dom_t
    denom = num if replicate_ref_quirks else max(num - 1, 1)
    return inst / denom, dom / denom


def student_whitening_loss(wt_feats, domain_num: int, per_domain_batch: int,
                           margin: float = 0.0, replicate_ref_quirks: bool = True):
    """Student-net whitening loss. Returns (inst_total, inst_offdiag,
    inst_diag, domain) in the reference's return order; ``inst_diag`` carries
    quirk 2 by default."""
    num = len(wt_feats)
    offs, diags, doms = [], [], []
    for z in wt_feats[: num - 1]:
        off_t, diag_t, dom_t = whitening_loss_single(z, domain_num, per_domain_batch,
                                                     margin)
        offs.append(off_t)
        diags.append(diag_t)
        doms.append(dom_t)
    if not diags:
        # single-map list (DeepWT(whitening=False) returns [x]): nothing to whiten
        zero = torch.zeros((), dtype=torch.float32, device=wt_feats[0].device)
        return zero, zero, zero, zero
    denom = num if replicate_ref_quirks else max(num - 1, 1)
    inst_off = sum(offs) / denom
    if replicate_ref_quirks:
        inst_diag = 2.0 * diags[-1] / denom  # clobber-then-double
    else:
        inst_diag = sum(diags) / denom
    dom = sum(doms) / denom
    return inst_off + inst_diag, inst_off, inst_diag, dom
