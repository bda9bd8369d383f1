"""Spatial and batch partitioning of inference over the data mesh
(counterpart of ``wt_pse_tpu/parallel/spatial.py``).

JAX annotates the image's H (or batch) axis with a mesh axis and lets GSPMD
insert the halo exchanges. The port splits the rows itself: each rank runs
the predict on its slab inside :func:`models.layers.row_shard`, where the
3x3 convs and the 2x upsample exchange one row with each neighbouring rank
by hand (``parallel/collectives.py::halo_rows``), and an all-gather puts the
slabs back together. Every op on the two-stage predict path is local in
space (convs, pools, resizes, eval-mode BatchNorm, the ROI's pointwise
mask), so the result is the unsharded one up to the convolution
algorithms' rounding.

**Known difference from JAX:** :func:`spatial_sharded` needs H divisible by
16 N for N ranks, so that every rank's slab starts on an even row at each of
the four 2x2 max-pools; GSPMD takes slabs of any size (8 rows a device in
``tests/test_spatial.py``).
"""

from __future__ import annotations

import torch

from wt_pse_tpu_torch.models.layers import row_shard
from wt_pse_tpu_torch.parallel.collectives import all_gather_rows
from wt_pse_tpu_torch.parallel.mesh import DataMesh

POOLS = 4  # the 2x2 max-pools of each U-Net on the predict path


def spatial_sharded(predict_fn, mesh: DataMesh):
    """Wrap ``predict_fn(image) -> tuple of (B, C, H, W) tensors`` so that
    each rank predicts its slab of H / N rows of the NCHW ``image``, with the
    halo exchanges inside, and an all-gather along H returns every output
    for the whole image on every rank. Every rank calls it with the same
    image. Raises ``ValueError`` unless H is a multiple of 16 N."""

    def predict(image):
        image = torch.as_tensor(image)
        h = image.shape[2]
        if h % (2 ** POOLS * mesh.size):
            raise ValueError(
                f"spatial_sharded over {mesh.size} ranks needs H % {2 ** POOLS * mesh.size} "
                f"== 0 (H = {h}): each rank's slab must start on an even row at each of "
                f"the {POOLS} max-pools")
        rows = h // mesh.size
        with row_shard(mesh):
            outs = predict_fn(image[:, :, mesh.rank * rows:(mesh.rank + 1) * rows].contiguous())
        # (N, B, C, rows, W) -> (B, C, N * rows, W), slabs in rank order
        return tuple(all_gather_rows(o, mesh).permute(1, 2, 0, 3, 4).flatten(2, 3)
                     for o in outs)

    return predict


def batch_sharded(predict_fn, mesh: DataMesh):
    """Wrap ``predict_fn(image) -> tuple of (B, ...) tensors`` so that each
    rank predicts its rows of the chunk, padded with zero images to a
    multiple of the mesh size, and an all-gather returns every output for
    the whole chunk on every rank. Every rank calls it with the same chunk.
    With the nets in eval mode each row is predicted on its own, so the
    result is the unsharded one."""

    def predict(image):
        image = torch.as_tensor(image)
        b = image.shape[0]
        rows = -(-b // mesh.size)
        pad = rows * mesh.size - b
        if pad:
            image = torch.cat([image, image.new_zeros((pad,) + image.shape[1:])])
        outs = predict_fn(image[mesh.rank * rows:(mesh.rank + 1) * rows])
        return tuple(all_gather_rows(o, mesh).flatten(0, 1)[:b] for o in outs)

    return predict
