"""Batch partitioning of inference over the data mesh (counterpart of
``wt_pse_tpu/parallel/spatial.py::batch_sharded``).

``spatial_sharded`` (the image's H axis split over the ranks) is not ported:
JAX gets the halo exchanges of every conv, pool and resize from GSPMD, and
the port would have to exchange them by hand (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from wt_pse_tpu_torch.parallel.collectives import all_gather_rows
from wt_pse_tpu_torch.parallel.mesh import DataMesh


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
