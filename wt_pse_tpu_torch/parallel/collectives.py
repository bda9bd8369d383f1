"""The collectives of data-parallel training, written by hand over the mesh's
process group (new to the port: XLA supplies these to JAX as ``pmean``,
``psum`` and ``all_gather``).

Everything is built from ``all_reduce`` (sum) and ``broadcast``: gloo takes
CUDA tensors for those two only, and the port's data parallelism must run
over NCCL on the cards and over gloo on the CPU, or on one card shared by
two ranks (NCCL refuses two ranks on one card). On a mesh without a process
group (one process), each collective is the identity.

Gradients: :func:`all_reduce_sum`'s backward is the all-reduce-sum of the
cotangent, and :func:`all_gather_rows`'s is that sum sliced to this rank's
rows (JAX's transpose of ``all_gather``, a ``psum_scatter``). Neither
averages: each rank differentiates its own loss, the sum carries every
rank's cotangent back to the rank that owns the input, and the gradient
mean that follows (:func:`mean_grads_`) divides by N. Together they give the
gradient of the mean of the ranks' losses, which is the single-device
gradient of the global batch.

:func:`halo_rows` is the row exchange of H-axis sharded inference
(``parallel/spatial.py::spatial_sharded``): each rank's slab of an image
takes one row from each neighbouring rank's slab.

Under a CUDA graph (``train/graph.py``) over NCCL: the collectives of the
training step (:func:`all_reduce_sum` and its backward, run on autograd's
thread, :func:`all_gather_rows`, :func:`mean_grads_`, :func:`mean_values`)
are captured as they are. Their ``all_reduce`` waits by making the current
stream wait for NCCL's, with no host sync (unless
``TORCH_NCCL_BLOCKING_WAIT`` is set, which the port never sets), so the
capture's sync debug mode lets them pass. :func:`broadcast_floats` and
:func:`barrier` read their result on the host, and :func:`halo_rows` and the
batch-sharded predict serve inference: they run between replays, never
inside one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from wt_pse_tpu_torch.parallel.mesh import DataMesh


def _sum_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """In-place all-reduce-sum of ``t`` over the mesh; returns ``t``."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return _sum_(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _sum_(g.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; differentiable."""
    return _AllReduceSum.apply(x, mesh)


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order, on every rank;
    differentiable. An all-reduce of a buffer that is zero but for this
    rank's slot, so each sum adds its one value to zeros: exact."""
    slots = [x if r == mesh.rank else torch.zeros_like(x) for r in range(mesh.size)]
    return all_reduce_sum(torch.stack(slots), mesh)


def halo_rows(x: torch.Tensor, mesh: DataMesh, fill: str) -> torch.Tensor:
    """(B, C, h + 2, W): this rank's slab ``x`` (B, C, h, W) of an image whose
    rows are split over the mesh in rank order, with the last row of the rank
    above on top and the first row of the rank below underneath. Where there
    is no neighbour, at the image's true top and bottom, the added row is
    zero (``fill='zero'``, a conv's padding) or a copy of the edge row
    (``fill='replicate'``, the clamp of a bilinear resize).

    One all-reduce: each rank writes its first and last row into its own
    slot of a zero buffer, so each sum adds one value to zeros (exact), and
    reads its neighbours' slots. The buffer is at least f32 (gloo reduces
    no bf16 on every build; the widening is exact). Each exchange over a
    process group adds one to ``halo_rows.exchanges``."""
    if fill not in ("zero", "replicate"):
        raise ValueError(f"fill={fill!r}: 'zero' or 'replicate'")
    first, last = x[:, :, :1], x[:, :, -1:]
    above = below = None
    if mesh.group is not None:
        slots = x.new_zeros((mesh.size, 2) + first.shape,
                            dtype=torch.promote_types(x.dtype, torch.float32))
        slots[mesh.rank, 0] = first
        slots[mesh.rank, 1] = last
        _sum_(slots, mesh)
        halo_rows.exchanges += 1
        slots = slots.to(x.dtype)
        if mesh.rank > 0:
            above = slots[mesh.rank - 1, 1]
        if mesh.rank < mesh.size - 1:
            below = slots[mesh.rank + 1, 0]
    if above is None:
        above = torch.zeros_like(first) if fill == "zero" else first
    if below is None:
        below = torch.zeros_like(last) if fill == "zero" else last
    return torch.cat([above, x, below], dim=2)


halo_rows.exchanges = 0


def mean_grads_(params, mesh: DataMesh) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in one
    flattened all-reduce. Parameters without a gradient are skipped: which
    ones have none is fixed by the net and the step, the same on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh.group is None or not grads:
        return
    flat = _sum_(torch.cat([g.reshape(-1) for g in grads]), mesh).div_(mesh.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_values(values: dict[str, torch.Tensor], mesh: DataMesh) -> dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar tensor of ``values``, in one
    all-reduce (the JAX DP step's ``pmean`` of its metrics)."""
    if mesh.group is None:
        return values
    names = sorted(values)
    stacked = _sum_(torch.stack([values[k] for k in names]), mesh) / mesh.size
    return dict(zip(names, stacked.unbind()))


def broadcast_floats(values: list[float], mesh: DataMesh) -> list[float]:
    """Rank 0's ``values`` on every rank (f64)."""
    if mesh.group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)  # a mesh's rank 0 is global rank 0
    return t.tolist()


def barrier(mesh: DataMesh) -> None:
    """Return once every rank of the mesh has called it: an all-reduce whose
    result is read."""
    if mesh.group is not None:
        _sum_(torch.zeros(1, device=mesh.device), mesh).item()
