"""Spatial and batch partitioning of inference over the data mesh
(counterpart of ``wt_pse_tpu/parallel/spatial.py``).

JAX annotates the image's H (or batch) axis with a mesh axis and lets GSPMD
insert the halo exchanges. The port splits the rows itself: each shard runs
the predict on its slab inside :func:`models.layers.row_shard`, where the
3x3 convs and the 2x upsample exchange one row with each neighbouring shard
by hand (``parallel/collectives.py::halo_rows``), and a gather puts the
slabs back together. Every op on the two-stage predict path is local in
space (convs, pools, resizes, eval-mode BatchNorm, the ROI's pointwise
mask), so the result is the unsharded one up to the convolution
algorithms' rounding.

Slabs are whole blocks of ``2 ** POOLS`` = 16 rows (:func:`slab_rows`), so
every slab starts on an even row at each of the four 2x2 max-pools, and the
only rule on H is the U-Net's own, H % 16 == 0. When there are fewer blocks
than shards, the shards past the last block hold no rows and sit out the
exchanges, as GSPMD pads JAX's 8-device case at H = 64.

Two kinds of mesh (``parallel/mesh.py``):

- a process group (:class:`DataMesh`): every rank calls the wrapper with the
  same image and gets the whole output, all-gathered;
- the devices of this one process (:class:`LocalMesh`): the wrapper takes
  ``predict_for(device) -> predict`` and calls it once a shard when
  wrapping (:func:`nets_on` copies the nets to each device, as JAX
  replicates its variables once), then runs each shard in a thread of its
  own (a pool kept across calls until :meth:`LocalPredict.close`) on its
  device's default stream, and gathers the outputs in slab order onto the
  first device. A shard that raises aborts the others' barriers; the call
  re-raises its exception once every shard has stopped, and the pool's
  threads are joined.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import threading

import torch
import torch.distributed as dist

from wt_pse_tpu_torch.models.layers import row_shard
from wt_pse_tpu_torch.parallel.collectives import all_gather_rows
from wt_pse_tpu_torch.parallel.mesh import DataMesh, LocalMesh

POOLS = 4  # the 2x2 max-pools of each U-Net on the predict path
BLOCK = 2 ** POOLS
SHARD_THREAD = "wt_pse_shard"  # the name prefix of an in-process mesh's shard threads
_SUBGROUPS: dict = {}  # (world group, k) -> the process group of ranks 0 .. k-1


def slab_rows(h: int, n: int) -> list[int]:
    """The rows of each of ``n`` shards' slabs of ``h`` rows, in order: the
    16-row blocks dealt out as evenly as they go, earlier shards taking the
    extra block (shards past the last block get 0)."""
    if h % BLOCK:
        raise ValueError(f"spatial_sharded needs H % {BLOCK} == 0 (H = {h}): the U-Net "
                         f"concatenates each 2x upsample with its skip at all {POOLS} levels")
    base, extra = divmod(h // BLOCK, n)
    return [(base + (r < extra)) * BLOCK for r in range(n)]


def nets_on(nets, device) -> list:
    """Copies of ``nets`` on ``device``: a shard's own nets for
    ``predict_for(device)``."""
    return [copy.deepcopy(net).to(device) for net in nets]


def spatial_sharded(predict_fn, mesh: DataMesh | LocalMesh):
    """Wrap a predict so that each shard predicts its slab of the NCHW
    image's rows (:func:`slab_rows`), with the halo exchanges inside, and the
    slabs of every output, ``(B, C, rows, W)``, come back in order along H.

    On a process group, ``predict_fn(image)``: every rank calls the wrapper
    with the same image and gets every output whole. On a
    :class:`LocalMesh`, ``predict_fn(device) -> predict(image)``, and the
    wrapper is a :class:`LocalPredict`: the outputs come back on the mesh's
    first device. Raises ``ValueError`` unless H is a multiple of 16."""
    if isinstance(mesh, LocalMesh):
        def spatial_call(image, run):
            rows = slab_rows(image.shape[2], mesh.size)
            starts = [sum(rows[:r]) for r in range(mesh.size)]

            def work(r, view, predict):
                with row_shard(view):
                    return predict(image[:, :, starts[r]:starts[r] + rows[r]].to(
                        mesh.devices[r]).contiguous())

            return _cat_on(run(sum(1 for n in rows if n), work), 2, mesh.devices[0])

        return LocalPredict(predict_fn, mesh, spatial_call)

    def predict(image):
        image = torch.as_tensor(image)
        rows = slab_rows(image.shape[2], mesh.size)
        k = sum(1 for n in rows if n)
        start = sum(rows[:mesh.rank])
        sub = _sub_mesh(mesh, k)  # on every rank, idle ones too: the group is made by all
        outs = None
        if rows[mesh.rank]:
            with row_shard(sub):
                outs = predict_fn(image[:, :, start:start + rows[mesh.rank]].contiguous())
        if k < mesh.size:  # an idle rank made no outputs: rank 0 says what they are
            outs = _like_rank0(outs, mesh, image)
        return tuple(_gather_slabs(o, rows, mesh) for o in outs)

    return predict


def batch_sharded(predict_fn, mesh: DataMesh | LocalMesh):
    """Wrap a predict so that each shard predicts its rows of the chunk,
    padded with zero images to a multiple of the mesh size, and every output
    comes back for the whole chunk (``predict_fn`` and where the outputs lie
    as :func:`spatial_sharded` says for each kind of mesh). With the nets in
    eval mode each row is predicted on its own, so the result is the
    unsharded one."""

    def padded(image):
        image = torch.as_tensor(image)
        b = image.shape[0]
        rows = -(-b // mesh.size)
        pad = rows * mesh.size - b
        if pad:
            image = torch.cat([image, image.new_zeros((pad,) + image.shape[1:])])
        return image, b, rows

    if isinstance(mesh, LocalMesh):
        def batch_call(image, run):
            image, b, rows = padded(image)

            def work(r, view, predict):
                return predict(image[r * rows:(r + 1) * rows].to(mesh.devices[r]))

            return tuple(o[:b] for o in _cat_on(run(mesh.size, work), 0, mesh.devices[0]))

        return LocalPredict(predict_fn, mesh, batch_call)

    def predict(image):
        image, b, rows = padded(image)
        outs = predict_fn(image[mesh.rank * rows:(mesh.rank + 1) * rows])
        return tuple(all_gather_rows(o, mesh).flatten(0, 1)[:b] for o in outs)

    return predict


def _sub_mesh(mesh: DataMesh, k: int) -> DataMesh:
    """The mesh of the first ``k`` ranks, which hold rows, made by every rank
    of the process group in the same order and kept for later calls."""
    if k == mesh.size:
        return mesh
    if mesh.size != dist.get_world_size():
        raise ValueError(f"{mesh.size - k} of {mesh.size} ranks hold no rows: their sub-mesh "
                         "is made by every rank of the process group, so the mesh must span it")
    key = (dist.group.WORLD, k)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(list(range(k)))
    return DataMesh(_SUBGROUPS[key], mesh.rank, k, mesh.device)


def _like_rank0(outs, mesh: DataMesh, image: torch.Tensor) -> tuple:
    """This rank's outputs, or, on an idle rank, zero slabs of no rows shaped
    and typed as rank 0's (one broadcast from rank 0, which holds rows)."""
    meta = [[(o.shape, o.dtype) for o in outs] if outs else None]
    dist.broadcast_object_list(meta, src=0, group=mesh.group)
    if outs:
        return outs
    return tuple(torch.zeros((image.shape[0], shape[1], 0, shape[3]), dtype=dtype,
                             device=image.device) for shape, dtype in meta[0])


def _gather_slabs(o: torch.Tensor, rows: list[int], mesh: DataMesh) -> torch.Tensor:
    """Every rank's slab of one output along H, in rank order: each padded
    to the largest slab, all-gathered, and cut back."""
    padded = torch.nn.functional.pad(o, (0, 0, 0, rows[0] - o.shape[2]))
    every = all_gather_rows(padded, mesh)  # (N, B, C, rows[0], W)
    return torch.cat([every[r, :, :, :n] for r, n in enumerate(rows) if n], dim=2)


def _cat_on(per_shard: list, dim: int, device: torch.device) -> tuple:
    """Each output of the shards, in shard order, concatenated along ``dim``
    on ``device``."""
    return tuple(torch.cat([o.to(device) for o in outs], dim=dim) for outs in zip(*per_shard))


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class LocalPredict:
    """``predict(image) = call(image, run)`` on the in-process ``mesh``, the
    wrapper :func:`spatial_sharded` and :func:`batch_sharded` return there.
    ``run(k, work)`` runs ``work(r, view, predict_r)`` for the first ``k``
    shards at once, each in a pool thread under its device, with its view of
    the mesh of those ``k`` shards and its own ``predict_for(device)``, and
    returns their results in shard order. :meth:`close` joins the pool's
    threads (a later call starts them again)."""

    def __init__(self, predict_for, mesh: LocalMesh, call):
        self.mesh = mesh
        self._call = call
        self._predicts = [predict_for(d) for d in mesh.devices]
        self._pool = None

    def __call__(self, image):
        with self.mesh.group.lock:  # the shards of two calls would share the slots
            return self._call(torch.as_tensor(image), self._run)

    def close(self) -> None:
        with self.mesh.group.lock:
            self._shutdown()

    def _shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _run(self, k: int, work) -> list:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(self.mesh.size, SHARD_THREAD)
        views = [self.mesh.shard(r, k) for r in range(k)]

        def shard(r: int):
            try:
                with _on(self.mesh.devices[r]):
                    return work(r, views[r], self._predicts[r])
            except BaseException:
                views[r].group.abort()  # the others stop at their next barrier
                raise

        futures = [self._pool.submit(shard, r) for r in range(k)]
        concurrent.futures.wait(futures)
        errors = [f.exception() for f in futures]
        if any(errors):
            self._shutdown()
            self.mesh.group.reset()
            raise next((e for e in errors if e is not None
                        and not isinstance(e, threading.BrokenBarrierError)),
                       next(e for e in errors if e is not None))
        return [f.result() for f in futures]
