"""The port's 1-D ``('data',)`` mesh (counterpart of ``wt_pse_tpu/parallel/mesh.py``).

JAX's mesh is a set of devices that one program spans. The port's is a set
of processes, one per card: the process group of ranks ``0 .. size-1``,
which sync BatchNorm, the gradient mean, the ``pos_weight`` sum and the MMD
gather run over (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from wt_pse_tpu_torch.parallel.distributed import rank_and_world


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """``group``: the process group of ranks ``0 .. size-1``, or None for a
    mesh of one process that has no process group (every collective is then
    the identity). ``rank``: this process's rank; a rank ``>= size`` is not
    in the mesh. ``device``: where collectives stage host values (the current
    card under NCCL, the CPU under gloo).

    A mesh is shared, never copied: the BatchNorm layers of a net hold it, and
    a deep copy of the net (a snapshot of the train state) keeps the same
    one."""

    group: object | None
    rank: int
    size: int
    device: torch.device

    def __deepcopy__(self, memo) -> "DataMesh":
        return self


def data_mesh(n_devices: int | None = None) -> DataMesh:
    """The mesh of the first ``n_devices`` ranks of the process group (all of
    them when None). Every rank of the group must call it: a mesh smaller
    than the group makes a new group, which is collective (under NCCL bound
    to a card, ``initialize_multihost``, its communicator is made here, split
    from the group's, and not at its first collective, which a CUDA graph
    capture could not hold). Without a process group, the mesh of this one
    process (``n_devices`` None or 1)."""
    rank, world = rank_and_world()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a data mesh of {n} ranks needs a process group of at least "
                         f"{n}; this one has {world} (start the ranks with torchrun, "
                         "see parallel/distributed.py)")
    if not dist.is_initialized():
        return DataMesh(None, 0, 1, torch.device("cpu"))
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return DataMesh(group, rank, n, device)
