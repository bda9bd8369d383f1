"""The port's 1-D ``('data',)`` mesh (counterpart of ``wt_pse_tpu/parallel/mesh.py``).

JAX's mesh is a set of devices that one program spans. The port has two:

- :class:`DataMesh`, a set of processes, one per card: the process group of
  ranks ``0 .. size-1``, which sync BatchNorm, the gradient mean, the
  ``pos_weight`` sum and the MMD gather run over (``parallel/collectives.py``);
- :class:`LocalMesh`, a set of this one process's devices
  (``data_mesh(devices=...)``, as JAX's ``data_mesh(n, devices=...)``), which
  the sharded predicts of ``parallel/spatial.py`` span with one thread a
  shard. Shard ``r`` sees it as ``DataMesh(<its LocalGroup>, r, N,
  devices[r])``, so every collective takes it unchanged. It serves
  inference only: training across the cards of one process is not ported
  (``ROADMAP.md``, Queue 1 item 24), and training code refuses it
  (:func:`refuse_local`).
"""

from __future__ import annotations

import dataclasses
import threading

import torch
import torch.distributed as dist

from wt_pse_tpu_torch.parallel.distributed import rank_and_world


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """``group``: the process group of ranks ``0 .. size-1``, a
    :class:`LocalGroup` (a shard's view of a :class:`LocalMesh`), or None for
    a mesh of one process that has no process group (every collective is
    then the identity). ``rank``: this process's (or shard's) rank; a rank
    ``>= size`` is not in the mesh. ``device``: where collectives stage host
    values (the current card under NCCL, the CPU under gloo, the shard's
    device in a local group).

    A mesh is shared, never copied: the BatchNorm layers of a net hold it, and
    a deep copy of the net (a snapshot of the train state) keeps the same
    one."""

    group: object | None
    rank: int
    size: int
    device: torch.device

    def __deepcopy__(self, memo) -> "DataMesh":
        return self


BARRIER_TIMEOUT_S = 120.0  # a shard that never arrives breaks its group's barrier


class LocalGroup:
    """The in-process group of a :class:`LocalMesh`: its devices (they may
    repeat: several shards on one card, or on the CPU, play the part of
    JAX's virtual devices), a barrier of one party a shard and a slot a
    shard. ``threading.Barrier``'s timeout is a last guard; a shard that
    fails calls :meth:`abort`, so that the others raise
    ``BrokenBarrierError`` at their next wait instead of waiting.

    Every shard runs on its device's default stream, so a tensor that one
    shard deposits is read (a copy between devices orders itself against
    the current streams of both) and freed (the caching allocator reuses a
    block on the stream that made it) in the order the barriers set, with
    no host synchronization."""

    def __init__(self, devices: list[torch.device]):
        self.devices = list(devices)
        self.barrier = threading.Barrier(len(self.devices), timeout=BARRIER_TIMEOUT_S)
        self.slots: list[torch.Tensor | None] = [None] * len(self.devices)
        self.lock = threading.Lock()  # one sharded call at a time over the mesh
        self._subgroups: dict[int, LocalGroup] = {}

    def sub(self, k: int) -> "LocalGroup":
        """The group of the first ``k`` devices (cached; itself for all)."""
        if k == len(self.devices):
            return self
        if k not in self._subgroups:
            self._subgroups[k] = LocalGroup(self.devices[:k])
        return self._subgroups[k]

    def sum_(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """All-reduce-sum of ``t`` in place: every shard sums every slot in
        rank order on its own device, so each gets bitwise the same sum."""
        self.slots[rank] = t
        self.barrier.wait()
        acc = self.slots[0].to(t.device, copy=True)
        for other in self.slots[1:]:
            acc += other.to(t.device)
        self.barrier.wait()  # every shard has read every slot
        self.slots[rank] = None
        return t.copy_(acc)

    def abort(self) -> None:
        for g in (self, *self._subgroups.values()):
            g.barrier.abort()

    def reset(self) -> None:
        """Ready for the next call once every shard has stopped."""
        for g in (self, *self._subgroups.values()):
            g.barrier.reset()
            g.slots = [None] * len(g.devices)


@dataclasses.dataclass(frozen=True, eq=False)
class LocalMesh:
    """A mesh of this one process's ``devices``, in order
    (``data_mesh(devices=...)``). :meth:`shard` is shard ``r``'s view."""

    group: LocalGroup

    @property
    def devices(self) -> list[torch.device]:
        return self.group.devices

    @property
    def size(self) -> int:
        return len(self.group.devices)

    def shard(self, rank: int, k: int | None = None) -> DataMesh:
        """Shard ``rank``'s view of the mesh of the first ``k`` devices
        (all of them when None)."""
        group = self.group.sub(self.size if k is None else k)
        return DataMesh(group, rank, len(group.devices), group.devices[rank])


def refuse_local(mesh, what: str) -> None:
    """Raise ``ValueError`` if ``mesh`` is a :class:`LocalMesh` or a shard's
    view of one: ``what`` (training code) runs over a process group only."""
    if isinstance(mesh, LocalMesh) or isinstance(getattr(mesh, "group", None), LocalGroup):
        raise ValueError(
            f"{what} got a mesh of one process's devices (data_mesh(devices=...)), which "
            "serves the sharded predicts only; training across the cards of one process "
            "is not ported (ROADMAP.md, Queue 1 item 24): start one rank a card "
            "(torchrun, or the training CLI, which starts them itself)")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's index: shards on one card share it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh | LocalMesh:
    """With ``devices``: the :class:`LocalMesh` of those devices of this
    process, in order, cut to the first ``n_devices``, as JAX's
    ``data_mesh(n_devices, devices=...)``.

    Without: the mesh of the first ``n_devices`` ranks of the process group
    (all of them when None). Every rank of the group must call it: a mesh
    smaller than the group makes a new group, which is collective (under
    NCCL bound to a card, ``initialize_multihost``, its communicator is made
    here, split from the group's, and not at its first collective, which a
    CUDA graph capture could not hold). Without a process group, the mesh of
    this one process (``n_devices`` None or 1)."""
    if devices is not None:
        devs = [_indexed(torch.device(d)) for d in devices][:n_devices]
        if not devs:
            raise ValueError(f"a data mesh needs a device; got devices={devices!r}, "
                             f"n_devices={n_devices}")
        return LocalMesh(LocalGroup(devs))
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
