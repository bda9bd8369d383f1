"""Data parallelism for the 4-phase train step (counterpart of
``wt_pse_tpu/parallel/dp.py``).

- One process per card, the ranks of a :class:`~wt_pse_tpu_torch.parallel.mesh.DataMesh`;
  the state (four nets and their Adams, about 8M parameters) is replicated:
  every rank holds bitwise the same parameters, optimizer state and
  BatchNorm statistics after every step;
- each rank samples its own ``per_domain_batch // N`` items per domain from
  the device-resident pools, so every domain is on every rank and the MMD's
  domain-contiguous slicing holds;
- what crosses ranks each step: the gradient mean of each phase, the sync
  BatchNorm statistics, the ``pos_weight`` sums (2 scalars) and the MMD
  vectors (B x 120 floats), all hand-written collectives
  (``parallel/collectives.py``), not DDP: DDP assumes one forward and
  backward a module an iteration, and the step runs four optimizers and
  train-mode teachers under ``no_grad``;
- semantics: a step on N ranks is one step on the same global batch, split
  into equal shards (``tests/test_torch_dp.py``).
"""

from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple

import torch

from wt_pse_tpu_torch.data.augment import make_device_batch_fn
from wt_pse_tpu_torch.parallel.collectives import mean_values
from wt_pse_tpu_torch.parallel.mesh import DataMesh
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step


def rank_seed(seed: int, mesh: DataMesh | None) -> int:
    """The seed of this rank's generator: ``seed`` itself on a mesh of one
    rank (or none), so its stream is the single-device run's, and a 63-bit
    hash of (seed, rank) otherwise (JAX: ``fold_in(key, axis_index)``,
    skipped on one device, ``dp.py:71-76``)."""
    if mesh is None or mesh.size == 1:
        return seed
    digest = hashlib.sha256(f"{seed}:rank{mesh.rank}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class DPStep(NamedTuple):
    """The two halves of a data-parallel step, in the order a step calls
    them: ``batch = batch_fn(data, generator)`` samples this rank's share
    (seed the generator with :func:`rank_seed`), and ``train_step(state,
    batch, generator=generator, eps=None) -> metrics`` runs the step with the
    mesh's collectives and returns the metrics meaned over the ranks (JAX's
    fused ``device_fn``, ``dp.py:69-80``)."""

    batch_fn: Callable
    train_step: Callable


def make_dp_fused(nets, hparams: dict, mesh: DataMesh, domain_num: int,
                  per_domain_batch_global: int, replicate_ref_quirks: bool = True,
                  distill: bool = True, *, device: str | torch.device = "cuda") -> DPStep:
    """The data-parallel step over ``mesh`` for the four ``nets`` (od,
    od_shape, oc, oc_shape). Refuses a per-domain batch that the mesh size
    does not divide, and nets whose BatchNorm is not synchronised over
    ``mesh`` (``ModelConfig(bn_mesh=mesh)``): their running statistics would
    drift apart from rank to rank. ``distill=False`` is the joint variant's
    step."""
    n = mesh.size
    if per_domain_batch_global % n:
        raise ValueError(f"per-domain batch {per_domain_batch_global} not divisible by "
                         f"{n} ranks")
    for net in nets:
        if getattr(net.cfg, "bn_mesh", None) is not mesh:
            raise ValueError(
                f"{type(net).__name__} was built with bn_mesh="
                f"{getattr(net.cfg, 'bn_mesh', None)!r}; data-parallel training needs "
                "ModelConfig(bn_mesh=mesh) so that BatchNorm statistics are synchronised "
                "over the mesh (sync BN)")
    pdb_local = per_domain_batch_global // n
    step = make_train_step(StepConfig(hparams, domain_num, pdb_local, replicate_ref_quirks,
                                      distill=distill, mesh=mesh), device=device)

    def train_step(state, batch, generator=None, eps=None):
        return mean_values(step(state, batch, generator=generator, eps=eps), mesh)

    return DPStep(make_device_batch_fn(pdb_local, device=device), train_step)


def choose_ranks(dp: bool | None, dp_devices: int | None, per_domain_batch: int,
                 world: int) -> tuple[bool, int]:
    """(data parallel?, N), decided as the JAX Trainer decides them
    (``trainer.py:156-190``) over the ``world`` ranks of the process group:

    - ``dp=None`` (auto) turns data parallelism on when the group has more
      than one rank, over ``min(dp_devices or world, world)`` ranks, and then
      falls to the largest N that divides the per-domain batch; at N = 1 it
      is off;
    - an explicit ``dp=True`` takes N = ``dp_devices or world``, raises
      ``ValueError`` if N does not divide the per-domain batch, and raises if
      the group has fewer than N ranks (JAX caps N at the devices it sees; a
      torch process sees only the ranks torchrun started);
    - ``dp=False``: one device."""
    auto = dp is None
    if auto:
        dp = world > 1
    if not dp:
        return False, 1
    n = dp_devices or world
    if auto:
        n = min(n, world)
    if per_domain_batch % n:
        if not auto:
            raise ValueError(
                f"data parallelism needs per-domain batch {per_domain_batch} "
                f"(batch_size // domains) divisible by the {n}-rank mesh; pick batch_size "
                f"as a multiple of the domain count times {n}, or set dp_devices")
        start = n
        while per_domain_batch % n:
            n -= 1
        print(f"[trainer] auto-DP: per-domain batch {per_domain_batch} not divisible by "
              f"{start} ranks - using {n} (pass dp=True to make this an error)")
    if n > world:
        raise ValueError(f"dp_devices={n} asks for {n} ranks, but the process group has "
                         f"{world}: launch them with torchrun --nproc-per-node {n}")
    return not (auto and n == 1), n
