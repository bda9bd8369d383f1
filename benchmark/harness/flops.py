"""The operations of one training step, counted by the benchmark itself: a
``FlopCounterMode`` over the frozen reference's step (``reference/step.py``)
on the ``meta`` device, at the configuration's shapes. It counts the
convolutions (forward and both backward products) and the matrix products
(the augmentation's resampling, the covariance, the MMD), as PyTorch's flop
counter defines them; elementwise work, BatchNorm and the Adam updates are
not counted. The configuration file stores the result, and a CPU test
recounts it, so a change to how the program computes the step cannot move
the yardstick."""

from __future__ import annotations

import torch


class _NoUpdate:
    """An optimizer that updates nothing: updates are not counted, and
    ``meta`` tensors hold no values to update."""

    def zero_grad(self, set_to_none: bool = True) -> None:
        pass

    def step(self) -> None:
        pass


def step_shapes(cfg: dict, traffic: dict) -> tuple[int, int, int]:
    """(domains, images a domain in a batch, image side) of a cell."""
    domains = len(traffic["pools"])
    return domains, cfg["batch_size"] // domains, cfg["image_size"]


def count_step_flops(cfg: dict, traffic: dict) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from reference.nets import Policy, build
    from reference.step import train_step

    domains, per_domain, hw = step_shapes(cfg, traffic)
    nmax = max(traffic["pools"])
    policy = Policy(cfg["precision"])
    nets = build(cfg, policy, "meta")
    pools = {"images": torch.empty((domains, nmax, hw, hw, 3), dtype=torch.uint8, device="meta"),
             "labels": torch.empty((domains, nmax, hw, hw), dtype=torch.uint8, device="meta"),
             "sizes": torch.empty((domains,), dtype=torch.int64, device="meta")}
    with FlopCounterMode(display=False) as counter:
        train_step(nets, {k: _NoUpdate() for k in nets}, pools, domains, per_domain, policy,
                   None)
    return int(counter.get_total_flops())


def count_params(cfg: dict) -> int:
    from reference.nets import Policy, build

    return sum(p.numel() for net in build(cfg, Policy(cfg["precision"]), "meta").values()
               for p in net.parameters())
