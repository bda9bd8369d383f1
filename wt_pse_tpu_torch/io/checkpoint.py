"""Checkpoints in the reference's ``.pth.tar`` layout (counterpart of
``wt_pse_tpu/io/checkpoint.py`` and ``wt_pse_tpu/io/torch_import.py:89-152``).

A file holds the reference's four keys ``model`` / ``model_shape`` /
``model_oc`` / ``model_oc_shape`` (``Trainer.py:282-288``), each a port
net's ``state_dict`` (whose names are the reference's), plus ``optim`` (the
four optimizers' state_dicts) and ``step``, so a run resumes from it. The JAX
package's ``load_reference_checkpoint`` reads such a file as it reads the
reference's own. The optimizers are written in an eager Adam's layout (float
``lr``) whichever driver trained them, so a file of a graphed run resumes
under the eager loop and the other way round (``train/state.py``).
"""

from __future__ import annotations

import os

import torch

from wt_pse_tpu_torch.train.state import (WTPSETrainState, adam_state_for_file,
                                          load_adam_state_)

NET_KEYS = ("model", "model_shape", "model_oc", "model_oc_shape")


def _net_states(state: WTPSETrainState):
    return dict(zip(NET_KEYS, state.net_states()))


def save_ensemble(path: str, state: WTPSETrainState, **extra) -> None:
    """Write the four nets (as CPU tensors), the four optimizers and the step
    count to ``path``; ``extra`` adds keys. The file is written beside its
    final name and then moved there, so a cut-off save leaves no half file."""
    nets = _net_states(state)
    payload = {k: {n: t.detach().cpu() for n, t in ns.net.state_dict().items()}
               for k, ns in nets.items()}
    payload["optim"] = {k: adam_state_for_file(ns.opt) for k, ns in nets.items()}
    payload["step"] = int(state.step)
    payload.update(extra)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_ensemble(path: str, state: WTPSETrainState) -> WTPSETrainState:
    """Load nets, optimizers and step count from a file :func:`save_ensemble`
    wrote into ``state``, strictly, in place (a capturable Adam keeps its
    tensors: ``load_adam_state_``); returns ``state``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for k, ns in _net_states(state).items():
        ns.net.load_state_dict(ckpt[k], strict=True)
        load_adam_state_(ns.opt, ckpt["optim"][k])  # places the state by its params
    state.step = int(ckpt["step"])
    return state


def load_reference_checkpoint(path: str, state: WTPSETrainState,
                              strict: bool = False) -> dict[str, int]:
    """The reference's filtered partial load (``test_visulization.py:132-197``)
    of a ``.pth.tar`` into the nets of ``state``: a checkpoint entry loads
    where a net has an entry of that name and shape; the rest keep their
    values. ``strict=True`` raises if any checkpoint leaf finds no slot, the
    sign of a checkpoint trained for another algorithm or config.

    Returns the matched leaves per key, counted as the JAX importer counts
    them: parameters and BatchNorm statistics, not ``num_batches_tracked``
    (336 / 158 / 336 / 158 at width 16)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    counts = {}
    for k, ns in _net_states(state).items():
        if k not in ckpt:
            continue
        own = ns.net.state_dict()
        take, unmatched = {}, []
        for name, value in ckpt[k].items():
            if name in own and own[name].shape == value.shape:
                take[name] = value
            elif not name.endswith("num_batches_tracked"):
                unmatched.append(name)
        if strict and unmatched:
            raise ValueError(
                f"checkpoint/template mismatch in {k!r}: {len(unmatched)} checkpoint "
                f"leaves have no slot in the net (first: {unmatched[:6]}). Was the "
                "checkpoint trained with another algorithm or config?")
        ns.net.load_state_dict(take, strict=False)
        counts[k] = sum(1 for name in take if not name.endswith("num_batches_tracked"))
    return counts
