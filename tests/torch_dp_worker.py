"""Rank workers of the port's data-parallel tests (``tests/test_torch_dp*.py``).

Each ``*_rank`` function runs in a fresh process spawned by
``wt_pse_tpu_torch.parallel.distributed.run_local_ranks``, as one gloo rank
of a file-rendezvous process group, with one torch thread. This module
imports no JAX: the ranks start fast and stay small. Arrays cross as numpy,
NCHW; each rank takes its rows of the arrays it is given.
"""

from __future__ import annotations

import hashlib
import os
import uuid

import numpy as np
import torch

from wt_pse_tpu_torch.parallel.distributed import run_local_ranks
from wt_pse_tpu_torch.parallel.mesh import data_mesh

RANK_TIMEOUT_S = 55.0  # a hung collective fails the test inside a minute


def run(fn, tmp_path, *args, world: int = 2) -> list:
    """``fn(rank, *args)`` on ``world`` gloo ranks; the results by rank."""
    rdzv = os.path.join(str(tmp_path), f"rdzv_{uuid.uuid4().hex}")
    return run_local_ranks(fn, world, f"file://{rdzv}", args, backend="gloo",
                           timeout_s=RANK_TIMEOUT_S)


def state_digest(state) -> str:
    """A hash of every parameter, buffer and optimizer state tensor of the
    four nets: equal digests are bitwise-equal states."""
    h = hashlib.sha256()
    for ns in state.net_states():
        for name, t in ns.net.state_dict().items():
            h.update(name.encode() + t.detach().cpu().contiguous().numpy().tobytes())
        for i, st in sorted(ns.opt.state_dict()["state"].items()):
            for k, v in sorted(st.items()):
                h.update(f"{i}{k}".encode() + torch.as_tensor(v).cpu().numpy().tobytes())
    return h.hexdigest()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def bn_rank(rank: int, x_ranks, w_ranks) -> dict:
    """Sync BN on this rank's (N, C, H, W) rows: output, running statistics
    and the input gradient of ``sum(out * w)``."""
    from wt_pse_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(x_ranks[rank].shape[1])
    bn.mesh = data_mesh()
    x = _t(x_ranks[rank]).requires_grad_()
    out = bn(x)
    (out * _t(w_ranks[rank])).sum().backward()
    return {"out": out.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "grad": x.grad.numpy(),
            "tracked": int(bn.num_batches_tracked)}


def whitening_rank(rank: int, maps_ranks, domain_num: int, pdb: int) -> dict:
    """The main and student whitening losses on this rank's three maps, and
    the gradients with respect to the maps of ``main_total`` and
    ``student_total`` (the sums of each function's terms with the weights
    below)."""
    from wt_pse_tpu_torch.ops.whitening import main_whitening_loss, student_whitening_loss

    mesh = data_mesh()
    out = {}
    for name in ("main", "student"):
        maps = [_t(m).requires_grad_() for m in maps_ranks[rank]]
        if name == "main":
            terms = main_whitening_loss(maps, domain_num, pdb, 0.1, True, mesh)
            weights = (1.0, 2.0)
        else:
            terms = student_whitening_loss(maps, domain_num, pdb, 0.1, True, mesh)
            weights = (1.0, 0.5, 3.0, 2.0)
        sum(w * t for w, t in zip(weights, terms)).backward()
        out[name] = [float(t) for t in terms]
        out[name + "_grads"] = [m.grad.numpy() if m.grad is not None else None for m in maps]
    return out


def step_rank(rank: int, hp: dict, state_dicts: dict, batch_ranks, eps_ranks,
              domain_num: int, pdb_global: int) -> dict:
    """One data-parallel step (``make_dp_fused``'s train step) on this rank's
    batch and draws, from the four nets' ``state_dicts``. Returns the
    metrics (meaned over the ranks), the nets' state_dicts after it and a
    digest of the whole state."""
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.parallel.dp import make_dp_fused
    from wt_pse_tpu_torch.train.state import init_ensemble

    mesh = data_mesh()
    state = init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh), device="cpu")
    for name, ns in zip(("od", "od_shape", "oc", "oc_shape"), state.net_states()):
        ns.net.load_state_dict(state_dicts[name], strict=True)
    step = make_dp_fused([ns.net for ns in state.net_states()], hp, mesh, domain_num,
                         pdb_global, device="cpu")
    batch = {k: _t(v) for k, v in batch_ranks[rank].items()}
    eps = {k: _t(v) for k, v in eps_ranks[rank].items()} if eps_ranks else None
    metrics = step.train_step(state, batch, eps=eps)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dicts": {name: {k: v.numpy().copy() for k, v in ns.net.state_dict().items()}
                            for name, ns in zip(("od", "od_shape", "oc", "oc_shape"),
                                                state.net_states())},
            "digest": state_digest(state)}


def trainer_rank(rank: int, train, val, out_dirs, kw: dict) -> dict:
    """A ``Trainer`` on this rank (out directory ``out_dirs[rank]``): its DP
    decision, or the ``ValueError`` it raises; with ``kw['max_epoch']``,
    ``train()`` and one ``validate()``."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.train.trainer import Trainer

    try:
        t = Trainer(default_hparams("WT_PSE"), train, val, out_dirs[rank], device="cpu",
                    **kw)
    except ValueError as e:
        return {"error": str(e)}
    out = {"dp": t.dp, "n_dev": t.n_dev}
    if kw.get("max_epoch"):
        t.train()
        out.update(val=t.validate(), digest=state_digest(t.state),
                   step=t.state.step, best=t.best)
    return out


def decisions_rank(rank: int, train, val, out_dirs, kws) -> list:
    """Each of ``kws`` built into a ``Trainer`` on this rank: its (dp, n_dev)
    or the ``ValueError`` it raises, in order."""
    out = []
    for i, kw in enumerate(kws):
        res = trainer_rank(rank, train, val, [f"{d}_{i}" for d in out_dirs], kw)
        out.append(res.get("error") or (res["dp"], res["n_dev"]))
    return out


def seg_phase_rank(rank: int, hp: dict, od_state_dict: dict, batch_ranks, eps_ranks,
                   domain_num: int) -> dict:
    """Phase 1 of the step (OD segmentation with the whitening losses) over
    the mesh on this rank's batch and draw, from ``od_state_dict``: the
    metrics meaned over the ranks and the OD net after its update."""
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.models.wt_pse import WTPSE
    from wt_pse_tpu_torch.parallel.collectives import mean_values
    from wt_pse_tpu_torch.train.state import NetState
    from wt_pse_tpu_torch.train.step import StepConfig, _seg_phase, bce_probs

    mesh = data_mesh()
    ns = NetState.create(WTPSE(ModelConfig.from_hparams(hp, bn_mesh=mesh), device="cpu"), 5e-4)
    ns.net.load_state_dict(od_state_dict, strict=True)
    b = {k: _t(v) for k, v in batch_ranks[rank].items()}
    cfg = StepConfig(hp, domain_num, b["image"].shape[0] // domain_num, mesh=mesh)
    _, metrics = _seg_phase(ns, b["image"], b["target_od"], b["image"],
                            lambda out: bce_probs(out, b["target_od"]), cfg,
                            _t(eps_ranks[rank]), None)
    return {"metrics": {k: float(v) for k, v in mean_values(metrics, mesh).items()},
            "state_dict": {k: v.numpy().copy() for k, v in ns.net.state_dict().items()},
            "digest": hashlib.sha256(b"".join(
                v.numpy().tobytes() for v in ns.net.state_dict().values())).hexdigest()}


def halo_rank(rank: int, slabs) -> dict:
    """``halo_rows`` of this rank's slab with either fill, and the exchanges
    counted over the two calls."""
    from wt_pse_tpu_torch.parallel.collectives import halo_rows

    mesh = data_mesh()
    x = _t(slabs[rank])
    before = halo_rows.exchanges
    out = {fill: halo_rows(x, mesh, fill).numpy() for fill in ("zero", "replicate")}
    bf16 = halo_rows(x.to(torch.bfloat16), mesh, "zero")
    out["bf16_dtype"] = str(bf16.dtype)
    out["bf16"] = bf16.float().numpy()
    out["exchanges"] = halo_rows.exchanges - before
    return out


def spatial_rank(rank: int, cases, device: str = "cpu") -> list:
    """``spatial_sharded`` two-stage predicts on this rank, on ``device``, one
    a case of (algorithm, compute dtype, the 4 nets' state_dicts, NCHW image):
    each case's (od, oc) logits for the whole image and its halo exchanges."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.parallel.collectives import halo_rows
    from wt_pse_tpu_torch.parallel.spatial import spatial_sharded
    from wt_pse_tpu_torch.train.eval import make_predict_fn_for
    from wt_pse_tpu_torch.train.state import init_ensemble

    mesh = data_mesh()
    out = []
    for algorithm, dtype, state_dicts, image in cases:
        hp = dict(default_hparams(algorithm), compute_dtype=dtype)
        state = init_ensemble(ModelConfig.from_hparams(hp), device=device, algorithm=algorithm)
        nets = [ns.net for ns in state.net_states()]
        for net, sd in zip(nets, state_dicts):
            net.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
        before = halo_rows.exchanges
        od, oc = spatial_sharded(make_predict_fn_for(algorithm, nets, device=device), mesh)(
            _t(image).to(device))
        out.append({"od": od.cpu().numpy(), "oc": oc.cpu().numpy(),
                    "exchanges": halo_rows.exchanges - before})
    return out
