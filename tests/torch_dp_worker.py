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


def run(fn, tmp_path, *args, world: int = 2, timeout_s: float = RANK_TIMEOUT_S) -> list:
    """``fn(rank, *args)`` on ``world`` gloo ranks; the results by rank."""
    rdzv = os.path.join(str(tmp_path), f"rdzv_{uuid.uuid4().hex}")
    return run_local_ranks(fn, world, f"file://{rdzv}", args, backend="gloo",
                           timeout_s=timeout_s)


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


def dp_graph_rank(rank: int, out_dir: str, device: str = "cuda") -> dict:
    """A ``Trainer(dp=True)`` under its default driver and one under the loop
    (``scan_epochs=False``) on this rank, from one seed, on 64x64 pools of 3
    domains x 4N at batch 6N = 3 x 2N over the N ranks (2 items a domain a
    rank, 2 steps an epoch): their run_meta drivers; each step of one epoch
    of both, whether the batches are bitwise equal, and the first step's
    metrics of each; the launch counters' moves over a replayed epoch and
    the graph's launches a step; then the graphed run's ``train()`` to its
    checkpoint (a validation after epoch 3) and a resume of that checkpoint
    under the loop for one more epoch: the step counts, the losses and a
    digest of the graphed run's state (the graphed run's step count includes
    the epoch and a half before ``train()``); and the checkpoint restored
    under the DP graph (its state against the loop's restore) for 3 epochs
    with ``nan_recovery``, the second epoch's loss made non-finite: whether
    the rollback put back the state after the first, in the same tensors.
    Rank 0 writes the run directories; the others report their drivers from
    ``scan_epochs``."""
    import json

    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.data.fundus import FundusDomain
    from wt_pse_tpu_torch.ops.cuda_lib import launch_counts
    from wt_pse_tpu_torch.train.graph import COUNTED
    from wt_pse_tpu_torch.train.trainer import Trainer

    world = torch.distributed.get_world_size()
    r = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:64]
    gray = np.full((64, 64), 255, np.uint8)
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 300] = 128
    gray[(yy - 30) ** 2 + (xx - 34) ** 2 < 80] = 0
    doms = [FundusDomain(images=r.randint(0, 256, (4 * world, 64, 64, 3)).astype(np.uint8),
                         labels=np.stack([gray] * 4 * world)) for _ in range(3)]

    def trainer(name: str, **kw):
        kw = dict(dict(batch_size=6 * world, max_epoch=4, interval_validate=4, eval_batch_size=2,
                       image_size=64, val_visualization=False, dp=True, device=device), **kw)
        t = Trainer(default_hparams("WT_PSE"), doms, doms[0], os.path.join(out_dir, name), **kw)
        if rank:  # rank 0 writes the run directory
            return t, "graph" if t.scan_epochs else "eager"
        with open(os.path.join(t.out, "run_meta.json")) as f:
            return t, json.load(f)["driver"]

    (graph, g_driver), (loop, l_driver) = trainer("graph"), trainer("loop", scan_epochs=False)
    out = {"drivers": [g_driver, l_driver], "graphed": graph._graph is not None,
           "same_batches": []}
    for t in (graph, loop):
        t._gen.manual_seed(123)
    for it in range(graph.iter_per_epoch):
        mg, ml = graph.epoch_step(it, 1), loop.epoch_step(it, 1)
        out["same_batches"].append(all(torch.equal(graph.last_batch[k], v)
                                       for k, v in loop.last_batch.items()))
        if it == 0:
            out["first_step"] = [{k: float(v[0]) for k, v in m.items()} for m in (mg, ml)]
    torch.cuda.synchronize()
    before = launch_counts(COUNTED)
    graph.epoch_step(0, graph.iter_per_epoch)
    torch.cuda.synchronize()
    out["launches_an_epoch"] = {f"{n}.{a}": c - before[n, a]
                                for (n, a), c in launch_counts(COUNTED).items()
                                if c != before[n, a]}
    out["launches_a_step"] = {f"{n}.{a}": c for (n, a), c in
                              graph._graph.launches_per_step.items() if c}
    out["iter_per_epoch"] = graph.iter_per_epoch
    del loop
    graph.train()
    out["step"], out["digest"] = graph.state.step, state_digest(graph.state)
    ckpt = os.path.join(graph.out, "checkpoint_4.pth.tar")
    out["checkpoint"] = os.path.exists(ckpt)
    epoch = graph.state.step // graph.iter_per_epoch
    resumed, r_driver = trainer("resumed", resume=ckpt, scan_epochs=False, max_epoch=epoch + 1,
                                interval_validate=99)
    # the same checkpoint restored in place under the DP graph, before its capture
    again, a_driver = trainer("resumed_graph", resume=ckpt, max_epoch=epoch + 3,
                              interval_validate=99, nan_recovery=True)
    out["resumed_graph"] = {"driver": a_driver, "restored_alike": all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(_live(resumed.state), _live(again.state)))}
    start = resumed.state.step
    resumed.train()
    finite = all(bool(torch.isfinite(p).all()) for ns in resumed.state.net_states()
                 for p in ns.net.parameters())
    if rank == 0:
        with open(os.path.join(resumed.out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if "loss_seg" in line]
        finite = finite and len(recs) == 1 and all(np.isfinite(v) for k, v in recs[0].items()
                                                   if k != "step")
    out["resumed"] = {"driver": r_driver, "start": start, "step": resumed.state.step,
                      "finite": finite}

    # nan_recovery under the DP graph: the second epoch's loss made
    # non-finite on every rank, the state rolled back into the graph's tensors
    real, seen = again.epoch_step, []

    def flaky(first_step: int, n_steps: int) -> dict:
        seen.append([(t.data_ptr(), t.clone()) for t in _live(again.state)])
        metrics = real(first_step, n_steps)
        if len(seen) == 2:
            metrics = dict(metrics, loss_seg=torch.full_like(metrics["loss_seg"], float("nan")))
        return metrics

    again.epoch_step = flaky
    again.train()
    before, after = seen[1], seen[2]
    out["resumed_graph"].update(
        epochs=len(seen), rollbacks=again._rollbacks,
        rolled_back=len(before) == len(after) and all(
            p0 == p1 and torch.equal(x0, x1) for (p0, x0), (p1, x1) in zip(before, after)),
        finite=all(bool(torch.isfinite(p).all()) for ns in again.state.net_states()
                   for p in ns.net.parameters()))
    return out


def launched_dp_graph_rank(rank: int, out_dir: str) -> dict:
    """:func:`dp_graph_rank` on this rank, as the training CLI's launcher
    starts it; every rank's record, gathered, by rank."""
    res = dp_graph_rank(rank, out_dir)
    ranks = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(ranks, res)
    return {"ranks": ranks}


def _live(state) -> list:
    """The tensors of a training state, as they are held: each net's
    parameters and buffers, each optimizer's state."""
    return [t for ns in state.net_states() for t in list(ns.net.state_dict().values()) +
            [v for st in ns.opt.state.values() for v in st.values()]]


def graph_driver_dp_rank(rank: int, domains, out_dir: str, seed: int) -> dict:
    """The graph driver's pieces under data parallelism on this rank, on the
    CPU (``tests/test_torch_graph_driver_dp.py``), each with ``Trainer(dp=True,
    batch_size=6)`` on ``domains`` (one item a domain a rank):

    - ``loop``: the eager loop's per-step metrics through ``train()`` (2
      epochs) and a digest of its state; ``body``: the same 2 epochs through
      ``GraphedStep.body`` with the DP step and the rank-seeded sampler, the
      generator seeded as ``_train_epoch`` seeds it;
    - ``prepare``: whether ``GraphedStep.prepare`` left the nets, the step
      count and the generator as they were, which parameters' Adam state it
      created (by index, each net) beside those the loop's steps created,
      and a digest of that state;
    - ``resolution``: ``scan_epochs=True`` (the ValueError), ``None`` and
      ``False`` (the driver chosen and run_meta's record on rank 0)."""
    import json

    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.parallel.dp import rank_seed
    from wt_pse_tpu_torch.train.graph import GraphedStep
    from wt_pse_tpu_torch.train.trainer import Trainer, _draw_seed

    def trainer(name: str, **kw) -> Trainer:
        return Trainer(default_hparams("WT_PSE"), domains, domains[0],
                       os.path.join(out_dir, f"{name}_rank{rank}"), batch_size=6, max_epoch=2,
                       interval_validate=99, seed=seed, val_visualization=False, dp=True,
                       device="cpu", **kw)

    def graphed(t: Trainer) -> GraphedStep:
        probe = t._batch_fn(t.data, torch.Generator().manual_seed(0))
        return GraphedStep(t.state, t._train_step, probe, capacity=t.iter_per_epoch,
                           batch_fn=t._batch_fn, data=t.data, generator=t._gen)

    def numpy(metrics: dict) -> dict:
        return {k: v.numpy().copy() for k, v in metrics.items()}

    def nets(state) -> list:
        return [t.clone() for ns in state.net_states() for t in ns.net.state_dict().values()]

    def with_state(state) -> list:
        return [[i for i, p in enumerate(ns.net.parameters()) if p in ns.opt.state]
                for ns in state.net_states()]

    loop = trainer("loop")
    stacks, real = [], loop.epoch_step

    def recording(first_step: int, n_steps: int) -> dict:
        metrics = real(first_step, n_steps)
        stacks.append(numpy(metrics))
        return metrics

    loop.epoch_step = recording
    loop.train()

    body = trainer("body")
    gs, got = graphed(body), []
    for epoch in range(2):
        body._gen.manual_seed(rank_seed(_draw_seed(seed, epoch, 0), body.mesh))
        gs.rewind()
        for _ in range(body.iter_per_epoch):
            gs.body()
        got.append(numpy(gs.read(body.iter_per_epoch)))
    out = {"loop": stacks, "body": got, "iter_per_epoch": body.iter_per_epoch,
           "digests": [state_digest(loop.state), state_digest(body.state)],
           "steps": [loop.state.step, body.state.step]}

    fresh = trainer("prepare")
    fresh._gen.manual_seed(99)
    before = nets(fresh.state), fresh._gen.get_state(), fresh.state.step
    empty = with_state(fresh.state)
    graphed(fresh).prepare()
    out["prepare"] = {
        "nets_unchanged": all(torch.equal(a, b) for a, b in zip(before[0], nets(fresh.state))),
        "generator_unchanged": torch.equal(before[1], fresh._gen.get_state()),
        "step_unchanged": before[2] == fresh.state.step,
        "with_state_before": empty, "with_state": with_state(fresh.state),
        "loop_with_state": with_state(loop.state), "digest": state_digest(fresh.state)}

    res = {}
    try:
        trainer("true", scan_epochs=True)
        res["true"] = "built"
    except ValueError as e:
        res["true"] = str(e)
    for name, scan in (("none", None), ("false", False)):
        t = trainer(name, scan_epochs=scan)
        res[name] = {"scan_epochs": t.scan_epochs, "graph": t._graph is not None}
        if rank == 0:
            with open(os.path.join(t.out, "run_meta.json")) as f:
                res[name]["driver"] = json.load(f)["driver"]
    out["resolution"] = res
    return out


def graph_body_fed_rank(rank: int, hp: dict, state_dicts: dict, batches_ranks,
                        domain_num: int, pdb_global: int) -> dict:
    """``GraphedStep.body`` on fed buffers (no sampler) running the DP step
    (``make_dp_fused``) for ``len(batches_ranks[rank])`` consecutive steps,
    each on this rank's batch of that step, from the four nets'
    ``state_dicts``: the metric columns of the body's buffer (meaned over
    the ranks), the nets' state_dicts after the last step and a digest of
    the whole state."""
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.parallel.dp import make_dp_fused
    from wt_pse_tpu_torch.train.graph import GraphedStep
    from wt_pse_tpu_torch.train.state import init_ensemble

    mesh = data_mesh()
    state = init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh), device="cpu")
    names = ("od", "od_shape", "oc", "oc_shape")
    for name, ns in zip(names, state.net_states()):
        ns.net.load_state_dict(state_dicts[name], strict=True)
    step = make_dp_fused([ns.net for ns in state.net_states()], hp, mesh, domain_num,
                         pdb_global, device="cpu")
    batches = [{k: _t(v) for k, v in b.items()} for b in batches_ranks[rank]]
    gs = GraphedStep(state, step.train_step, batches[0], capacity=len(batches))
    for b in batches:
        for k, v in b.items():
            gs.batch[k].copy_(v)
        gs.body()
    return {"metrics": {k: v.numpy().copy() for k, v in gs.read(len(batches)).items()},
            "step": state.step,
            "state_dicts": {name: {k: v.numpy().copy() for k, v in ns.net.state_dict().items()}
                            for name, ns in zip(names, state.net_states())},
            "digest": state_digest(state)}


def cli_rank(rank: int, argv: list, probe_dir: str, flaky_epoch: int | None = None) -> dict:
    """The training CLI's rank (``cli/train.py::rank_main``) as its launcher
    runs it, on the CPU at 32x32: the Fundus loader decodes at 32x32 (the
    CLI's decodes at 256x256) and the Trainer's network-resolution masks
    match. ``argv`` is parsed as the CLI parses it. After each run of the
    Trainer, this rank appends its state digest, step count, epochs and
    rollbacks to ``probe_dir/rank{rank}.json``. ``flaky_epoch``: that
    epoch's loss is made non-finite the first time it trains
    (``--nan-recovery`` rolls it back). Returns the CLI's result."""
    import functools
    import json

    from wt_pse_tpu_torch.cli import train as cli
    from wt_pse_tpu_torch.train.trainer import Trainer

    domains, fundus = cli.load_train_domains, cli.load_fundus
    cli.load_train_domains = lambda *a: domains(*a, size=32)
    cli.load_fundus = lambda *a, **k: fundus(*a, size=32, **k)
    cli.Trainer = functools.partial(Trainer, image_size=32)
    runs, train, train_epoch = [], Trainer.train, Trainer._train_epoch

    def probed_train(self):
        best = train(self)
        runs.append({"digest": state_digest(self.state), "step": self.state.step,
                     "epochs": len(self.epoch_seconds), "rollbacks": self._rollbacks,
                     "dp": self.dp, "n_dev": self.n_dev})
        with open(os.path.join(probe_dir, f"rank{rank}.json"), "w") as f:
            json.dump(runs, f)
        return best

    def flaky_train_epoch(self, epoch: int) -> dict:
        metrics = train_epoch(self, epoch)
        if epoch == flaky_epoch and not self._rollbacks:
            metrics = dict(metrics, loss_seg=float("nan"))
        return metrics

    Trainer.train, Trainer._train_epoch = probed_train, flaky_train_epoch
    args, left = cli.build_parser().parse_known_args(argv)
    return cli.rank_main(rank, args, left)


def failing_rank(rank: int, how: str) -> int:
    """Rank 1 raises (``how="raise"``) or ends its process with code 3
    (``"exit"``) half a second in; every other rank sleeps two minutes, as a
    rank waiting on the failed one would."""
    import time

    if rank == 1:
        time.sleep(0.5)
        if how == "exit":
            os._exit(3)
        raise ValueError("rank 1 fails")
    time.sleep(120)
    return rank
