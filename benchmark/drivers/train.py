"""The training driver: how a window drives ``wt_pse_tpu_torch``'s Trainer.

Set-up (``setup_s``, from the process's start to the window's): the pools
and the four nets' weights from the seed (``harness/inputs.py``); the
Trainer on those pools, which captures its sample + step as a CUDA graph on a
card; the benchmark's weights loaded into its nets; then the first
``check_steps`` steps through the window's own entry, ``Trainer.epoch_step``,
on a generator seeded from the seed, read for the output check.

Window: whole epochs of ``Trainer._train_epoch`` back to back, as
``Trainer.train`` runs them without validation (the generator re-seeded,
``iter_per_epoch`` steps through ``epoch_step``, then the epoch's one
device-to-host copy of the metric stacks), until ``seconds`` have passed.
``train_img_per_s`` is every image stepped over the time from the window's
start to the end of its last epoch's copy.

With ``trace``, one more epoch runs under ``torch.profiler`` and the
per-layer readers run. Then the program's state is freed and the reference
follows the first steps (``harness/check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from harness import check
from harness.inputs import derive, make_pools, make_weights
from harness.trace import read_profile
from reference.nets import NETS, Policy, build

EPOCH_RANGE = "wtbench.epoch"


def weight_shapes(cfg: dict) -> dict:
    nets = build(cfg, Policy(cfg["precision"]), "meta")
    return {k: {n: tuple(t.shape) for n, t in net.state_dict().items()} for k, net in nets.items()}


def host_domains(pools: dict) -> list:
    """The pools as the Trainer takes them: one ``FundusDomain`` a site."""
    from wt_pse_tpu_torch.data.fundus import FundusDomain

    return [FundusDomain(images=pools["images"][i, :n].cpu().numpy(),
                         labels=pools["labels"][i, :n].cpu().numpy())
            for i, n in enumerate(pools["sizes"].tolist())]


def step_losses(stacks: dict) -> list[dict[str, float]]:
    names = sorted(k for k in stacks if k.startswith("loss_"))
    host = {k: stacks[k].cpu().double().numpy() for k in names}
    return [{k: float(host[k][i]) for k in names} for i in range(len(host[names[0]]))]


def log(t_start: float, what: str) -> None:
    print(f"[wtbench {time.perf_counter() - t_start:7.2f} s] {what}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    epochs: int
    steps: int
    window_s: float
    failed: int            # steps of epochs whose metrics came back non-finite
    ends_s: list[float]    # each epoch's end, from the window's start


def run_window(trainer, seconds: float, clock=time.perf_counter) -> Window:
    """Whole epochs of ``trainer._train_epoch`` back to back, from epoch 0,
    until ``seconds`` have passed on ``clock``; each ends with its one
    device-to-host copy, so the window ends when the card has finished."""
    epoch, failed, ends = 0, 0, []
    t0 = clock()
    while True:
        means = trainer._train_epoch(epoch)
        ends.append(clock() - t0)
        epoch += 1
        failed += trainer.iter_per_epoch * (not all(map(math.isfinite, means.values())))
        if ends[-1] >= seconds:
            break
    return Window(epoch, epoch * trainer.iter_per_epoch, ends[-1], failed, ends)


def build_trainer(cfg: dict, traffic: dict, train_domains: list, seed: int, device, out_dir):
    """The program's Trainer for a cell, as its training CLI would build it,
    with no validation in the window."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.train.trainer import Trainer

    hparams = default_hparams(cfg["algorithm"])
    hparams.update(cfg["hparams"])
    lr = cfg["adam"]["lr"]
    return Trainer(hparams, train_domains, train_domains[0], out_dir, label=traffic["label"],
                   batch_size=cfg["batch_size"], seed=seed, interval_validate=2 ** 31,
                   val_visualization=False, algorithm=cfg["algorithm"], lr_od=lr,
                   lr_od_shape=lr, lr_oc=lr, lr_oc_shape=lr, device=device)


def first_steps(trainer, weights: dict, gen_seed: int, steps: int, beta1: float
                ) -> check.Readings:
    """Load the benchmark's ``weights`` into the Trainer's nets, seed its
    generator with ``gen_seed`` and run ``steps`` steps through the window's
    entry, ``Trainer.epoch_step``: one, then the rest. Returns their readings
    (``harness/check.py``)."""
    nets = dict(zip(NETS, (ns.net for ns in trainer.state.net_states())))
    opts = dict(zip(NETS, (ns.opt for ns in trainer.state.net_states())))
    for k, net in nets.items():
        net.load_state_dict(weights[k])
    trainer._gen.manual_seed(gen_seed)
    first = trainer.epoch_step(0, 1)
    grad = check.first_grad_norms(nets, opts, beta1)
    rest = trainer.epoch_step(1, steps - 1)
    return check.Readings(step_losses(first) + step_losses(rest), grad,
                          check.change_norms(nets, weights),
                          {k: v.cpu() for k, v in trainer.last_batch.items()},
                          torch.cat([first["pos_weight_oc"], rest["pos_weight_oc"]]).tolist())


def run(job) -> dict:
    cfg, traffic, dev = job.cell.config, job.cell.traffic, job.device
    domains = len(traffic["pools"])
    per_domain = cfg["batch_size"] // domains
    steps0 = traffic["check_steps"]

    # ---- the benchmark's inputs, made on the card from the seed and kept on
    # the host while the program runs, so that the peak is the program's
    pools = make_pools(traffic["pools"], cfg["image_size"], job.seed, dev)
    train_domains = host_domains(pools)
    pools = {k: v.cpu() for k, v in pools.items()}
    weights = {k: {n: t.cpu() for n, t in w.items()} for k, w in
               make_weights(weight_shapes(cfg), job.seed, dev, cfg.get("init")).items()}
    log(job.t_start, "inputs made")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the program: the Trainer, the weights, the first steps
    out_dir = tempfile.mkdtemp(prefix="wtbench-")
    try:
        trainer = build_trainer(cfg, traffic, train_domains, job.seed, dev, out_dir)
        log(job.t_start, "Trainer built")
        gen_seed = derive(job.seed, "steps")
        got = first_steps(trainer, weights, gen_seed, steps0, cfg["adam"]["betas"][0])

        # ---- the window
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log(job.t_start, "first steps read")
        setup_s = time.perf_counter() - job.t_start
        win = run_window(trainer, job.seconds)
        peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
        log(job.t_start, f"window closed: {win.epochs} epochs ending at "
                         f"{', '.join(f'{t:.4f}' for t in win.ends_s)} s")

        out = {"attempted": win.steps, "failed": win.failed,
               "metrics": {"train_img_per_s": win.steps * cfg["batch_size"] / win.window_s,
                           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
               "memory_peak_bytes": peak}
        if job.trace:
            out.update(traced(job, trainer, win.epochs, SimpleNamespace(
                cell=job.cell, config=cfg, device=dev, trainer=trainer, steps=win.steps,
                window_s=win.window_s, images_per_step=cfg["batch_size"])))
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the first steps
    log(job.t_start, "program freed")
    want = check.reference_readings(
        cfg, {k: v.to(dev) for k, v in pools.items()},
        {k: {n: t.to(dev) for n, t in w.items()} for k, w in weights.items()},
        per_domain, gen_seed, steps0, cfg["precision"], dev)
    out["check"] = check.numbers(got, want, tuple(cfg["limits"]))
    out["explain"] = check.explain(got, want)
    log(job.t_start, "reference done")
    return out


def traced(job, trainer, epoch: int, ctx) -> dict:
    """One more epoch under ``torch.profiler``; the per-layer readers read
    it, the window and the program. A reader's ``before(ctx)``, where it has
    one, runs ahead of the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ctx.traced_steps = trainer.iter_per_epoch
    for reader in job.readers.values():  # what must not run after the profiler has
        if hasattr(reader, "before"):
            reader.before(ctx)
    activities = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(EPOCH_RANGE):
            trainer._train_epoch(epoch)
    tr = read_profile(prof)
    start, end = next((s, e) for s, e, name in tr.host if name == EPOCH_RANGE)
    busy_s = tr.busy_us(start, end) / 1e6
    ctx.trace, ctx.traced_window_s, ctx.busy_s = tr, (end - start) / 1e6, busy_s
    values = {}
    for name, reader in job.readers.items():
        v = reader.read(ctx)
        if v is not None:
            values[name] = float(v)
    groups = sorted(tr.by_group_us().items(), key=lambda kv: -kv[1])[:10]
    return {"layer_metrics": values, "busy_s": busy_s, "window_s": ctx.traced_window_s,
            "breakdown": {"device_ops": [[g, us / 1e6] for g, us in groups],
                          "idle_gaps": [[n, s] for n, s in tr.gaps(start, end)]}}

