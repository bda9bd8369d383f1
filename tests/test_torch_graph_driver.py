"""The port's one-program epoch (``wt_pse_tpu_torch/train/graph.py``) and the
Trainer's ``scan_epochs`` drivers, on the CPU, at 32x32 with batch 3 = 3
domains x 1.

A CPU has no CUDA graph, so these tests drive :meth:`GraphedStep.body`, the
callable the graph records, through its static buffers:

- two epochs of 3 steps through the body equal the eager loop bitwise
  (per-step metrics, weights, BatchNorm statistics, Adam state, step count);
- the body against the JAX package's step: ``test_torch_graph_driver_jax.py``;
- ``scan_epochs`` resolves to the loop on the CPU and raises where the graph
  cannot run;
- ``nan_recovery`` rolls back into the same tensors, bitwise;
- checkpoints cross drivers: a file from tensor-lr optimizers has the
  reference's float lr and resumes under the loop bitwise, and a loop file
  restores into capturable optimizers in place;
- the lr schedule reaches a tensor lr each epoch.
"""

import json
import os

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.io.checkpoint import restore_ensemble, save_ensemble
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.graph import GraphedStep
from wt_pse_tpu_torch.train.lr import epoch_lrs, reference_lr_kwargs
from wt_pse_tpu_torch.train.state import init_adam_state, init_ensemble, reference_adam
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step
from wt_pse_tpu_torch.train.trainer import Trainer, _draw_seed

from test_torch_step import DOMAINS, HW, PDB, make_batch, to_port_batch
from torch_port import torch_single_thread  # noqa: F401

SEED = 1


def _domains(n=3):
    r = np.random.RandomState(0)
    yy, xx = np.mgrid[0:HW, 0:HW]
    gray = np.full((HW, HW), 255, np.uint8)
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 90] = 128
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 25] = 0
    return [FundusDomain(images=r.randint(0, 256, (n, HW, HW, 3)).astype(np.uint8),
                         labels=np.stack([gray] * n)) for _ in range(3)]


def _trainer(tmp_path, name, **kw):
    doms = _domains()
    kw = dict(dict(batch_size=3, max_epoch=2, interval_validate=99, seed=SEED,
                   val_visualization=False, device="cpu"), **kw)
    return Trainer(default_hparams("WT_PSE"), doms, doms[0], str(tmp_path / name), **kw)


def _graphed(trainer, **kw):
    """A GraphedStep on ``trainer``'s state, step, sampler and generator."""
    probe = trainer._batch_fn(trainer.data, torch.Generator().manual_seed(0))
    return GraphedStep(trainer.state, trainer._train_step, probe,
                       capacity=trainer.iter_per_epoch, batch_fn=trainer._batch_fn,
                       data=trainer.data, generator=trainer._gen, **kw)


def _tensors(state):
    """Every tensor of a training state: each net's parameters and buffers,
    each optimizer's state."""
    out = []
    for ns in state.net_states():
        out += list(ns.net.state_dict().values())
        out += [v for st in ns.opt.state.values() for v in st.values()]
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert a.step == b.step


def test_body_equals_the_eager_loop_bitwise(tmp_path):
    loop = _trainer(tmp_path, "loop", per_step_logging=True)
    assert not loop.scan_epochs and loop.iter_per_epoch == 3
    loop.train()
    with open(tmp_path / "loop" / "metrics.jsonl") as f:
        steps = [r for r in map(json.loads, f) if r.get("kind") == "step"]
    assert [r["step"] for r in steps] == list(range(6))

    other = _trainer(tmp_path, "body")
    gs = _graphed(other)
    for epoch in range(2):
        # the loop's per-epoch seed (trainer.py::_train_epoch; one rank)
        other._gen.manual_seed(_draw_seed(SEED, epoch, 0))
        gs.rewind()
        for _ in range(3):
            gs.body()
        got = gs.read(3)
        assert sorted(got) == gs.names and len(gs.names) == 19
        for it in range(3):
            rec = steps[epoch * 3 + it]
            for k, v in got.items():
                assert float(v[it]) == rec[k], (epoch, it, k)
    _assert_states_equal(other.state, loop.state)
    assert other.state.step == 6


@pytest.mark.parametrize("case", ["default on the cpu", "true on the cpu", "true under dp"])
def test_scan_epochs_resolution(tmp_path, case):
    if case == "default on the cpu":
        t = _trainer(tmp_path, "run")
        assert t.scan_epochs is False and t._graph is None
        with open(tmp_path / "run" / "run_meta.json") as f:
            assert json.load(f)["driver"] == "eager"
        assert all(not g["capturable"] and isinstance(g["lr"], float)
                   for ns in t.state.net_states() for g in ns.opt.param_groups)
    elif case == "true on the cpu":
        with pytest.raises(ValueError, match="needs a CUDA card"):
            _trainer(tmp_path, "run", scan_epochs=True)
    else:
        with pytest.raises(ValueError, match="cannot be captured"):
            _trainer(tmp_path, "run", scan_epochs=True, dp=True)
    assert case == "default on the cpu" or not os.path.exists(tmp_path / "run" / "run_meta.json")


def test_nan_rollback_is_bitwise_and_in_place(tmp_path):
    t = _trainer(tmp_path, "run", max_epoch=3, nan_recovery=True)
    real, seen = t.epoch_step, {}

    def snapshot():
        return [(x.data_ptr(), x.clone()) for x in _tensors(t.state)], t.state.step

    def flaky(first_step, n_steps):
        epoch = first_step // t.iter_per_epoch
        seen[epoch] = snapshot()
        metrics = real(first_step, n_steps)
        if epoch == 1:
            metrics = dict(metrics, loss_seg=torch.full((n_steps,), float("nan")))
        return metrics

    t.epoch_step = flaky
    t.train()
    assert sorted(seen) == [0, 1, 2] and t._rollbacks == 1
    (before, step_before), (after, step_after) = seen[1], seen[2]
    assert step_before == step_after == 3
    assert len(before) == len(after) > 0
    for (p0, x0), (p1, x1) in zip(before, after):
        assert p0 == p1 and torch.equal(x0, x1)
    assert t.state.step == 6


def _step(state, seed):
    hp = default_hparams("WT_PSE")
    batch = to_port_batch(make_batch(seed=seed))
    return make_train_step(StepConfig(hp, DOMAINS, PDB), device="cpu")(
        state, batch, generator=torch.Generator().manual_seed(seed))


def _cfg():
    return ModelConfig.from_hparams(default_hparams("WT_PSE"))


def _opt_tensors(state):
    return [(p, k, v) for ns in state.net_states()
            for p, st in ns.opt.state.items() for k, v in st.items()]


def test_a_loop_checkpoint_restores_into_capturable_optimizers_in_place(tmp_path):
    loop = init_ensemble(_cfg(), device="cpu", generator=torch.Generator().manual_seed(1))
    _step(loop, 0)
    path = str(tmp_path / "loop.pth.tar")
    save_ensemble(path, loop)

    graph = init_ensemble(_cfg(), device="cpu", generator=torch.Generator().manual_seed(5),
                          capturable=True)
    for ns, ls in zip(graph.net_states(), loop.net_states()):
        assert all(g["capturable"] and g["lr"].dim() == 0 for g in ns.opt.param_groups)
        init_adam_state(ns.opt, [p for p, q in zip(ns.net.parameters(), ls.net.parameters())
                                 if q in ls.opt.state])
    ptrs = [x.data_ptr() for x in _tensors(graph)]
    lrs = [g["lr"] for ns in graph.net_states() for g in ns.opt.param_groups]
    restore_ensemble(path, graph)
    assert [x.data_ptr() for x in _tensors(graph)] == ptrs
    assert all(a is b for a, b in zip(
        [g["lr"] for ns in graph.net_states() for g in ns.opt.param_groups], lrs))
    assert all(g["capturable"] and float(g["lr"]) == np.float32(5e-4)
               for ns in graph.net_states() for g in ns.opt.param_groups)
    _assert_states_equal(graph, loop)


def test_a_tensor_lr_checkpoint_has_float_lr_and_resumes_under_the_loop_bitwise(tmp_path):
    loop = init_ensemble(_cfg(), device="cpu", generator=torch.Generator().manual_seed(1))
    _step(loop, 0)
    loop_path, graph_path = str(tmp_path / "loop.pth.tar"), str(tmp_path / "graph.pth.tar")
    save_ensemble(loop_path, loop)
    graph = restore_ensemble(loop_path, init_ensemble(_cfg(), device="cpu", capturable=True))
    save_ensemble(graph_path, graph)

    files = [torch.load(p, weights_only=True)["optim"] for p in (loop_path, graph_path)]
    for key in files[0]:
        want, got = files[0][key], files[1][key]
        assert got["param_groups"] == want["param_groups"], key
        assert all(isinstance(g["lr"], float) and not g["capturable"]
                   for g in got["param_groups"])
        assert sorted(got["state"]) == sorted(want["state"])
        for i, st in want["state"].items():
            assert sorted(got["state"][i]) == sorted(st)
            for k, v in st.items():
                assert torch.equal(got["state"][i][k], v) and got["state"][i][k].device == \
                    v.device, (key, i, k)

    resumed = restore_ensemble(graph_path, init_ensemble(
        _cfg(), device="cpu", generator=torch.Generator().manual_seed(9)))
    assert resumed.step == loop.step == 1
    outs = [_step(s, 1) for s in (loop, resumed)]
    for k, v in outs[0].items():
        assert torch.equal(v, outs[1][k]), k
    _assert_states_equal(resumed, loop)


def test_lr_schedule_fills_the_tensor_lr_each_epoch(tmp_path):
    lrs = dict(lr_od=5e-4, lr_od_shape=3e-4, lr_oc=2e-4, lr_oc_shape=1e-4)
    t = _trainer(tmp_path, "run", max_epoch=3, lr_schedule={}, **lrs)
    for ns, lr in zip(t.state.net_states(), lrs.values()):
        ns.opt = reference_adam(ns.net.parameters(), lr, capturable=True)
    held = [g["lr"] for ns in t.state.net_states() for g in ns.opt.param_groups]
    seen = []

    def record(first_step, n_steps):
        seen.append([float(g["lr"]) for ns in t.state.net_states() for g in ns.opt.param_groups])
        return {"loss_seg": torch.zeros(n_steps), "loss_seg_oc": torch.zeros(n_steps)}

    t.epoch_step = record
    t.train()
    kw = reference_lr_kwargs(3)
    want = [[float(np.float32(v)) for v in epoch_lrs(e, *lrs.values(), **kw)] for e in range(3)]
    assert seen == want
    assert want[0] != want[1]  # the schedule moves
    assert all(a is b for a, b in zip(
        [g["lr"] for ns in t.state.net_states() for g in ns.opt.param_groups], held))
