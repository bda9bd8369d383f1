"""The port's LR schedule (``wt_pse_tpu_torch/train/lr.py``) against the JAX
package's ``wt_pse_tpu/train/lr.py``, on the CPU.

The port writes an epoch's lr into each optimizer at the epoch's start; the
JAX package evaluates ``reference_lr_schedule`` at every update from the
update count. A short Trainer run with ``multi-turn`` 2 records the lr of
every update of every optimizer, which must equal the JAX schedule at that
update's count (relative 1e-6: the JAX schedule is f32).
"""

import numpy as np
import pytest

from wt_pse_tpu.train.lr import reference_lr_schedule as jax_schedule
from wt_pse_tpu.train.lr import reference_lr_value as jax_value
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.train.lr import epoch_lrs, reference_lr_kwargs, reference_lr_value
from wt_pse_tpu_torch.train.trainer import Trainer

from torch_port import torch_single_thread  # noqa: F401

LRS = {"od": 1e-3, "od_shape": 2e-3, "oc": 5e-4, "oc_shape": 7e-4}
SCHEDULE = dict(warmup_steps=3, warmup_factor=0.25, gamma=0.1, milestones=[2])


@pytest.mark.parametrize("kw", [reference_lr_kwargs(200), SCHEDULE,
                                dict(SCHEDULE, clamp_warmup=True)])
def test_reference_lr_value_matches_jax(kw):
    for epoch in [0, 1, 2, 3, 5, 99, 100, 101, 150, 151, 399, 400, 450]:
        for after in (True, False):
            got = reference_lr_value(1e-3, epoch, applied_after_epoch=after,
                                     first_epoch_lr=3e-4, **kw)
            want = jax_value(1e-3, epoch, applied_after_epoch=after, first_epoch_lr=3e-4, **kw)
            assert got == want, (epoch, after)


def test_every_update_runs_at_the_jax_schedule_lr(tmp_path):
    r = np.random.RandomState(0)
    doms = [FundusDomain(images=r.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                         labels=r.choice([0, 128, 255], (2, 32, 32)).astype(np.uint8))
            for _ in range(3)]
    hp = dict(default_hparams("WT_PSE"), **{"multi-turn": 2})
    epochs = 4
    trainer = Trainer(hp, doms, doms[0], str(tmp_path / "run"), batch_size=3,
                      max_epoch=epochs, interval_validate=99, val_visualization=False,
                      lr_schedule=SCHEDULE, device="cpu",
                      **{f"lr_{k}": v for k, v in LRS.items()})
    seen = {k: [] for k in LRS}
    for name, ns in zip(LRS, trainer.state.net_states()):
        ns.opt.register_step_pre_hook(
            lambda opt, args, kw, name=name: seen[name].append(opt.param_groups[0]["lr"]))
    trainer.train()

    it = trainer.iter_per_epoch
    kw = dict(reference_lr_kwargs(epochs), **SCHEDULE)
    want = {"od": jax_schedule(LRS["od"], it, first_epoch_lr=LRS["od"], **kw),
            "od_shape": jax_schedule(LRS["od"], 2 * it, first_epoch_lr=LRS["od_shape"], **kw),
            "oc": jax_schedule(LRS["oc"], it, first_epoch_lr=LRS["oc"], **kw),
            "oc_shape": jax_schedule(LRS["oc"], 2 * it, first_epoch_lr=LRS["oc_shape"], **kw)}
    for name, lrs in seen.items():
        assert len(lrs) == epochs * it * (2 if name.endswith("shape") else 1), name
        for count, lr in enumerate(lrs):
            assert lr == pytest.approx(float(want[name](count)), rel=1e-6), (name, count)
    # the per-epoch helper is what the Trainer applied
    first_of_epoch_2 = {n: seen[n][2 * it * (2 if n.endswith("shape") else 1)] for n in LRS}
    assert epoch_lrs(2, *LRS.values(), **kw) == tuple(first_of_epoch_2.values())


def test_unknown_schedule_key_raises(tmp_path):
    dom = FundusDomain(images=np.zeros((2, 32, 32, 3), np.uint8),
                       labels=np.full((2, 32, 32), 255, np.uint8))
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(default_hparams("WT_PSE"), [dom] * 3, dom, str(tmp_path / "x"),
                batch_size=3, lr_schedule={"first_epoch_lr": 1.0}, device="cpu")
