"""The port's full-state checkpoints and the Trainer's NaN handling, on the CPU:
``save_ensemble`` / ``restore_ensemble`` bring back nets, optimizers and the
step count bitwise (a step from each is then bitwise the same); a non-finite
loss on either half raises; with ``nan_recovery`` the epoch is rolled back to
the state after the last finite one.
"""

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.io.checkpoint import restore_ensemble, save_ensemble
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step
from wt_pse_tpu_torch.train.trainer import Trainer

from test_torch_checkpoint import _nets, _port_state
from test_torch_networks import CFG, HW
from torch_port import torch_single_thread  # noqa: F401


def _batch(seed):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    od = ((yy - 16) ** 2 + (xx - 16) ** 2 < 100).astype(np.float32)
    oc = ((yy - 16) ** 2 + (xx - 16) ** 2 < 30).astype(np.float32)
    return {"image": torch.from_numpy(r.rand(3, 3, HW, HW).astype(np.float32) * 2 - 1),
            "target_od": torch.from_numpy(np.tile(od[None, None], (3, 1, 1, 1))),
            "target_oc": torch.from_numpy(np.tile(oc[None, None], (3, 1, 1, 1)))}


def test_save_restore_brings_back_the_whole_state(tmp_path):
    step = make_train_step(StepConfig(default_hparams("WT_PSE"), 3, 1), device="cpu")
    state = _port_state(1)
    step(state, _batch(0), generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "c.pth.tar")
    save_ensemble(path, state)
    back = restore_ensemble(path, init_ensemble(CFG, device="cpu"))
    assert back.step == state.step == 1
    # one more step from each, with the same draws: bitwise the same
    outs = [step(s, _batch(1), generator=torch.Generator().manual_seed(1)) for s in (state, back)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for a, b in zip(_nets(state), _nets(back)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert back.od.opt.state_dict()["state"][0]["step"] == 2


def _tiny_trainer(tmp_path, **kw):
    r = np.random.RandomState(0)
    doms = [FundusDomain(images=r.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8),
                         labels=r.choice([0, 128, 255], (2, HW, HW)).astype(np.uint8))
            for _ in range(3)]
    return Trainer(default_hparams("WT_PSE"), doms, doms[0], str(tmp_path / "run"),
                   batch_size=3, max_epoch=3, interval_validate=99, val_visualization=False,
                   device="cpu", **kw)


def _inject_nan(trainer, key, calls):
    """Make step calls number ``calls`` (0-based) report a NaN ``key``."""
    step, n = trainer._train_step, [0]

    def poisoned(*args, **kw):
        metrics = step(*args, **kw)
        if n[0] in calls:
            metrics[key] = torch.tensor(float("nan"))
        n[0] += 1
        return metrics

    trainer._train_step = poisoned


def test_non_finite_loss_raises_on_either_half(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    _inject_nan(trainer, "loss_seg_oc", {1})
    with pytest.raises(ValueError, match="nan"):
        trainer.train()


def test_nan_recovery_rolls_the_epoch_back(tmp_path):
    trainer = _tiny_trainer(tmp_path, nan_recovery=True)
    _inject_nan(trainer, "loss_seg", {2})  # in epoch 1 of 3
    trainer.train()
    # epoch 1 was rolled back to the state after epoch 0; epoch 2 ran from it
    assert trainer._rollbacks == 1 and trainer.state.step == 4
    with open(tmp_path / "run" / "log.csv") as f:
        rows = [line.split(",") for line in f.read().strip().splitlines()[1:]]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    assert rows[1][2] == "nan" and rows[2][2] != "nan"
