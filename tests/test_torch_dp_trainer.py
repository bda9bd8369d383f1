"""The port's data-parallel ``Trainer`` and the pieces around it on the CPU.

- ``Trainer(dp=True)`` at world 1 (a mesh of one process: sync BN's formula,
  identity collectives) against ``dp=False``: one step's metrics (rtol 2e-3,
  atol 1e-5) and a 2-epoch trajectory within ``tests/test_parallel.py:49-101``'s
  random-walk bounds;
- a ``Trainer`` on 2 gloo ranks (``tests/torch_dp_worker.py``): 4 epochs of a
  step, a validation in ``train()`` and one more after; rank 0 writes
  ``run_meta.json`` (``dp.enabled``, ``n_devices`` 2), the log and the
  checkpoint, rank 1 nothing; both end with the same state and the same
  validation numbers;
- on 2 ranks, auto-DP degrades to the divisor of the per-domain batch (and a
  rank left outside raises), and an explicit ``dp`` with an indivisible batch
  raises ``ValueError`` (``tests/test_parallel.py:104-127``);
- ``choose_ranks``, ``rank_seed``, ``make_dp_fused``'s refusals,
  ``batch_sharded``, ``data_mesh`` without a group and the null ``RunLogger``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.parallel.distributed import initialize_multihost
from wt_pse_tpu_torch.parallel.dp import choose_ranks, make_dp_fused, rank_seed
from wt_pse_tpu_torch.parallel.mesh import data_mesh
from wt_pse_tpu_torch.parallel.spatial import batch_sharded
from wt_pse_tpu_torch.train.eval import make_predict_fn
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.trainer import Trainer
from wt_pse_tpu_torch.utils.logging import RunLogger

from torch_dp_worker import decisions_rank, run, trainer_rank
from torch_port import torch_single_thread  # noqa: F401

HW = 32
LR = 5e-4


def _domains(n=6, n_val=2):
    """3 train domains of ``n`` random images and a validation domain, as
    ``tests/test_parallel.py::_trainer_domains``."""

    def dom(seed, k):
        r = np.random.RandomState(seed)
        return FundusDomain(images=(r.rand(k, HW, HW, 3) * 255).astype(np.uint8),
                            labels=r.choice([0, 128, 255], size=(k, HW, HW)).astype(np.uint8),
                            names=[str(i) for i in range(k)])

    val = dom(9, n_val)
    return [dom(s, n) for s in (1, 2, 3)], FundusDomain(
        images=val.images, labels=list(val.labels), names=val.names)


def test_trainer_dp_at_world_one_matches_single_device(tmp_path):
    domains, val = _domains()
    kw = dict(label="OD", batch_size=3, max_epoch=2, interval_validate=99, seed=5,
              image_size=HW, val_visualization=False, device="cpu")
    t_dp = Trainer(default_hparams("WT_PSE"), domains, val, str(tmp_path / "dp"), dp=True,
                   dp_devices=1, **kw)
    t_1 = Trainer(default_hparams("WT_PSE"), domains, val, str(tmp_path / "sd"), dp=False, **kw)
    assert (t_dp.dp, t_dp.n_dev, t_dp.mesh.size) == (True, 1, 1) and t_1.mesh is None
    assert t_dp.state.od.net.inc.bn1.mesh is t_dp.mesh and t_1.state.od.net.inc.bn1.mesh is None
    meta = json.load(open(tmp_path / "dp" / "run_meta.json"))
    assert meta["dp"]["enabled"] and meta["dp"]["n_devices"] == 1
    assert meta["dp"]["requested"] is True and meta["n_processes"] == 1

    # one step from the same state and the same draws: the same batch, and
    # every metric within rounding (sync BN sums its statistics otherwise)
    metrics = []
    for t in (t_dp, t_1):
        gen = torch.Generator().manual_seed(rank_seed(11, t.mesh))
        metrics.append(t._train_step(copy.deepcopy(t.state), t._batch_fn(t.data, gen),
                                     generator=gen))
    assert set(metrics[0]) == set(metrics[1])
    for k in metrics[0]:
        np.testing.assert_allclose(float(metrics[0][k]), float(metrics[1][k]), rtol=2e-3,
                                   atol=1e-5, err_msg=k)

    # 2 epochs of 6 steps: Adam walks noise-level gradients apart at lr scale
    t_dp.train()
    t_1.train()
    assert t_dp.state.step == t_1.state.step == 12
    for a, b in zip(t_dp.state.net_states(), t_1.state.net_states()):
        flat = np.concatenate([(x - y).detach().abs().flatten().numpy() for x, y in
                               zip(a.net.parameters(), b.net.parameters())])
        assert flat.max() <= 12 * 2 * LR and flat.mean() <= 6 * LR


def test_trainer_on_two_ranks_trains_validates_and_rank_0_writes(tmp_path):
    domains, val = _domains(n=2, n_val=3)
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    kw = dict(label="OD", batch_size=6, max_epoch=4, interval_validate=4, seed=2,
              image_size=HW, eval_batch_size=2, dp=True)
    res = run(trainer_rank, tmp_path, domains, val, dirs, kw)
    assert [(r["dp"], r["n_dev"], r["step"]) for r in res] == [(True, 2, 4)] * 2
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["val"] == res[1]["val"] and res[0]["best"] == res[1]["best"]
    assert len(res[0]["val"]) == 7 and all(np.isfinite(v) for v in res[0]["val"].values())
    assert not os.path.exists(dirs[1])  # rank 1 writes nothing
    meta = json.load(open(os.path.join(dirs[0], "run_meta.json")))
    assert meta["dp"]["enabled"] and meta["dp"]["n_devices"] == 2 and meta["n_processes"] == 2
    with open(os.path.join(dirs[0], "log.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 4
    assert os.path.exists(os.path.join(dirs[0], "checkpoint_4.pth.tar"))
    assert os.path.exists(os.path.join(dirs[0], "best.json"))
    assert os.path.exists(os.path.join(dirs[0], "visualization", "epoch_3.png"))


def test_two_rank_dp_degrades_under_auto_and_is_strict_when_explicit(tmp_path):
    domains, val = _domains(n=2)
    kws = [dict(batch_size=3), dict(batch_size=6), dict(batch_size=3, dp=True, dp_devices=2)]
    kws = [dict(kw, label="OD", image_size=HW, val_visualization=False) for kw in kws]
    res = run(decisions_rank, tmp_path, domains, val, [str(tmp_path / "r0"),
                                                        str(tmp_path / "r1")], kws)
    # auto, per-domain batch 1: one device; rank 1 is left out and says so
    assert res[0][0] == (False, 1)
    assert "outside" in res[1][0] and "--nproc-per-node 1" in res[1][0]
    # auto, per-domain batch 2: both ranks
    assert res[0][1] == res[1][1] == (True, 2)
    # explicit, per-domain batch 1 over 2 ranks
    assert "divisible" in res[0][2] and "divisible" in res[1][2]


@pytest.mark.parametrize("dp, dp_devices, pdb, world, want", [
    (None, None, 3, 1, (False, 1)),      # auto on one rank: off
    (None, None, 3, 4, (True, 3)),       # auto: the largest divisor
    (None, None, 1, 4, (False, 1)),      # auto: down to one device
    (None, 2, 4, 4, (True, 2)),          # dp_devices caps N
    (None, 8, 4, 2, (True, 2)),          # ... at the world size
    (True, None, 3, 1, (True, 1)),       # explicit at world 1
    (True, 2, 4, 4, (True, 2)),
    (False, 4, 4, 4, (False, 1)),
])
def test_choose_ranks(dp, dp_devices, pdb, world, want):
    assert choose_ranks(dp, dp_devices, pdb, world) == want


@pytest.mark.parametrize("dp_devices, pdb, match", [(2, 3, "divisible"), (4, 4, "torchrun")])
def test_choose_ranks_refuses_explicit_meshes_it_cannot_build(dp_devices, pdb, match):
    with pytest.raises(ValueError, match=match):
        choose_ranks(True, dp_devices, pdb, 2)


def test_rank_seed_folds_the_rank_only_on_a_mesh_of_several():
    one = data_mesh()
    two = [type(one)(None, r, 2, one.device) for r in (0, 1)]
    assert rank_seed(7, None) == rank_seed(7, one) == 7
    seeds = {rank_seed(7, m) for m in two}
    assert len(seeds) == 2 and 7 not in seeds and all(0 <= s < 2 ** 63 for s in seeds)


def test_make_dp_fused_refuses_unsynced_nets_and_indivisible_batches():
    hp = default_hparams("WT_PSE")
    mesh = data_mesh()
    plain = init_ensemble(ModelConfig.from_hparams(hp), device="cpu")
    with pytest.raises(ValueError, match="bn_mesh"):
        make_dp_fused([ns.net for ns in plain.net_states()], hp, mesh, 3, 2, device="cpu")
    two = type(mesh)(None, 0, 2, mesh.device)
    synced = init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=two), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        make_dp_fused([ns.net for ns in synced.net_states()], hp, two, 3, 3, device="cpu")


def test_batch_sharded_on_one_rank_is_the_predict():
    cfg = ModelConfig.from_hparams(default_hparams("WT_PSE"))
    state = init_ensemble(cfg, device="cpu")
    predict = make_predict_fn(*(ns.net for ns in state.net_states()), device="cpu")
    image = torch.rand(3, 3, HW, HW) * 2 - 1
    for a, b in zip(batch_sharded(predict, data_mesh())(image), predict(image)):
        assert torch.equal(a, b)


def test_data_mesh_without_a_group_and_no_torchrun_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
    mesh = data_mesh()
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert copy.deepcopy(mesh) is mesh
    with pytest.raises(ValueError, match="torchrun"):
        data_mesh(2)


def test_null_logger_writes_nothing(tmp_path):
    out = str(tmp_path / "run")
    log = RunLogger(out, null=True)
    log.run_meta({"a": 1})
    log.scalars(0, {"x": 1.0})
    log.step_scalars_many([(0, {"x": 1.0})])
    log.csv_row(0, 1, 0.5)
    log.loss_trace({"ii": 0.0})
    log.best_score({k: 0.0 for k in ("cup_dice", "disc_dice", "cup_hd", "disc_hd",
                                     "cup_asd", "disc_asd")})
    log.image("train/x", np.zeros((2, 2, 3), np.uint8), 0)
    assert not os.path.exists(out)
