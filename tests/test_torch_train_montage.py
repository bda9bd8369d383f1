"""The port's train-image montage (``Trainer(train_visualization=True)``,
``wt_pse_tpu_torch/train/trainer.py::viz_forward``) against the JAX Trainer's,
on the CPU, at 32x32 with batch 3 = 3 domains x 1.

- ``viz_forward`` on the batch the JAX Trainer's ``_viz_step`` draws for a
  step, with the JAX Trainer's weights carried over (the OD logits lifted so
  that the OC stage sees a ROI): sample 0's ROI image, attention mask, OC
  target and masked OC logits at class ``conv``;
- a run with the montage every 2 steps trains bitwise as the same run
  without it, and logs the 4 images at steps 0, 2 and 4;
- ``train_viz_interval <= 0`` raises, as in JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.data.augment import make_device_batch_fn as jax_batch_fn
from wt_pse_tpu.data.fundus import FundusDomain as JaxFundusDomain
from wt_pse_tpu.train.trainer import Trainer as JaxTrainer
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.train.trainer import Trainer, viz_forward

from test_torch_networks import CFG
from torch_port import CONV, assert_close, carry, nchw, torch_single_thread  # noqa: F401

HW = 32


def _pools(cls):
    r = np.random.RandomState(8)
    yy, xx = np.mgrid[0:HW, 0:HW]
    gray = np.full((HW, HW), 255, np.uint8)
    gray[(yy - 16) ** 2 + (xx - 15) ** 2 < 100] = 128
    gray[(yy - 16) ** 2 + (xx - 15) ** 2 < 30] = 0
    train = [cls(images=r.randint(0, 256, (2, HW, HW, 3)).astype(np.uint8),
                 labels=np.stack([gray, gray.T])) for _ in range(3)]
    val = cls(images=train[0].images, labels=[gray, gray])
    return train, val


def test_viz_forward_matches_the_jax_trainer(tmp_path):
    train, val = _pools(JaxFundusDomain)
    jt = JaxTrainer(jax_default_hparams("WT_PSE"), train, val, str(tmp_path / "jax"),
                    batch_size=3, max_epoch=1, image_size=HW, val_visualization=False)

    def lift(path, leaf):  # the OD logits up, so that the OC stage sees a ROI
        names = [str(getattr(k, "key", k)) for k in path]
        return leaf + 1.1 if "outc" in names and names[-1] == "bias" else leaf

    od_vars = jax.tree_util.tree_map_with_path(lift, jt.state.od.variables)
    oc_vars = jt.state.oc.variables
    key = jax.random.fold_in(jt.run_key, 2)
    want = jt._viz_step(od_vars, oc_vars, jt.data, key)

    kb, _ = jax.random.split(key)  # the batch _viz_step draws: step 2's own
    batch = {k: nchw(v) for k, v in jax_batch_fn(jt.per_domain_batch)(jt.data, kb).items()}
    main_od = carry(WTPSE(CFG, device="cpu"), od_vars)
    main_oc = carry(WTPSE(CFG, device="cpu"), oc_vars)
    got = viz_forward(main_od, main_oc, batch)
    assert not main_od.training and not main_oc.training
    for name, g, w in zip(("roi", "attention", "target_oc", "out_oc"), got, want):
        assert_close(g.permute(1, 2, 0).numpy(), w, CONV, name)
    assert float((np.asarray(want[0]) > -1).mean()) > 0.05  # a non-empty ROI


def _run(out, **kw):
    train, val = _pools(FundusDomain)
    t = Trainer(default_hparams("WT_PSE"), train, val, str(out), batch_size=3, max_epoch=3,
                image_size=HW, val_visualization=False, per_step_logging=True,
                device="cpu", **kw)
    t.train()
    return t


def test_the_montage_leaves_the_run_bitwise_unchanged(tmp_path):
    plain = _run(tmp_path / "plain")
    shown = _run(tmp_path / "shown", train_visualization=True, train_viz_interval=2)
    assert plain.iter_per_epoch == 2
    for a, b in zip(plain.state.net_states(), shown.state.net_states()):
        for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
            assert torch.equal(x, y), k
    recs = [[{k: v for k, v in json.loads(line).items() if k != "t"} for line in
             open(os.path.join(t.out, "metrics.jsonl"))] for t in (plain, shown)]
    assert recs[0] == recs[1]
    images = sorted(os.listdir(os.path.join(shown.out, "images")))
    assert images == sorted(f"train_{tag}_{g}.png" for g in (0, 2, 4)
                            for tag in ("image", "shape_cup", "target_cup", "pre_cup"))
    assert not os.path.exists(os.path.join(plain.out, "images"))


@pytest.mark.parametrize("interval", [0, -3])
def test_a_train_viz_interval_below_one_raises(tmp_path, interval):
    train, val = _pools(FundusDomain)
    with pytest.raises(ValueError, match="train_viz_interval"):
        Trainer(default_hparams("WT_PSE"), train, val, str(tmp_path / "x"), batch_size=3,
                train_visualization=True, train_viz_interval=interval, device="cpu")
