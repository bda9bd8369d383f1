"""The port's Trainer (``wt_pse_tpu_torch/train/trainer.py``) and Fundus loader on
the CPU, on a synthetic Fundus tree (3 train domains of 2 images at 32x32, a
test domain of 3 images at native 48x48 and 64x64), batch 3 = 3 domains x 1,
so 2 steps an epoch.

- ``load_fundus`` equals the JAX package's, also through the ``.npz`` cache
  that either package writes;
- a 5-epoch run writes the JAX Trainer's artifacts (``log.csv`` with
  ``LOG_HEADERS``, one row an epoch, ``metrics.jsonl``, ``score.txt``,
  ``best.json``, ``run_meta.json``, a checkpoint), validating only where
  ``epoch > 2``;
- the same seed twice gives the same rows, and a run resumed after epoch 3
  gives the uninterrupted run's remaining rows and final weights bitwise.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from wt_pse_tpu.data.fundus import load_fundus as jax_load_fundus
from wt_pse_tpu.utils.logging import LOG_HEADERS as JAX_LOG_HEADERS
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.data.fundus import FundusDomain, load_fundus, load_train_domains
from wt_pse_tpu_torch.train.trainer import Trainer

from torch_port import torch_single_thread, write_domain  # noqa: F401

SIZE = 32
NATIVE = [48, 64, 48]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fundus"))
    for dom in (1, 2, 4):
        write_domain(root, dom, "train", 2, hw=SIZE)
    write_domain(root, 3, "test", 3, native=NATIVE)
    return root


def _domains(root):
    train = [load_fundus(root, "train", [i], size=SIZE, cache=False) for i in (1, 2, 4)]
    val = load_fundus(root, "test", [3], state="prediction", size=SIZE, cache=False)
    return train, val


def _same(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    assert a.names == b.names
    for x, y in zip(a.labels, b.labels):
        np.testing.assert_array_equal(np.asarray(x, np.uint8), np.asarray(y, np.uint8))
    assert len(a.labels) == len(b.labels)


@pytest.mark.parametrize("state", ["train", "prediction"])
def test_load_fundus_matches_jax_and_shares_its_cache(tree, tmp_path, state):
    phase, split = ("train", [1]) if state == "train" else ("test", [3])
    want = jax_load_fundus(tree, phase, split, state=state, size=SIZE, cache=False)
    got = load_fundus(tree, phase, split, state=state, size=SIZE, cache=False)
    _same(got, want)
    if state == "prediction":
        assert [lab.shape for lab in got.labels] == [(n, n) for n in NATIVE]
    # a cache written by one package loads in the other, with no PNG left to decode
    for writer, reader in ((jax_load_fundus, load_fundus), (load_fundus, jax_load_fundus)):
        root = str(tmp_path / writer.__module__.split(".")[0])
        shutil.copytree(tree, root)
        _same(writer(root, phase, split, state=state, size=SIZE), want)
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".png"):
                    os.remove(os.path.join(dirpath, f))
        _same(reader(root, phase, split, state=state, size=SIZE), want)
    with pytest.raises(FileNotFoundError):
        load_fundus(tree, "train", [9])
    assert [len(d) for d in load_train_domains(tree, [1, 2], size=SIZE)] == [2, 2]


def _trainer(root, out, **kw):
    train, val = _domains(root)
    args = dict(batch_size=3, max_epoch=5, interval_validate=1, seed=1, image_size=SIZE,
                eval_batch_size=2, device="cpu")
    args.update(kw)
    return Trainer(default_hparams("WT_PSE"), train, val, str(out), **args)


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """full: 5 epochs; short: the same seed, 4 epochs (its first validation
    writes checkpoint_4); resumed: from that checkpoint to 5 epochs."""
    base = tmp_path_factory.mktemp("runs")
    full = _trainer(tree, base / "full", per_step_logging=True)
    full_best = full.train()
    short = _trainer(tree, base / "short", max_epoch=4, val_visualization=False)
    short.train()
    resumed = _trainer(tree, base / "resumed", val_visualization=False,
                       resume=str(base / "short" / "checkpoint_4.pth.tar"))
    start = resumed.epoch
    resumed.train()
    return {"full": full, "full_best": full_best, "short": short, "resumed": resumed,
            "resumed_start": start}


def _rows(trainer):
    with open(os.path.join(trainer.out, "log.csv")) as f:
        lines = f.read().strip().splitlines()
    return lines[0].split(","), [line.split(",") for line in lines[1:]]


def _records(trainer):
    with open(os.path.join(trainer.out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_five_epoch_run_writes_the_artifacts(runs):
    t = runs["full"]
    header, rows = _rows(t)
    assert header == JAX_LOG_HEADERS
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3, 4]
    assert [int(r[1]) for r in rows] == [2, 4, 6, 8, 10]
    # validation only where epoch > 2: the valid/* columns of epochs 3 and 4
    ci = header.index("valid/disc_dice")
    assert [r[ci] != "" for r in rows] == [False, False, False, True, True]
    recs = _records(t)
    epochs = [r for r in recs if "kind" not in r and "loss_seg" in r]
    steps = [r for r in recs if r.get("kind") == "step"]
    vals = [r for r in recs if "val/objective" in r]
    assert [r["step"] for r in epochs] == [0, 1, 2, 3, 4]
    assert [r["step"] for r in steps] == list(range(10))
    assert [r["step"] for r in vals] == [3, 4]
    assert all(np.isfinite(v) for r in epochs for v in r.values())
    assert {"lr", "lr_shape", "loss_seg", "loss_kd_oc", "pos_weight_oc"} <= set(epochs[0])
    for k in ("cup_dice", "disc_dice", "cup_hd", "disc_hd", "cup_asd", "disc_asd", "objective"):
        assert np.isfinite(vals[0][f"val/{k}"])
    # the first validation is a new best: checkpoint, best.json, score.txt
    best = json.load(open(os.path.join(t.out, "best.json")))
    assert best["epoch"] in (4, 5) and len(best["best_list"]) == 6
    assert best["best_list"] == runs["full_best"]
    assert os.path.exists(os.path.join(t.out, f"checkpoint_{best['epoch']}.pth.tar"))
    assert open(os.path.join(t.out, "score.txt")).read().startswith("cd:")
    assert os.path.exists(os.path.join(t.out, "visualization", "epoch_3.png"))
    meta = json.load(open(os.path.join(t.out, "run_meta.json")))
    assert meta["seed"] == 1 and meta["label"] == "OD" and meta["platform"] == "cpu"
    assert meta["dp"] == {"requested": "auto", "enabled": False, "n_devices": 1,
                          "reproduce_single_device": None}
    assert meta["torch_version"] == torch.__version__
    assert len(t.epoch_seconds) == len(t.enqueue_seconds) == 5
    assert [set(v) for v in t.validation_seconds] == [{"predict", "upsample", "score"}] * 2


def test_the_same_seed_gives_the_same_rows(runs):
    header, full = _rows(runs["full"])
    _, short = _rows(runs["short"])
    assert [r[:-1] for r in short] == [r[:-1] for r in full[:4]]  # all but elapsed time


def test_resume_after_epoch_3_continues_bitwise(runs):
    full, resumed = runs["full"], runs["resumed"]
    assert runs["resumed_start"] == 4 and resumed.state.step == full.state.step == 10
    _, full_rows = _rows(full)
    _, rows = _rows(resumed)
    assert [r[:-1] for r in rows] == [full_rows[4][:-1]]
    drop_t = lambda r: {k: v for k, v in r.items() if k != "t"}
    full_recs = [drop_t(r) for r in _records(full) if r.get("kind") != "step" and r["step"] == 4]
    assert [drop_t(r) for r in _records(resumed)] == full_recs
    # the best of the run it continues was restored from best.json
    short_best = json.load(open(os.path.join(runs["short"].out, "best.json")))
    assert resumed.best["objective"] >= short_best["objective"]
    for a, b in zip(full.state.net_states(), resumed.state.net_states()):
        for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
            assert torch.equal(x, y), k
        sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert os.path.exists(os.path.join(resumed.out, "run_meta.json"))


@pytest.mark.parametrize("bad", ["label_none", "batch_below_domains", "dp",
                                 "train_viz_interval"])
def test_unsupported_configurations_raise(tmp_path, bad):
    """fast_validation and train_visualization are ported (tests/
    test_torch_eval_device.py, tests/test_torch_train_montage.py), and so are
    bf16, the joint algorithm (tests/test_torch_bf16.py,
    tests/test_torch_joint*.py) and data parallelism (tests/test_torch_dp*.py):
    an explicit ``dp`` whose mesh does not divide the per-domain batch raises
    (``tests/test_torch_dp_trainer.py``), and one whose ``dp_devices`` (2)
    is above the ranks (1, no process group) is capped at them and builds, as
    the JAX Trainer caps it at its devices (``trainer.py:164``)."""
    dom = FundusDomain(images=np.zeros((2, SIZE, SIZE, 3), np.uint8),
                       labels=np.full((2, SIZE, SIZE), 255, np.uint8))
    kw = {"label_none": dict(label=None), "batch_below_domains": dict(batch_size=2),
          "dp": dict(dp=True, dp_devices=2),
          "train_viz_interval": dict(train_visualization=True, train_viz_interval=0)}[bad]
    kw.setdefault("hparams", default_hparams("WT_PSE"))

    def build():
        return Trainer(train_domains=[dom] * 3, val_domain=dom, out_dir=str(tmp_path / "x"),
                       device="cpu", **kw)

    if bad == "dp":
        t = build()
        assert (t.dp, t.n_dev) == (True, 1)
        return
    with pytest.raises(ValueError):
        build()
