"""The joint variant's Trainer and evaluation path in the port, on the CPU.

- A 3-epoch ``Trainer(algorithm=joint, device='cpu')`` at the joint hparams
  writes its artifacts: no KD metrics, the reference joint epoch's loss-trace
  files of 0.0, ``run_meta.json`` naming the algorithm, and validates.
- Its checkpoint (OD logits lifted so the ROI is not empty) scores alike in
  the port's eval CLI and the JAX eval CLI (Dice within 1e-6, HD / ASD within
  1e-4, as ``tests/test_torch_eval_cli.py``; both count the same matched
  leaves), and ``load_predictor`` returns masks for it.
"""

import json

import numpy as np
import pytest
import torch

from wt_pse_tpu.cli import test_visualization as jax_cli
from wt_pse_tpu_torch.api import load_predictor
from wt_pse_tpu_torch.cli import test_visualization as cli
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.data.fundus import load_fundus
from wt_pse_tpu_torch.io.checkpoint import save_ensemble
from wt_pse_tpu_torch.train.trainer import Trainer

from torch_port import torch_single_thread, write_domain  # noqa: F401

SIZE = 32
NATIVE = [48, 64, 48]


@pytest.fixture(scope="module")
def joint_run(tmp_path_factory):
    """A 3-epoch joint Trainer on a synthetic tree, and a checkpoint of its
    nets with the OD logits lifted so the OC stage sees part of the image."""
    base = tmp_path_factory.mktemp("joint")
    root = str(base / "fundus")
    for dom in (1, 2, 4):
        write_domain(root, dom, "train", 2, hw=SIZE)
    write_domain(root, 3, "test", 3, native=NATIVE)
    train = [load_fundus(root, "train", [i], size=SIZE, cache=False) for i in (1, 2, 4)]
    val = load_fundus(root, "test", [3], state="prediction", size=SIZE, cache=False)
    out = base / "run"
    trainer = Trainer(default_hparams(JOINT), train, val, str(out), batch_size=3, max_epoch=3,
                      interval_validate=1, seed=1, image_size=SIZE, eval_batch_size=2,
                      algorithm=JOINT, device="cpu")
    trainer.train()
    with torch.no_grad():
        trainer.state.od.net.outc[0].bias += 2.0
    ckpt = str(base / "joint.pth.tar")
    save_ensemble(ckpt, trainer.state)
    return base, root, out, trainer, ckpt


def test_joint_trainer_writes_its_artifacts(joint_run):
    _, _, out, trainer, _ = joint_run
    with open(out / "log.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 3
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f if "loss_seg" in line]
    assert len(recs) == 3 and all(np.isfinite(r["loss_seg"]) and np.isfinite(r["loss_seg_oc"])
                                  for r in recs)
    assert not any(k.startswith(("loss_kd", "loss_ins_wt_shape", "loss_dom_wt_shape"))
                   for r in recs for k in r)  # no distillation phases
    for name in ("ii", "ij", "all_ins", "domain"):  # the reference's joint epoch
        with open(out / f"{name}.txt") as f:
            assert f.read() == "0.0\n" * 3, name
    with open(out / "run_meta.json") as f:
        assert json.load(f)["algorithm"] == JOINT
    val = trainer.validate()
    assert len(val) == 7 and all(np.isfinite(v) for v in val.values())


@pytest.fixture
def small(monkeypatch):
    """Both CLIs decode the images at 32x32 (they decode at 256x256)."""
    for mod in (cli, jax_cli):
        loader = mod.load_fundus
        monkeypatch.setattr(mod, "load_fundus", lambda *a, _f=loader, **k: _f(*a, size=32, **k))


def test_joint_checkpoint_scores_alike_in_both_eval_clis(joint_run, small, capsys):
    base, root, _, _, ckpt = joint_run
    argv = ["--datasetTest", "3", "--label", "OD", "--data-dir", root, "--model-file", ckpt,
            "--batch-size", "2", "--algorithm", JOINT]
    got = cli.main(argv + ["--device", "cpu", "--out", str(base / "vis")])
    counts = capsys.readouterr().out
    want = jax_cli.main(argv + ["--out", str(base / "jax_vis")])
    line = [s for s in counts.splitlines() if s.startswith("checkpoint leaves matched")]
    assert line and line[0] in capsys.readouterr().out  # the same leaves in both
    assert set(got) == set(want)
    for k in ("cup_dice", "disc_dice", "objective"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6), k
    for k in ("cup_hd", "disc_hd", "cup_asd", "disc_asd"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    assert got["disc_hd"] < 100.0  # the OD prediction is not empty


def test_load_predictor_on_a_joint_checkpoint(joint_run):
    *_, ckpt = joint_run
    predict = load_predictor(ckpt, algorithm=JOINT, image_size=SIZE, device="cpu")
    images = (np.random.RandomState(6).rand(2, 48, 48, 3) * 255).astype(np.uint8)
    out = predict(images)
    assert out["od"].shape == out["oc"].shape == (2, 48, 48) and out["od"].dtype == np.uint8
    assert out["od_logits"].shape == (2, 1, 48, 48) and np.isfinite(out["od_logits"]).all()
    assert out["od"].sum() > 0
