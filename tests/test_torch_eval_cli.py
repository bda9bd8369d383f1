"""The port's evaluation CLI (``wt_pse_tpu_torch/cli/test_visualization.py``)
against the JAX package's, on the CPU, on a ``write_domain`` tree (a test
domain of 3 images with labels at native 48x48 and 64x64, decoded at 32x32:
both CLIs' loaders are patched to that size) and a port checkpoint of seeded
nets whose OD logits are lifted so that the ROI is not empty.

- both CLIs print 336/158/336/158 matched leaves and score the checkpoint
  alike: Dice within 1e-6, HD / ASD within 1e-4 relative (the logits agree
  at class ``conv``; the engines compute distances in f32 or f64);
- ``--save-images`` writes ``original_image/`` and ``overlay/`` at the native
  sizes; ``--packed`` is accepted and ignored;
- a leaf with no slot raises unless ``--partial-load``; an orbax directory
  raises (the joint algorithm's CLI is in ``tests/test_torch_joint_eval.py``).
"""

import os

import numpy as np
import pytest
import torch

from wt_pse_tpu.cli import test_visualization as jax_cli
from wt_pse_tpu_torch.cli import test_visualization as cli
from wt_pse_tpu_torch.io.checkpoint import save_ensemble

from test_torch_checkpoint import _port_state
from torch_port import torch_single_thread, write_domain  # noqa: F401

NATIVE = [48, 64, 48]
COUNTS_LINE = "checkpoint leaves matched: model=336 shape=158 oc=336 oc_shape=158"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("evalcli")
    root = str(base / "fundus")
    write_domain(root, 3, "test", 3, native=NATIVE)
    ckpt = str(base / "checkpoint_4.pth.tar")
    save_ensemble(ckpt, _port_state(0))
    return base, root, ckpt


@pytest.fixture
def small(monkeypatch):
    """Both CLIs decode the images at 32x32 (they decode at 256x256)."""
    for mod in (cli, jax_cli):
        loader = mod.load_fundus
        monkeypatch.setattr(mod, "load_fundus", lambda *a, _f=loader, **k: _f(*a, size=32, **k))


def _argv(root, ckpt, *extra):
    return ["--datasetTest", "3", "--label", "OD", "--data-dir", root, "--model-file", ckpt,
            "--batch-size", "2", *extra]


def test_port_cli_scores_a_port_checkpoint_as_the_jax_cli(setup, small, capsys):
    base, root, ckpt = setup
    out = str(base / "vis")
    got = cli.main(_argv(root, ckpt, "--device", "cpu", "--out", out, "--save-images",
                         "--packed"))
    printed = capsys.readouterr().out
    assert COUNTS_LINE in printed and "scoring backend: native" in printed
    assert "--packed is ignored" in printed
    want = jax_cli.main(_argv(root, ckpt, "--out", str(base / "jax_vis")))
    assert COUNTS_LINE in capsys.readouterr().out
    assert set(got) == set(want)
    for k in ("cup_dice", "disc_dice", "objective"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6), k
    for k in ("cup_hd", "disc_hd", "cup_asd", "disc_asd"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    assert got["disc_hd"] < 100.0  # the OD prediction is not empty
    from PIL import Image

    for sub in ("original_image", "overlay"):
        names = sorted(os.listdir(os.path.join(out, sub)))
        assert names == ["1.bmp", "2.bmp", "3.bmp"]
        sizes = [Image.open(os.path.join(out, sub, n)).size for n in names]
        assert sizes == [(n, n) for n in NATIVE]


def test_a_leaf_without_a_slot_raises_unless_partial_load(setup, small, capsys, tmp_path):
    _, root, ckpt = setup
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    sd["model"]["outc.0.weight"] = torch.zeros(2, 8, 1, 1)  # another shape: no slot
    bad = str(tmp_path / "bad.pth.tar")
    torch.save(sd, bad)
    with pytest.raises(ValueError, match="mismatch"):
        cli.main(_argv(root, bad, "--device", "cpu"))
    res = cli.main(_argv(root, bad, "--device", "cpu", "--partial-load"))
    assert "model=335 shape=158 oc=336 oc_shape=158" in capsys.readouterr().out
    assert np.isfinite(res["objective"])


@pytest.mark.parametrize("case", ["orbax_dir"])
def test_what_is_not_ported_raises(setup, tmp_path, case):
    _, root, _ = setup
    with pytest.raises(ValueError, match="orbax"):
        cli.main(_argv(root, str(tmp_path), "--device", "cpu"))
