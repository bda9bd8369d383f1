"""The orbax -> ``.pth.tar`` converter (``scripts/orbax_to_pth.py``) between the
JAX package's checkpoints and the port, on the CPU, for WT_PSE and the joint
variant.

A JAX ``init_ensemble`` state at 32x32, with BatchNorm running statistics
moved off their 0 / 1 start and the OD logits lifted (so the OC stage sees a
ROI), is saved by the JAX package's ``save_ensemble`` (orbax, as its Trainer
saves) and converted by the script. Then:

- the port loads the file strictly (every leaf has a slot; only
  ``num_batches_tracked`` is absent) and its two-stage predict equals JAX's
  on the restored variables at class ``conv``;
- the JAX package's ``load_reference_checkpoint`` reads the file back to the
  saved leaves, bitwise;
- the port's eval CLI on the file and the JAX eval CLI on the directory score
  a tiny PNG split alike (Dice within 1e-6, HD / ASD within 1e-4, as
  ``tests/test_torch_eval_cli.py``);
- the port's error for a directory names the script.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.cli import test_visualization as jax_cli
from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.io.checkpoint import save_ensemble as jax_save_ensemble
from wt_pse_tpu.io.torch_import import load_into_variables, load_reference_checkpoint
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.joint import JointShapeReg as JaxJoint
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.train.eval import make_predict_fn as jax_predict_fn
from wt_pse_tpu.train.eval import make_predict_fn_joint as jax_predict_fn_joint
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu_torch.api import load_predictor
from wt_pse_tpu_torch.cli import test_visualization as cli
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.io.checkpoint import NET_KEYS
from wt_pse_tpu_torch.train.eval import make_predict_fn_for

from torch_port import assert_close, nchw, nhwc, torch_single_thread, write_domain  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGORITHMS = ["WT_PSE", JOINT]
NATIVE = [48, 64, 48]
OD_SHIFT = 1.1


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_pth", os.path.join(ROOT, "scripts", "orbax_to_pth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_nets(algorithm):
    cfg = JaxModelConfig.from_hparams(jax_default_hparams(algorithm))
    main = JaxJoint if algorithm == JOINT else JaxWTPSE
    return main(cfg), JaxStudent(cfg), main(cfg, two_step=True), JaxStudent(cfg)


def _perturb(tree, r):
    """Running statistics away from 0 / 1 (variances stay positive)."""
    return {k: _perturb(v, r) if hasattr(v, "items") else
            np.asarray(v) + (0.1 * r.rand(*np.shape(v)) if k == "var"
                             else 0.05 * r.randn(*np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ALGORITHMS)
def converted(request, tmp_path_factory):
    """(algorithm, orbax dir, converted file, the saved state, the test split)."""
    algorithm = request.param
    base = tmp_path_factory.mktemp("orbax")
    state, _ = jax_init_ensemble(*_jax_nets(algorithm), (1, 32, 32, 3), jax.random.PRNGKey(3))
    r = np.random.RandomState(7)
    nets = {}
    for name in ("od", "od_shape", "oc", "oc_shape"):
        ns = getattr(state, name)
        params = jax.tree.map(np.asarray, ns.params)
        if name == "od":
            c0 = params["outc"]["c0"]
            params["outc"]["c0"] = {**c0, "bias": c0["bias"] + OD_SHIFT}
        nets[name] = ns.replace(params=params, batch_stats=_perturb(ns.batch_stats, r))
    state = state.replace(**nets)
    ckpt_dir = str(base / "checkpoint_4")
    jax_save_ensemble(ckpt_dir, state)
    out = str(base / "checkpoint_4.pth.tar")
    counts = _script().main(["--model-file", ckpt_dir, "--out", out, "--algorithm", algorithm])
    assert set(counts) == set(NET_KEYS)
    assert not [f for f in os.listdir(base) if f.endswith(".tmp")]
    root = str(base / "fundus")
    write_domain(root, 3, "test", 3, native=NATIVE)
    return algorithm, ckpt_dir, out, state, root


def test_the_port_loads_the_file_strictly_and_predicts_as_jax(converted, capsys):
    algorithm, _, out, state, _ = converted
    nets = cli.build_networks(out, default_hparams(algorithm), 1, algorithm, strict=True,
                              device="cpu")
    assert "checkpoint leaves matched: model=" in capsys.readouterr().out
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    for key, net in zip(NET_KEYS, nets):
        want = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
        assert set(ckpt[key]) == want, key
        assert all(v.dtype == torch.float32 for v in ckpt[key].values())
    img = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    jnets = _jax_nets(algorithm)
    variables = (state.od.variables, state.od_shape.variables, state.oc.variables,
                 state.oc_shape.variables)
    predict = (jax_predict_fn_joint(jnets[0], jnets[2]) if algorithm == JOINT
               else jax_predict_fn(*jnets))
    want_od, want_oc = predict(*variables, jnp.asarray(img))
    got_od, got_oc = make_predict_fn_for(algorithm, nets, device="cpu")(nchw(img))
    assert_close(nhwc(got_od), want_od, what="predict od logits")
    assert_close(nhwc(got_oc), want_oc, what="predict oc logits")
    assert float((got_oc != 0).float().mean()) > 0.05  # the ROI is not empty


def test_the_jax_importer_reads_back_the_saved_leaves_bitwise(converted):
    _, _, out, state, _ = converted
    trees = load_reference_checkpoint(out)
    for key, name in zip(NET_KEYS, ("od", "od_shape", "oc", "oc_shape")):
        saved = getattr(state, name).variables
        got, matched = load_into_variables(saved, trees[key], strict=True)
        want_leaves = jax.tree_util.tree_leaves_with_path(saved)
        assert len(matched) == len(want_leaves), key
        got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in want_leaves:
            np.testing.assert_array_equal(np.asarray(got_flat[path]), np.asarray(leaf),
                                          err_msg=f"{key} {jax.tree_util.keystr(path)}")


def test_the_port_scores_the_file_as_the_jax_cli_scores_the_directory(converted, monkeypatch,
                                                                      capsys):
    algorithm, ckpt_dir, out, _, root = converted
    for mod in (cli, jax_cli):  # both CLIs decode at 256x256; 32x32 here
        loader = mod.load_fundus
        monkeypatch.setattr(mod, "load_fundus", lambda *a, _f=loader, **k: _f(*a, size=32, **k))
    argv = ["--datasetTest", "3", "--label", "OD", "--data-dir", root, "--batch-size", "2",
            "--algorithm", algorithm]
    got = cli.main(argv + ["--model-file", out, "--device", "cpu"])
    assert "scoring backend: native" in capsys.readouterr().out
    want = jax_cli.main(argv + ["--model-file", ckpt_dir])
    assert "orbax ensemble restored" in capsys.readouterr().out
    assert set(got) == set(want)
    for k in ("cup_dice", "disc_dice", "objective"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6), k
    for k in ("cup_hd", "disc_hd", "cup_asd", "disc_asd"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    assert got["disc_hd"] < 100.0  # the OD prediction is not empty


@pytest.mark.parametrize("entry", ["eval_cli", "load_predictor"])
def test_a_directory_raises_naming_the_converter(tmp_path, entry):
    with pytest.raises(ValueError, match=r"orbax.*scripts/orbax_to_pth\.py --model-file"):
        if entry == "eval_cli":
            cli.main(["--model-file", str(tmp_path), "--device", "cpu"])
        else:
            load_predictor(str(tmp_path), device="cpu")
