"""The port stands alone: importing it pulls in neither JAX nor the JAX package,
no module of it imports them, every module imports without PIL or PyYAML (the
CUDA machine may lack both), and its entry points run on the card unless the
caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import wt_pse_tpu_torch
from wt_pse_tpu_torch import api
from wt_pse_tpu_torch.cli import sweep as cli_sweep
from wt_pse_tpu_torch.cli import test_visualization as cli_eval
from wt_pse_tpu_torch.cli import train as cli_train
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.data.augment import make_device_batch_fn
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.joint import JointShapeReg
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.train.eval import make_predict_fn
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step
from wt_pse_tpu_torch.train.trainer import Trainer

from torch_port import torch_single_thread  # noqa: F401

PKG_DIR = os.path.dirname(wt_pse_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN = r"(jax|jaxlib|flax|optax|orbax|wt_pse_tpu)(?![\w])"
IMPORT_RE = re.compile(
    rf"^\s*(import\s+{FORBIDDEN}|from\s+{FORBIDDEN}[\s.]"
    rf"|.*(import_module|__import__)\(\s*['\"]{FORBIDDEN})", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], "wt_pse_tpu_torch."))


def test_importing_every_module_leaves_jax_out():
    mods = _modules()
    new = {"wt_pse_tpu_torch.api", "wt_pse_tpu_torch.cli.test_visualization",
           "wt_pse_tpu_torch.native", "wt_pse_tpu_torch.ops.losses",
           "wt_pse_tpu_torch.ops.postprocess_device", "wt_pse_tpu_torch.train.eval_device",
           "wt_pse_tpu_torch.models.joint", "wt_pse_tpu_torch.cli.sweep",
           "wt_pse_tpu_torch.parallel.collectives", "wt_pse_tpu_torch.parallel.distributed",
           "wt_pse_tpu_torch.parallel.dp", "wt_pse_tpu_torch.parallel.mesh",
           "wt_pse_tpu_torch.parallel.spatial", "wt_pse_tpu_torch.parallel.sweep"}
    assert "wt_pse_tpu_torch.ops.covariance_cuda" in mods and new <= set(mods)
    assert len(mods) >= 40
    code = ("import sys, importlib\n"
            f"for m in {['wt_pse_tpu_torch'] + mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'wt_pse_tpu'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_every_module_imports_without_pil_or_yaml():
    """PIL and yaml are imported only inside the functions that decode or
    write a PNG or read or write YAML."""
    code = ("import sys, importlib, importlib.abc\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('PIL', 'yaml'):\n"
            "            raise ImportError(f'{name} is blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            f"for m in {['wt_pse_tpu_torch'] + _modules()!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
             if f.endswith(".py")]
    assert files
    for path in files:
        with open(path) as f:
            hits = [m.group(0) for m in IMPORT_RE.finditer(f.read())]
        assert not hits, f"{path}: {hits}"


def _cfg():
    return ModelConfig.from_hparams(default_hparams("WT_PSE"))


ENTRY_POINTS = {
    "init_ensemble": lambda: init_ensemble(_cfg()),
    "WTPSE": lambda: WTPSE(_cfg()),
    "ShapeStudent": lambda: ShapeStudent(_cfg()),
    "JointShapeReg": lambda: JointShapeReg(_cfg()),
    "init_ensemble[joint]": lambda: init_ensemble(_cfg(), algorithm=JOINT),
    "make_train_step": lambda: make_train_step(StepConfig(default_hparams("WT_PSE"), 3, 1)),
    "make_predict_fn": lambda: make_predict_fn(
        *(m(_cfg(), device="cpu") for m in (WTPSE, ShapeStudent, WTPSE, ShapeStudent))),
    "make_device_batch_fn": lambda: make_device_batch_fn(3),
    "Trainer": lambda: Trainer(default_hparams("WT_PSE"), [], None, "unused"),
    "cli.train.main": lambda: cli_train.main(["--running_times", "1", "--out", "unused"]),
    "cli.test_visualization.main": lambda: cli_eval.main(["--model-file", "unused"]),
    "cli.sweep.main": lambda: cli_sweep.main(
        *cli_sweep.build_parser().parse_known_args(["--out", "unused"])),
    "load_predictor": lambda: api.load_predictor("unused"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


def test_parity_mode_turns_tf32_off():
    from wt_pse_tpu_torch.runtime import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
