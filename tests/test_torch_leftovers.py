"""The port's last small counterparts of the JAX package, on the CPU:
``random_hparams`` (key for key, both algorithms, seeds 0-4),
``postprocess_probs_drishti`` (equal masks), ``InstanceWhitening``
(``f32_reduce``), ``RunLogger.step_scalars`` (the JAX logger's line),
``reference_lr_schedule`` (counts 0-600 at rtol 1e-7, and its errors) and the
lazy top-level API (the same 13 names, resolved without JAX)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wt_pse_tpu.config import hparams as jax_hparams
from wt_pse_tpu.models.layers import InstanceWhitening as JaxInstanceWhitening
from wt_pse_tpu.ops.postprocess import postprocess_probs_drishti as jax_drishti
from wt_pse_tpu.train.lr import reference_lr_schedule as jax_schedule
from wt_pse_tpu.utils.logging import RunLogger as JaxRunLogger
from wt_pse_tpu_torch.config import ALGORITHMS
from wt_pse_tpu_torch.config.hparams import random_hparams
from wt_pse_tpu_torch.models.layers import InstanceWhitening
from wt_pse_tpu_torch.ops.postprocess import postprocess_probs_drishti
from wt_pse_tpu_torch.train.lr import reference_lr_schedule
from wt_pse_tpu_torch.utils.logging import RunLogger

from torch_port import F32_REDUCE, assert_close, nhwc, torch_single_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_API = ("Trainer", "WTPSE", "ShapeStudent", "TeacherShapePrior", "JointShapeReg",
           "ModelConfig", "load_fundus", "load_train_domains", "default_hparams",
           "load_config", "load_reference_checkpoint", "load_predictor", "Predictor")


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("seed", range(5))
def test_random_hparams_key_for_key(algorithm, seed):
    got = random_hparams(algorithm, seed=seed)
    want = jax_hparams.random_hparams(algorithm, seed=seed)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("backend", ["native", "scipy"])
def test_postprocess_probs_drishti(backend):
    r = np.random.RandomState(0)
    probs = np.stack([np.clip(r.rand(48, 40) - 0.3, 0, 1),  # the cup, thresholded at 0.1
                      r.rand(48, 40)])                       # the disc, at 0.5
    got = postprocess_probs_drishti(probs, backend)
    want = jax_drishti(probs)
    np.testing.assert_array_equal(got, want)
    assert 0 < got[0].sum() < got[0].size and 0 < got[1].sum() < got[1].size


def test_instance_whitening():
    x = np.random.RandomState(1).randn(3, 6, 10, 7).astype(np.float32) * 3 + 2
    got = InstanceWhitening()(torch.from_numpy(x))
    want = JaxInstanceWhitening().apply({}, jnp.asarray(nhwc(torch.from_numpy(x))))
    assert_close(nhwc(got), want, F32_REDUCE, "instance whitening")
    assert list(InstanceWhitening().parameters()) == []
    ref = torch.nn.InstanceNorm2d(6, affine=False)(torch.from_numpy(x))
    assert_close(got.numpy(), ref.numpy(), F32_REDUCE, "nn.InstanceNorm2d")


def test_step_scalars_writes_the_jax_line(tmp_path, monkeypatch):
    payload = {"loss_seg": np.float32(0.25), "loss_kd": 1.5, "pos_weight": np.int64(3)}
    lines = []
    for name, cls in (("port", RunLogger), ("jax", JaxRunLogger)):
        logger = cls(str(tmp_path / name))
        monkeypatch.setattr(logger, "t0", 0.0)
        monkeypatch.setattr("time.time", lambda: 12.3456)
        logger.step_scalars(17, payload)
        logger.step_scalars_many([(18, payload)])
        monkeypatch.undo()
        with open(os.path.join(logger.out, "metrics.jsonl")) as f:
            lines.append(f.read())
    assert lines[0] == lines[1]
    first = json.loads(lines[0].splitlines()[0])
    assert first == {"kind": "step", "step": 17, "t": 12.346, "loss_seg": 0.25,
                     "loss_kd": 1.5, "pos_weight": 3.0}
    RunLogger(str(tmp_path / "null"), null=True).step_scalars(0, payload)
    assert not os.path.exists(tmp_path / "null")  # a null logger writes nothing


SCHEDULES = [dict(base_lr=1e-3, updates_per_epoch=4, warmup_steps=400),
             dict(base_lr=2.5e-4, updates_per_epoch=3, warmup_steps=7, milestones=(10, 30),
                  clamp_warmup=True, first_epoch_lr=5e-4),
             dict(base_lr=1e-3, updates_per_epoch=1, warmup_steps=50, milestones=(),
                  applied_after_epoch=False),
             dict(base_lr=3e-4, updates_per_epoch=2, warmup_steps=2, milestones=(150, 100),
                  gamma=0.1, warmup_factor=0.01)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=range(len(SCHEDULES)))
def test_reference_lr_schedule_matches_jax(kw):
    counts = np.arange(601)
    got = reference_lr_schedule(**kw)(torch.from_numpy(counts))
    want = np.asarray(jax_schedule(**kw)(jnp.asarray(counts)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert float(reference_lr_schedule(**kw)(5)) == pytest.approx(float(want[5]), rel=1e-7)


@pytest.mark.parametrize("bad", [dict(warmup_steps=0), dict(updates_per_epoch=0)])
def test_reference_lr_schedule_errors(bad):
    kw = dict(base_lr=1e-3, updates_per_epoch=4, warmup_steps=10)
    kw.update(bad)
    with pytest.raises(ValueError, match=next(iter(bad))) as got:
        reference_lr_schedule(**kw)
    with pytest.raises(ValueError) as want:
        jax_schedule(**kw)
    assert str(got.value) == str(want.value)


def test_the_lazy_api_resolves_the_jax_packages_names_without_jax():
    """The 13 names of ``wt_pse_tpu/__init__.py``; ``import wt_pse_tpu_torch``
    imports no module of the port, and resolving every name imports no JAX."""
    import wt_pse_tpu
    import wt_pse_tpu_torch

    for name in JAX_API:  # the JAX package's own list resolves there
        getattr(wt_pse_tpu, name)
    code = ("import sys\n"
            "import wt_pse_tpu_torch as p\n"
            "eager = sorted(m for m in sys.modules if m.startswith('wt_pse_tpu_torch.'))\n"
            f"objs = {{n: getattr(p, n) for n in {list(JAX_API)!r}}}\n"
            "mods = {n: o.__module__ for n, o in objs.items()}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'wt_pse_tpu'))\n"
            "try:\n"
            "    p.no_such_name\n"
            "    missing = 'resolved'\n"
            "except AttributeError:\n"
            "    missing = 'AttributeError'\n"
            "import json; print(json.dumps([eager, mods, bad, missing]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    eager, mods, bad, missing = json.loads(out.stdout.strip().splitlines()[-1])
    assert eager == [] and bad == [] and missing == "AttributeError"
    assert set(mods) == set(JAX_API) == set(wt_pse_tpu_torch._API)
    assert all(m.startswith("wt_pse_tpu_torch.") for m in mods.values()), mods
