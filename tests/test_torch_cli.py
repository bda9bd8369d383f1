"""The port's training CLI (``wt_pse_tpu_torch/cli/train.py``) and config loader
(``config/loader.py``) against the JAX package's, on the CPU.

- ``main([...])`` with ``--device cpu --running_times 2`` trains twice on a
  synthetic Fundus tree, with seeds ``seed + r`` (or the same seed under
  ``--identical-reruns``), and prints the 6 mean±std lines; the metric keys
  it logs are the JAX step's.
- ``_repair_left_argv``, ``argv_update`` and ``load_config`` equal the JAX
  package's on the cases of ``tests/test_config_checkpoint.py:35-90``, and the
  port's YAML-free typing of CLI values equals the JAX loader's.
"""

import json
import math
import os

import pytest

import jax
import jax.numpy as jnp

from wt_pse_tpu.cli import train as jax_cli
from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.config import loader as jax_loader
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu.train.state import reference_adam
from wt_pse_tpu.train.step import StepConfig as JaxStepConfig
from wt_pse_tpu.train.step import make_train_step as jax_make_train_step
from wt_pse_tpu_torch.cli import train as cli
from wt_pse_tpu_torch.config import Config, argv_update, default_hparams, load_config
from wt_pse_tpu_torch.config.loader import _parse_scalar

from torch_port import torch_single_thread, write_domain  # noqa: F401


def _jax_step_metric_keys():
    """The metric keys of the JAX 4-phase step, from an abstract trace."""
    hp = jax_default_hparams("WT_PSE")
    cfg = JaxModelConfig.from_hparams(hp)
    nets = (JaxWTPSE(cfg), JaxStudent(cfg), JaxWTPSE(cfg, two_step=True), JaxStudent(cfg))
    state = jax.eval_shape(lambda k: jax_init_ensemble(*nets, (3, 16, 16, 3), k)[0],
                           jax.random.PRNGKey(0))
    txs = {k: reference_adam(5e-4) for k in ("od", "od_shape", "oc", "oc_shape")}
    batch = {"image": jax.ShapeDtypeStruct((3, 16, 16, 3), jnp.float32),
             "target_od": jax.ShapeDtypeStruct((3, 16, 16, 1), jnp.float32),
             "target_oc": jax.ShapeDtypeStruct((3, 16, 16, 1), jnp.float32)}
    step = jax_make_train_step(*nets, txs, JaxStepConfig(hp, 3, 1))
    _, metrics = jax.eval_shape(step, state, batch, jax.random.PRNGKey(0))
    return set(metrics)


def test_main_trains_twice_with_seed_plus_r(tmp_path, capsys, monkeypatch):
    # decode at 32x32 (the CLI's loader decodes at 256x256): a CPU-sized run
    train_domains, fundus = cli.load_train_domains, cli.load_fundus
    monkeypatch.setattr(cli, "load_train_domains", lambda *a: train_domains(*a, size=32))
    monkeypatch.setattr(cli, "load_fundus", lambda *a, **k: fundus(*a, size=32, **k))
    root = str(tmp_path / "fundus")
    for dom in (1, 2, 4):
        write_domain(root, dom, "train", 2)
    write_domain(root, 3, "test", 2)
    out = str(tmp_path / "out")
    res = cli.main(["--device", "cpu", "--running_times", "2", "--seed", "3",
                    "--data-dir", root, "--out", out, "--batch-size", "3",
                    "--max-epoch", "1", "--margin=0.25"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Domain:3 ")]
    assert [l.split()[1].split(":")[0] for l in lines] == list(res)
    assert all("+_" in l for l in lines) and all(len(v) == 2 for v in res.values())
    seeds = [json.load(open(os.path.join(out, f"run{r}", "run_meta.json")))["seed"]
             for r in (0, 1)]
    assert seeds == [3, 4]
    assert os.path.exists(os.path.join(out, "code", "wt_pse_tpu_torch", "cli", "train.py"))
    with open(os.path.join(out, "code", "config_resolved.yaml")) as f:
        assert "margin: 0.25" in f.read()
    with open(os.path.join(out, "run0", "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert set(rec) - {"step", "t", "lr", "lr_shape"} == _jax_step_metric_keys()
    assert all(math.isfinite(v) for v in rec.values())


def test_identical_reruns_and_hparam_leftovers(tmp_path, monkeypatch):
    seen = []

    class FakeTrainer:
        def __init__(self, **kw):
            seen.append(kw)

        def train(self):
            return [0.1] * 6

    monkeypatch.setattr(cli, "Trainer", FakeTrainer)
    monkeypatch.setattr(cli, "load_train_domains", lambda *a, **k: [])
    monkeypatch.setattr(cli, "load_fundus", lambda *a, **k: None)
    cli.main(["--device", "cpu", "--out", str(tmp_path / "a"), "--running_times", "3",
              "--seed", "5", "--identical-reruns", "--label", "OC", "--margin", "0.5"])
    assert [kw["seed"] for kw in seen] == [5, 5, 5]
    assert seen[0]["label"] == "OC" and seen[0]["hparams"]["margin"] == 0.5
    assert str(seen[0]["device"]) == "cpu"


def test_main_defaults_to_cuda_and_raises_without_it(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--out", str(tmp_path / "o"), "--running_times", "1"])
    assert not os.path.exists(tmp_path / "o")


def test_repair_left_argv_matches_jax(tmp_path):
    yml = tmp_path / "o.yaml"
    yml.write_text("x: 1\n")
    cases = [(["--compute_dtype", "--margin=0.5", "--flag"], [str(yml), "bfloat16", "2"]),
             (["--a=1"], [str(yml)]),
             (["--lr", "--x"], ["0.1", "y"]),
             ([], [])]
    for left, configs in cases:
        assert cli._repair_left_argv(list(left), list(configs)) == \
            jax_cli._repair_left_argv(list(left), list(configs))
    for impl in (cli, jax_cli):
        with pytest.raises(SystemExit, match="ambiguous"):
            impl._repair_left_argv(["--some-flag", "--compute_dtype"], ["bfloat16"])


def test_load_config_and_argv_update_match_jax(tmp_path):
    y1 = tmp_path / "a.yaml"
    y1.write_text("margin: 0.5\nextra_key: 1\n")
    y2 = tmp_path / "b.yaml"
    y2.write_text("margin: 0.7\n")
    args = ([str(y1), str(y2)], ["--margin", "0.9", "--multi-turn", "2"])
    got = load_config(default_hparams("WT_PSE"), *args)
    want = jax_loader.load_config(jax_default_hparams("WT_PSE"), *args)
    assert isinstance(got, Config) and got == want and got["margin"] == 0.9
    assert got.whitening is True
    for argv in (["--a=2", "--b.c", "3", "--flag"],
                 ["--compute_dtype", "bfloat16", "--space_to_depth", "true",
                  "--space_to_depth_levels", "2"]):
        a, b = argv_update(Config({"a": 1}), argv), jax_loader.argv_update({"a": 1}, argv)
        assert a == b and [type(v) for v in a.values()] == [type(v) for v in b.values()]


@pytest.mark.parametrize("text", [
    "true", "False", "yes", "off", "1", "-3", "+4", "0x1f", "017", "0b101", "1_000", "1:30",
    "0.5", "1.", "-0.25", ".5", "1e-3", "1.0e-3", "1.0e3", "1.0E+3", ".inf", "-.inf", "~",
    "null", "", "bfloat16", "a b", "'quoted'", '"dq"', "[100, 150]", "[]",
    "[a, true, 0.5]", "2024-01-02", "08", "x:y", "5 # note", "-x", "float32"])
def test_cli_value_typing_matches_the_jax_loader(text):
    got, want = _parse_scalar(text), jax_loader._parse_scalar(text)
    assert type(got) is type(want) and got == want
