"""The training CLI's own launch of one rank a card, on the CPU.

- ``parallel/dp.py::choose_ranks`` against the JAX Trainer's decision
  (``wt_pse_tpu/train/trainer.py:156-190``): over 1-4 cards, ``dp`` auto, on
  and off, ``dp_devices`` None, 2 and 16 and batches 6, 9 and 12 of 3
  domains, the JAX Trainer built on ``jax.devices()[:cards]`` of the 8
  virtual CPU devices at 32x32 and stopped at the model build that follows
  its decision; where JAX raises, the port raises;
- ``cli/train.py::launch_count``: how many ranks the CLI starts, over
  patched card counts (none under ``--no-dp``, on the CPU, under torchrun,
  or under auto on one card);
- ``parallel/distributed.py::launch_ranks`` over gloo: two ranks run the
  CLI's body (``tests/torch_dp_worker.py::cli_rank``, 32x32) to a checkpoint
  bitwise equal to the same arguments under ``run_local_ranks``, with both
  ranks' states equal; a rank that raises, and one that exits with code 3,
  make the launcher raise within seconds with no rank left alive; a resume
  of that checkpoint whose second epoch's loss is non-finite rolls back
  (``--nan-recovery``), trains to ``--max-epoch`` and ends with the ranks
  equal.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from wt_pse_tpu.data.fundus import FundusDomain as JaxFundusDomain
from wt_pse_tpu.train import trainer as jax_trainer
from wt_pse_tpu_torch.cli import train as cli
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.parallel.distributed import launch_ranks, run_local_ranks
from wt_pse_tpu_torch.parallel.dp import choose_ranks

from torch_dp_worker import cli_rank, failing_rank
from torch_port import torch_single_thread, write_domain  # noqa: F401


class _Decided(Exception):
    pass


class _StopAtModelBuild:
    """Stands in for the JAX trainer module's ``ModelConfig``: its
    ``from_hparams``, the first call after the data-parallel decision,
    raises with the trainer's ``(dp, n_dev)``."""

    @staticmethod
    def from_hparams(*a, **k):
        t = sys._getframe(1).f_locals["self"]
        raise _Decided(t.dp, t.n_dev)


def _jax_decision(cards, dp, dp_devices, batch, out_dir):
    r = np.random.RandomState(0)
    doms = [JaxFundusDomain(images=r.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
                            labels=np.full((4, 32, 32), 255, np.uint8)) for _ in range(3)]
    try:
        jax_trainer.Trainer(default_hparams("WT_PSE"), doms, doms[0], out_dir,
                            batch_size=batch, image_size=32, dp=dp, dp_devices=dp_devices,
                            devices=jax.devices()[:cards], val_visualization=False)
    except _Decided as d:
        return d.args
    except ValueError as e:
        return ValueError, str(e)
    raise AssertionError("the JAX Trainer did not reach its model build")


@pytest.mark.parametrize("batch", [6, 9, 12])
@pytest.mark.parametrize("dp_devices", [None, 2, 16])
@pytest.mark.parametrize("dp", [None, True, False])
@pytest.mark.parametrize("cards", [1, 2, 3, 4])
def test_choose_ranks_decides_as_the_jax_trainer(cards, dp, dp_devices, batch, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(jax_trainer, "ModelConfig", _StopAtModelBuild)
    want = _jax_decision(cards, dp, dp_devices, batch, str(tmp_path))
    if want[0] is ValueError:
        with pytest.raises(ValueError, match="divisible"):
            choose_ranks(dp, dp_devices, batch // 3, cards)
        assert "divisible" in want[1]
    else:
        assert choose_ranks(dp, dp_devices, batch // 3, cards) == want


def _args(*argv):
    args, _ = cli.build_parser().parse_known_args(list(argv))
    return args


@pytest.mark.parametrize("cards, argv, want", [
    (4, ["--batch-size", "9"], 3),                    # auto: the largest divisor
    (4, ["--batch-size", "12"], 4),
    (4, ["--batch-size", "12", "--dp-devices", "2"], 2),
    (2, ["--batch-size", "12", "--dp", "--dp-devices", "16"], 2),  # capped, as JAX
    (4, ["--batch-size", "3"], None),                 # auto at N = 1: this process
    (1, ["--batch-size", "9"], None),                 # auto on one card: this process
    (1, ["--batch-size", "9", "--dp"], 1),            # explicit: one rank
    (4, ["--batch-size", "12", "--no-dp"], None),
    (4, ["--batch-size", "12", "--device", "cpu"], None),
    (0, ["--batch-size", "9", "--dp"], None),         # no card: the Trainer says so
    (4, ["--batch-size", "2"], None),                 # no sample a domain: likewise
])
def test_launch_count(cards, argv, want, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: cards)
    assert cli.launch_count(_args(*argv)) == want


def test_launch_count_leaves_torchrun_ranks_alone(monkeypatch):
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1", RANK="0", WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: 4)
    assert cli.launch_count(_args("--batch-size", "12", "--dp")) is None


def test_launch_count_refuses_an_explicit_dp_the_batch_does_not_divide(monkeypatch):
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="divisible"):
        cli.launch_count(_args("--batch-size", "9", "--dp"))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The CLI's body on 2 gloo ranks, from one seed, 4 epochs of a step at
    batch 6 = 3 x 2, a validation after the fourth and its checkpoint:
    through the launcher, then a resume of its checkpoint through the
    launcher (epoch 5 made non-finite, max epoch 7); and, at the same time,
    through ``run_local_ranks``."""
    tmp = tmp_path_factory.mktemp("launcher")
    root = str(tmp / "fundus")
    for dom in (1, 2, 4):
        write_domain(root, dom, "train", 2)
    write_domain(root, 3, "test", 2)

    def cli_run(how, *extra, flaky_epoch=None):
        out, probe = str(tmp / how), str(tmp / f"probe_{how}")
        os.makedirs(probe)
        argv = ["--device", "cpu", "--data-dir", root, "--out", out, "--batch-size", "6",
                "--max-epoch", "4", "--interval-validate", "4", "--running_times", "1",
                *extra]
        if how == "local":
            res = run_local_ranks(cli_rank, 2, f"file://{tmp}/rdzv", (argv, probe),
                                  timeout_s=120)[0]
        else:
            res = launch_ranks(cli_rank, 2, (argv, probe, flaky_epoch), backend="gloo")
        return dict(res=res, out=out, probes=[
            json.load(open(os.path.join(probe, f"rank{r}.json"))) for r in (0, 1)])

    def launch_then_resume():
        first = cli_run("launch")
        return first, cli_run("resumed", "--max-epoch", "7", "--interval-validate", "99",
                              "--nan-recovery", "--resume",
                              os.path.join(first["out"], "run0", "checkpoint_4.pth.tar"),
                              flaky_epoch=5)

    with ThreadPoolExecutor(2) as pool:  # 2 + 2 ranks at once
        chain, local = pool.submit(launch_then_resume), pool.submit(cli_run, "local")
        (launch, resumed), local = chain.result(), local.result()
    return dict(launch=launch, resumed=resumed, local=local)


def test_launcher_runs_the_cli_body_as_run_local_ranks_does(launched):
    a, b = launched["launch"], launched["local"]
    assert set(a["res"]) == {"DSC_OC", "HD_OC", "ASD_OC", "DSC_OD", "HD_OD", "ASD_OD"}
    assert a["res"] == b["res"]
    for run in (a, b):
        (r0,), (r1,) = run["probes"]
        assert r0 == r1 and (r0["dp"], r0["n_dev"], r0["step"], r0["epochs"]) == (True, 2, 4, 4)
        meta = json.load(open(os.path.join(run["out"], "run0", "run_meta.json")))
        assert meta["dp"]["enabled"] and meta["dp"]["n_devices"] == 2
        assert meta["n_processes"] == 2
    _assert_same_checkpoint(*(os.path.join(run["out"], "run0", "checkpoint_4.pth.tar")
                              for run in (a, b)))
    assert a["probes"][0] == b["probes"][0]


def _assert_same_checkpoint(a: str, b: str):
    """Every tensor of two checkpoints bitwise equal, every other entry equal
    (the files' bytes differ: each zip names its records after the temporary
    file it was written to)."""

    def walk(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), path
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path

    walk(torch.load(a, weights_only=False), torch.load(b, weights_only=False), "")


def _rank_processes() -> list[int]:
    """The live (not zombie) processes this one started as ranks."""
    me, pids = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = open(f"/proc/{pid}/stat").read()
            cmd = open(f"/proc/{pid}/cmdline").read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == me and fields[0] != "Z" and "spawn_main" in cmd:
            pids.append(int(pid))
    return pids


@pytest.mark.parametrize("how, match", [("raise", "rank 1 failed.*rank 1 fails"),
                                        ("exit", "rank 1 exited with code 3")])
def test_a_failing_rank_ends_the_run_within_seconds(how, match):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"(?s){match}"):
        launch_ranks(failing_rank, 3, (how,), backend="gloo")
    # the ranks' start (a few seconds) and the failure 0.5 s in; the other
    # ranks would sleep 120 s
    assert time.monotonic() - t0 < 30
    assert _rank_processes() == []


def test_resume_rollback_and_finish_through_the_launcher(launched):
    (r0,), (r1,) = launched["resumed"]["probes"]
    assert r0 == r1, (r0, r1)
    # epochs 4, 5 (rolled back) and 6 from step 4: 2 steps that stand
    assert (r0["epochs"], r0["rollbacks"], r0["step"]) == (3, 1, 6)
    assert r0["digest"] != launched["launch"]["probes"][0][0]["digest"]
