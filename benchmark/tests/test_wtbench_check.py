"""The output check fails what it must fail: the control (the reference in
the precision below the configuration's, in the program's place) and each
fault a one-card training cell can have, planted in the program under a run
that skips the look for a card. A clean run passes. At 32x32 on the CPU, on
small pools; the limits are the cells' own."""

import time
from pathlib import Path

import pytest
import torch

import calibrate
import run
from harness import spec
from harness.check import verdict

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("wt_pse_f32.train", "wt_pse_bf16.train")
SEED = 2 ** 31 + 77


def small(name):
    cell = spec.load_cell(ROOT, name)
    cell.config["image_size"] = 32
    cell.traffic["pools"] = [6, 6, 6]
    return cell


def run_small(name):
    torch.manual_seed(0)
    return run.run_cell(small(name), SEED, 0.1, False, torch.device("cpu"),
                        time.perf_counter())[0]


def still(monkeypatch):
    """A step that returns its state unchanged: the program's Adams update
    nothing."""
    from wt_pse_tpu_torch.train import state

    make = state.reference_adam

    def frozen(*args, **kwargs):
        opt = make(*args, **kwargs)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(state, "reference_adam", frozen)


def half_batch(monkeypatch):
    """Half of the batch left out of the segmentation losses, the mean taken
    over the rest."""
    from wt_pse_tpu_torch.train import step

    bce, bce_w = step.bce_probs, step.bce_logits_pos_weight
    monkeypatch.setattr(step, "bce_probs",
                        lambda x, t: bce(x[:len(x) // 2], t[:len(t) // 2]))
    monkeypatch.setattr(step, "bce_logits_pos_weight",
                        lambda x, t, w: bce_w(x[:len(x) // 2], t[:len(t) // 2], w))


def altered(monkeypatch):
    """The answer altered where it is produced: each step's OD segmentation
    loss reported 1% high."""
    from wt_pse_tpu_torch.train import step

    seg = step._seg_phase

    def wrong(*args, **kwargs):
        out, metrics = seg(*args, **kwargs)
        return out, dict(metrics, loss_seg=metrics["loss_seg"] * 1.01)

    monkeypatch.setattr(step, "_seg_phase", wrong)


@pytest.mark.parametrize("name", CELLS)
def test_a_clean_run_is_correct(name):
    res = run_small(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check" and res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [still, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(name)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small(name)
    for line in calibrate.readings(cell, SEED, torch.device("cpu"), kinds=("control",)):
        assert not verdict(line, cell.config["limits"]), line
