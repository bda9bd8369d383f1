"""The output check fails what it must fail: the control (the reference in
the precision below the configuration's, in the program's place) on an OD-side
number, each fault a one-card training cell can have and each fault of the OC
phases' ROI, planted in the program under a run that skips the look for a
card. A clean run passes, and in float32 so does one whose BatchNorm forward
rounds otherwise, as exactly. At 32x32 on the CPU, on small pools; the limits are
the cells' own."""

import math
import time
from pathlib import Path

import pytest
import torch

import calibrate
import run
from harness import spec
from harness.check import PER_SIDE, verdict

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("wt_pse_f32.train", "wt_pse_bf16.train")
# The cells whose limits pass a BatchNorm forward that rounds otherwise. In
# bf16 whole buckets of the first step's OD sigmoids sit on the ROI's 0.75
# threshold, so such a forward moves thousands of ROI pixels and the OC side
# is held as tightly as the OD side.
ROUNDING_PASSES = ("wt_pse_f32.train",)
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


def roi_threshold(monkeypatch):
    """The OC phases' ROI cut at 0.5 in place of 0.75."""
    from wt_pse_tpu_torch.train import step

    roi = step._oc_roi
    monkeypatch.setattr(step, "_oc_roi",
                        lambda out_od, *a, **k: roi(out_od + math.log(3.0), *a, **k))


def roi_full(monkeypatch):
    """The OC phases see the whole image: ``od_pred`` all ones."""
    from wt_pse_tpu_torch.train import step

    roi = step._oc_roi
    monkeypatch.setattr(step, "_oc_roi",
                        lambda out_od, *a, **k: roi(torch.full_like(out_od, math.inf), *a, **k))


def pos_weight_one(monkeypatch):
    """The OC segmentation loss's ``pos_weight`` fixed at 1."""
    from wt_pse_tpu_torch.train import step

    roi = step._oc_roi

    def one(*args, **kwargs):
        od_pred, image_roi, pos_w = roi(*args, **kwargs)
        return od_pred, image_roi, torch.ones_like(pos_w)

    monkeypatch.setattr(step, "_oc_roi", one)


def bn_forward_f64(monkeypatch):
    """Every training-mode BatchNorm forward of the program with its mean and
    variance in float64, y rounded once (``calibrate.forward_f64``): as exact
    as the library's, rounding otherwise. On a card that is
    ``ops/batchnorm_cuda.py::forward_library``; a CPU tensor takes the
    module's own forward, replaced here alike."""
    from wt_pse_tpu_torch.models import layers
    from wt_pse_tpu_torch.ops import batchnorm_cuda

    monkeypatch.setattr(batchnorm_cuda, "forward_library", calibrate.forward_f64)
    before = layers.BatchNorm2d.forward

    def forward(self, x):
        if self.training and self.mesh is None:
            return calibrate.forward_f64(x, self.weight, self.bias, self.running_mean,
                                         self.running_var, self.num_batches_tracked,
                                         self.momentum, self.eps, self.relu)[0]
        return before(self, x)

    monkeypatch.setattr(layers.BatchNorm2d, "forward", forward)


@pytest.mark.parametrize("name", CELLS)
def test_a_clean_run_is_correct(name):
    res = run_small(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check" and res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", ROUNDING_PASSES)
def test_a_program_whose_batchnorm_forward_rounds_otherwise_is_correct(name, monkeypatch):
    bn_forward_f64(monkeypatch)
    res = run_small(name)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", [still, half_batch, altered, roi_threshold, roi_full,
                                   pos_weight_one], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(name)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small(name)
    limits = cell.config["limits"]
    od_side = {k: limits[k] for k in PER_SIDE if k in limits}
    for line in calibrate.readings(cell, SEED, torch.device("cpu"), kinds=("control",)):
        assert not verdict(line, od_side), line


@pytest.mark.parametrize("name", ROUNDING_PASSES)
def test_the_reference_rounding_otherwise_is_correct(name):
    cell = small(name)
    for line in calibrate.readings(cell, SEED, torch.device("cpu"), kinds=("again_rounded",)):
        assert verdict(line, cell.config["limits"]), line
