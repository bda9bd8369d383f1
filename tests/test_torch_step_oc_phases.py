"""Phases 3 and 4 of the port's step (OC segmentation and OC shape distillation
on the ROI) against the test-side JAX composition, and the whole ``train_step``
against the chain of the port's own phases. The method and the tolerances are
those of ``test_torch_step_phases.py``; the ROI both sides use comes from the
port's phase-1 logits (its parity with JAX is checked in that file).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.train.step import bce_logits_pos_weight
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import (EPS_KEYS, StepConfig, _oc_roi,
                                         _seg_phase as port_seg_phase,
                                         _shape_phase as port_shape_phase,
                                         bce_logits_pos_weight as port_bce_pos_weight,
                                         bce_probs as port_bce_probs, make_train_step)

from test_torch_step import B, DOMAINS, HW, OD_SHIFT, PDB, make_batch, to_port_batch
from test_torch_step_phases import _seg_phase, _shape_phase, carry, compare, setup, snapshot
from torch_port import torch_single_thread  # noqa: F401


@pytest.fixture(scope="module")
def oc_phases():
    s = setup()
    ps, pb, pe, jb, je, cfg = s["pstate"], s["pb"], s["pe"], s["jb"], s["je"], s["cfg"]
    out_od, _ = port_seg_phase(ps.od, pb["image"], pb["target_od"], pb["image"],
                               lambda o: port_bce_probs(o, pb["target_od"]), cfg,
                               pe["phase1"], None)
    od_pred, roi, pos_w = _oc_roi(out_od, pb["image"], pb["target_oc"])
    assert float(pos_w) != 1.0 and 0.0 < float(od_pred.mean()) < 1.0  # not trivial
    j_pred, j_roi = (jnp.asarray(np.transpose(t.numpy(), (0, 2, 3, 1)))
                     for t in (od_pred, roi))
    j_pos_w = jnp.asarray(pos_w.numpy())
    out = {}

    # phase 3: OC segmentation on the ROI
    joc, _, m3 = jax.jit(lambda net, e: _seg_phase(
        s["jnets"]["oc"], s["tx"], net, j_roi, jb["target_oc"],
        lambda o: bce_logits_pos_weight(o * j_pred, jb["target_oc"], j_pos_w), e))(
        s["jstate"]["oc"], je["phase3"])
    _, pm3 = port_seg_phase(ps.oc, roi, pb["target_oc"], roi,
                            lambda o: port_bce_pos_weight(o * od_pred, pb["target_oc"], pos_w),
                            cfg, pe["phase3"], None)
    out["phase3"] = (pm3, m3, [(snapshot(ps.oc), joc)])

    # phase 4: OC shape distillation, the teacher on the post-update weights
    carry(ps.oc, joc)
    joc, joc_shape, m4 = jax.jit(lambda a, b, et, es: _shape_phase(
        s["jnets"]["oc"], s["jnets"]["oc_shape"], s["tx"], a, b, j_roi, jb["target_oc"],
        et, es))(joc, s["jstate"]["oc_shape"], je["phase4.teacher"], je["phase4.student"])
    pm4 = port_shape_phase(ps.oc, ps.oc_shape, roi, pb["target_oc"], cfg,
                           pe["phase4.teacher"], pe["phase4.student"], None)
    out["phase4"] = (pm4, m4, [(snapshot(ps.oc), joc), (snapshot(ps.oc_shape), joc_shape)])
    return out


@pytest.mark.parametrize("phase", ["phase3", "phase4"])
def test_oc_phase_matches_jax_composition(oc_phases, phase):
    compare(*oc_phases[phase], phase)


def test_train_step_chains_its_phases_in_order():
    """``train_step`` equals the port's own phases run in the order of
    ``wt_pse_tpu/train/step.py``: the teacher after the phase-1 update, the ROI
    from the pre-update logits. Same code on the same CPU, so bit for bit."""
    php = default_hparams("WT_PSE")
    cfg = StepConfig(php, DOMAINS, PDB)
    mcfg = ModelConfig.from_hparams(php)
    full, chain = (init_ensemble(mcfg, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
                   for _ in range(2))
    with torch.no_grad():
        for s in (full, chain):
            s.od.net.outc[0].bias += OD_SHIFT
    pb = to_port_batch(make_batch(seed=3))
    r = np.random.RandomState(4)
    pe = {k: torch.from_numpy(r.randn(B, 1, HW, HW).astype(np.float32)) for k in EPS_KEYS}
    got = make_train_step(cfg, device="cpu")(full, pb, eps=pe)

    image, tod, toc = pb["image"], pb["target_od"], pb["target_oc"]
    out_od, want = port_seg_phase(chain.od, image, tod, image,
                                  lambda o: port_bce_probs(o, tod), cfg, pe["phase1"], None)
    want.update(port_shape_phase(chain.od, chain.od_shape, image, tod, cfg,
                                 pe["phase2.teacher"], pe["phase2.student"], None))
    od_pred, roi, pos_w = _oc_roi(out_od, image, toc)
    _, m3 = port_seg_phase(chain.oc, roi, toc, roi,
                           lambda o: port_bce_pos_weight(o * od_pred, toc, pos_w), cfg,
                           pe["phase3"], None)
    m4 = port_shape_phase(chain.oc, chain.oc_shape, roi, toc, cfg, pe["phase4.teacher"],
                          pe["phase4.student"], None)
    want.update({k + "_oc": v for k, v in {**m3, **m4}.items()})
    want["pos_weight_oc"] = pos_w
    assert float(pos_w) != 1.0
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name in ("od", "od_shape", "oc", "oc_shape"):
        a, b = getattr(full, name).net.state_dict(), getattr(chain, name).net.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert full.step == 1
