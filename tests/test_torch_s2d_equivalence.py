"""Space-to-depth is a TPU layout with the same math: the port's unpacked
two-stage predict against the JAX package's packed one
(``make_predict_fn(..., packed=True)``, ``wt_pse_tpu/train/eval.py:37-70``) at
``space_to_depth_levels`` 1 and 2, on carried weights, at class ``conv`` (OD
logits; OC where both OD masks agree, with no OD pixel on the other side of
the threshold). The port accepts the two hparams and runs unpacked
(``wt_pse_tpu_torch/config/hparams.py``), so this test is the gate that
closes porting ``ops/packed.py``."""

import numpy as np
import pytest

import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.train.eval import make_predict_fn as jax_predict_fn
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.eval import make_predict_fn
from wt_pse_tpu_torch.train.state import init_ensemble

from test_torch_spatial import _hold, _jax_variables, _state_dicts
from torch_port import nchw, nhwc, torch_single_thread  # noqa: F401


@pytest.mark.parametrize("levels", [1, 2])
def test_unpacked_port_predict_matches_the_packed_jax_predict(levels):
    s2d = dict(space_to_depth=True, space_to_depth_levels=levels)
    jcfg = JaxModelConfig.from_hparams(dict(jax_default_hparams("WT_PSE"), **s2d))
    assert jcfg.s2d and jcfg.s2d_levels == levels
    jnets = (JaxWTPSE(jcfg), JaxStudent(jcfg), JaxWTPSE(jcfg, two_step=True), JaxStudent(jcfg))
    img = np.random.RandomState(levels).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    want_od, want_oc = jax_predict_fn(*jnets, packed=True)(*_jax_variables("WT_PSE"),
                                                            jnp.asarray(img))
    state = init_ensemble(ModelConfig.from_hparams(dict(default_hparams("WT_PSE"), **s2d)),
                          device="cpu")
    nets = [ns.net for ns in state.net_states()]
    for net, sd in zip(nets, _state_dicts("WT_PSE")):
        net.load_state_dict(sd, strict=True)
    got_od, got_oc = make_predict_fn(*nets, device="cpu")(nchw(img))
    held = _hold(nhwc(got_od), nhwc(got_oc), want_od, want_oc, f"levels {levels}", 0)
    assert 0.02 < held["roi_share"] < 0.9, held  # a ROI to cut
