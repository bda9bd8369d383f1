"""The ``forward/*`` entries of ``tests/goldens.json`` reproduce through the port:
the JAX nets are initialised exactly as ``tests/test_goldens.py:139-158`` does,
their weights carried into the port, and the student-shape predict forward of
the port gives the frozen fingerprints at their own class (``conv``)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE

from torch_port import carry, nchw, torch_single_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.json")
with open(GOLDENS) as _f:
    _FROZEN = json.load(_f)
NAMES = sorted(k for k in _FROZEN["values"] if k.startswith("forward/"))
HW, N = 16, 9


@pytest.fixture(scope="module")
def logits():
    jcfg = JaxModelConfig.from_hparams(dict(jax_default_hparams("WT_PSE")), n_classes=1)
    main, stud = JaxWTPSE(jcfg), JaxStudent(jcfg)
    img = np.random.RandomState(3).rand(N, HW, HW, 3).astype(np.float32) * 2 - 1
    v_main = main.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                       jnp.asarray(img), jnp.zeros((N, HW, HW, 1)),
                       method=JaxWTPSE.initialize)
    v_stud = stud.init({"params": jax.random.PRNGKey(2), "sample": jax.random.PRNGKey(3)},
                       jnp.asarray(img), method=JaxStudent.initialize)
    cfg = ModelConfig.from_hparams(default_hparams("WT_PSE"))
    p_main = carry(WTPSE(cfg, device="cpu"), v_main).eval()
    p_stud = carry(ShapeStudent(cfg, device="cpu"), v_stud).eval()
    with torch.no_grad():
        x = nchw(img)
        out = p_main.predict_with_shape(x, p_stud.sample_from_image(x))
    return np.transpose(out.numpy(), (0, 2, 3, 1)).astype(np.float64)


@pytest.mark.parametrize("name", NAMES)
def test_forward_golden(logits, name):
    rec = _FROZEN["values"][name]
    rtol, atol = _FROZEN["meta"]["tolerances"][rec["tol"]]
    value = {"forward/logits_mean": logits.mean(), "forward/logits_std": logits.std(),
             "forward/logits_px_0_8_8": logits[0, 8, 8, 0],
             "forward/logits_px_5_3_12": logits[5, 3, 12, 0]}[name]
    assert np.isclose(value, rec["value"], rtol=rtol, atol=atol), (
        f"{name}: port {value!r} vs golden {rec['value']!r} (class {rec['tol']})")
