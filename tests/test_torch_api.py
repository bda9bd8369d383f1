"""The port's one-call inference (``wt_pse_tpu_torch/api.py``) against the JAX
package's ``wt_pse_tpu/api.py``, on the CPU.

- ``load_predictor`` on a port checkpoint (network resolution 32 here), for
  uint8 inputs at 48x48 (LANCZOS down, logits upsampled back) and at 32x32,
  and for float inputs in [-1, 1]: logits at class ``conv`` against JAX's
  (the port's are NCHW), masks equal;
- the 2-class convention (``label=None``: the disc mask from channel 1) and a
  falsy label, on stubbed predicts: masks equal to the JAX ``Predictor``'s.
"""

import numpy as np
import pytest
import torch

import wt_pse_tpu.api as jax_api
from wt_pse_tpu_torch import api
from wt_pse_tpu_torch.io.checkpoint import save_ensemble

from test_torch_checkpoint import _port_state
from torch_port import CONV, assert_close, torch_single_thread  # noqa: F401


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("api") / "checkpoint_2.pth.tar")
    save_ensemble(ckpt, _port_state(1))
    return (api.load_predictor(ckpt, image_size=32, device="cpu"),
            jax_api.load_predictor(ckpt, image_size=32))


@pytest.mark.parametrize("hw,kind", [(48, "uint8"), (48, "float"), (32, "uint8")])
def test_load_predictor_matches_jax(predictors, hw, kind):
    port, jax_pred = predictors
    u8 = (np.random.RandomState(hw).rand(2, hw, hw, 3) * 255).astype(np.uint8)
    images = u8.astype(np.float32) / 127.5 - 1.0 if kind == "float" else u8
    got, want = port(images), jax_pred(images)
    assert got["od"].shape == got["oc"].shape == (2, hw, hw) and got["od"].dtype == np.uint8
    for k in ("od_logits", "oc_logits"):
        assert got[k].shape == (2, 1, hw, hw)
        assert_close(np.moveaxis(got[k], 1, -1), want[k], CONV, k)
    for k in ("od", "oc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["od"].sum() > 0  # the lifted OD logits leave a mask to clean
    if kind == "float":  # rounded back to uint8 before the LANCZOS resize
        np.testing.assert_allclose(got["od_logits"], port(u8)["od_logits"], rtol=0, atol=1e-5)
    one = port(images[0], postprocess=False)
    assert set(one) == {"od_logits", "oc_logits"} and one["od_logits"].shape == (1, 1, hw, hw)


@pytest.mark.parametrize("label", [None, "OD", ""])
def test_channel_convention_matches_jax(label):
    h = 32
    cup = np.full((h, h), -10.0, np.float32)
    cup[12:20, 12:20] = 10.0
    disc = np.full((h, h), -10.0, np.float32)
    disc[6:26, 6:26] = 10.0
    disc[2, 2] = 10.0  # a speck the cleaning removes
    nhwc = np.stack([cup, disc], -1)[None]
    port = api.Predictor(lambda x: (torch.from_numpy(np.moveaxis(nhwc, -1, 1)),) * 2,
                         label=label, image_size=h, device="cpu")
    jax_pred = jax_api.Predictor(lambda x: (nhwc, nhwc), (), label=label, image_size=h)
    got = port(np.zeros((1, h, h, 3), np.float32))
    want = jax_pred(np.zeros((1, h, h, 3), np.float32))
    for k in ("od", "oc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    disc[2, 2] = -10.0
    np.testing.assert_array_equal(got["od"][0], disc > 0 if label is None else cup > 0)
