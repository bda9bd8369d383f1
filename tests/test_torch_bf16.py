"""The port's bf16 mixed-precision mode (``compute_dtype='bfloat16'``) against the
JAX package's, on the CPU. Weights cross by ``state_dict_from_jax``: JAX-
initialised for single layers; for whole nets, drawn by the port, carried into
Flax variables by the JAX package's importer (a JAX init of a whole net costs
more than this file's time) and back. Inputs and the injected ``eps`` are numpy
draws from a seed (the ``eps`` rounded to bf16, as both sides draw it in the
compute dtype).

Tolerances, each measured on this CPU and stated beside its assertion:

- the covariance of a bf16 map: class ``f32_reduce`` against JAX's
  ``feature_covariance`` (bf16 operands, f32 accumulation) and the Pallas
  route, which widens to f32; its gradient within 1 bf16 ulp of the Pallas
  route's (which rounds its f32 dz to bf16 once, as the port does) and of
  the einsum route's, plus ``f32_reduce`` of the gradient's scale for the
  summation order;
- single ops (conv, BatchNorm, the 2x upsample): within 1 bf16 ulp
  elementwise; blocks (ConvD, ConvU): normwise ``BF16_BLOCK``; whole nets:
  nearer JAX's bf16 output than JAX's bf16 output is to JAX's f32 one (the
  noise of bf16 itself at that depth), and within ``BF16_NET``. Two
  frameworks round a bf16 conv's f32 sums in another order and BatchNorm's
  statistics in another order, so a few elements differ by an ulp after one
  op, and each later op spreads those differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.io.torch_import import convert_state_dict
from wt_pse_tpu.models import layers as JL
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.ops import whitening_pallas
from wt_pse_tpu.ops.whitening import feature_covariance as jax_feature_covariance
from wt_pse_tpu.ops.whitening import main_whitening_loss as jax_main_whitening_loss
from wt_pse_tpu.train.step import bce_probs as jax_bce_probs
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models import layers as L
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.ops import covariance_cuda as cc
from wt_pse_tpu_torch.ops.whitening import feature_covariance, main_whitening_loss
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import StepConfig, bce_probs, make_train_step

from torch_port import F32_REDUCE, carry, jax_init, nchw, torch_single_thread  # noqa: F401

B, HW = 3, 32
BF = jnp.bfloat16
BF16_BLOCK = (1e-2, 1e-3)  # measured 6.0e-3 (ConvD), 7.2e-3 (ConvU) of max|want|
# whole nets, normwise against max|want|: measured 0.089 (WT-PSE logits),
# 0.068 / 0.078 (student z / mu), 0.0112 (student predict); JAX's own bf16
# result against its f32 one: 0.117, 0.127 / 0.255, 0.0113
BF16_NET = (0.15, 1e-3)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(whitening_pallas, "INTERPRET", True)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and widened back, as numpy f32."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def as_np(x) -> np.ndarray:
    """An NHWC f32 numpy array from a JAX array or an NCHW torch tensor."""
    if isinstance(x, torch.Tensor):
        return np.transpose(x.detach().float().numpy(), (0, 2, 3, 1))
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_bf16(a: np.ndarray) -> torch.Tensor:
    """An NHWC numpy array as an NCHW bf16 tensor."""
    return nchw(a).to(torch.bfloat16)


def ulp_error(got, want, allowance: float = 0.0) -> float:
    """The largest ``|got - want| / (1 bf16 ulp of the larger magnitude + allowance)``."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((got - want).abs() / (ulp + allowance)).max())


def rel_error(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_norm_close(got, want, cls, what):
    rtol, atol = cls
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    bound = atol + rtol * np.abs(np.asarray(want, np.float64)).max()
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e} (class {cls})"


# -- the covariance ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 32, 32, 16), (2, 24, 40, 16)])
def test_bf16_covariance_forward_matches_jax(shape):
    zb = jnp.asarray(np.random.RandomState(0).randn(*shape), BF)
    zt = to_bf16(np.asarray(zb.astype(jnp.float32)))
    got = feature_covariance(zt)
    assert got.dtype == torch.float32
    for want in (jax_feature_covariance(zb), whitening_pallas.feature_covariance_pallas(zb)):
        want = np.asarray(want, np.float64)
        d = np.sqrt(np.abs(np.diagonal(want, axis1=1, axis2=2)))
        err = np.abs(got.numpy() - want) / (d[:, :, None] * d[:, None, :])
        assert err.max() <= F32_REDUCE[0], err.max()  # measured 5.6e-7


def test_bf16_covariance_gradient_within_one_ulp_of_jax():
    zb = jnp.asarray(np.random.RandomState(1).randn(2, 24, 40, 16), BF)

    def loss(z, fn):
        cov = fn(z)
        return jnp.sum(jnp.abs(cov)) + jnp.sum(cov ** 2)

    zt = to_bf16(np.asarray(zb.astype(jnp.float32))).requires_grad_(True)
    cov = feature_covariance(zt)
    (torch.sum(torch.abs(cov)) + torch.sum(cov ** 2)).backward()
    assert zt.grad.dtype == torch.bfloat16
    got = as_np(zt.grad)
    for fn in (whitening_pallas.feature_covariance_pallas, jax_feature_covariance):
        want = as_np(jax.grad(lambda z: loss(z, fn))(zb))
        # measured 1.0 ulp alone (at values whose products cancel), 0.81 with
        # the allowance, 99.99% of the elements bitwise equal
        assert ulp_error(got, want, F32_REDUCE[0] * np.abs(want).max()) <= 1.0


def test_plain_dz_rounds_once():
    """The plain backward of a bf16 map is the f32 product rounded to bf16 once."""
    r = np.random.RandomState(2)
    z = torch.from_numpy(r.randn(2, 16, 6, 7).astype(np.float32)).bfloat16()
    g = torch.from_numpy(r.randn(2, 16, 16).astype(np.float32))
    got = cc.covariance_backward_plain(z, g)
    want = cc.covariance_backward_plain(z.float(), g).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("ksize", [3, 1])
def test_conv_matches_refconv_in_bf16(ksize):
    r = np.random.RandomState(3)
    x = r.randn(B, HW, HW, 16).astype(np.float32)
    jm = JL.RefConv(16, ksize, dtype="bfloat16")
    v = jax_init(jm, None, jnp.asarray(x))
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(r.randn(*a.shape), a.dtype), v)
    pm = carry(L.Conv2d(16, 16, ksize, torch.bfloat16), v)
    got = pm(nchw(x))
    assert got.dtype == torch.bfloat16 and pm.weight.dtype == torch.float32
    assert ulp_error(as_np(got), as_np(jm.apply(v, jnp.asarray(x)))) <= 1.0  # measured 0


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_in_bf16(train):
    """f32 statistics and running stats, bf16 output, in train and eval mode."""
    xb = jnp.asarray(np.random.RandomState(4).randn(B, HW, HW, 16) * 2 + 0.5, BF)
    jm = JL.BatchNorm(16)
    v = jm.init(jax.random.PRNGKey(0), xb, True)
    bn = torch.nn.BatchNorm2d(16)
    if not train:  # eval reads running stats that one train call left
        _, mut = jm.apply(v, xb, True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        bn.running_mean.copy_(torch.from_numpy(np.array(mut["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(mut["batch_stats"]["var"])))
        bn.eval()
    got = bn(to_bf16(as_np(xb)))
    want, mut = jm.apply(v, xb, train, mutable=["batch_stats"])
    assert got.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    assert ulp_error(as_np(got), as_np(want)) <= 1.0  # measured 1.0 (17 of 49152)
    if train:
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(bn, name).numpy(),
                                       np.asarray(mut["batch_stats"][key]),
                                       rtol=F32_REDUCE[0], atol=1e-6)  # measured 2.3e-6 abs


def test_upsample_matches_jax_bitwise_in_bf16():
    xb = jnp.asarray(np.random.RandomState(5).randn(2, 7, 5, 3), BF)
    got = L.upsample2x(to_bf16(as_np(xb)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got), as_np(JL.upsample2x_bilinear(xb)))


@pytest.mark.parametrize("block", ["ConvD", "ConvU"])
def test_blocks_in_bf16(block):
    r = np.random.RandomState(6)
    if block == "ConvD":
        jm, pm = JL.ConvD(32, dtype="bfloat16"), L.ConvD(16, 32, dtype=torch.bfloat16)
        args = (jnp.asarray(r.randn(B, HW, HW, 16), BF),)
    else:
        jm, pm = JL.ConvU(32, dtype="bfloat16"), L.ConvU(32, dtype=torch.bfloat16)
        args = (jnp.asarray(r.randn(B, 16, 16, 64), BF), jnp.asarray(r.randn(B, HW, HW, 16), BF))
    v = jm.init(jax.random.PRNGKey(1), *args, True)
    pm = carry(pm, v)
    want, _ = jm.apply(v, *args, True, mutable=["batch_stats"])
    got = pm(*(to_bf16(as_np(a)) for a in args))
    assert got.dtype == torch.bfloat16
    assert_norm_close(as_np(got), as_np(want), BF16_BLOCK, block)


# -- whole nets and the phase-1 loss ---------------------------------------------


@pytest.fixture(scope="module")
def nets():
    """Seeded port WT-PSE and student weights (crossed to JAX by the JAX
    package's importer, and back by ``state_dict_from_jax``), the inputs, and
    the JAX modules' outputs: WT-PSE in train mode at bf16 and at f32 and in
    eval mode at bf16, and the bf16 student's train sample and predict."""
    r = np.random.RandomState(7)
    data = {"image": r.rand(B, HW, HW, 3).astype(np.float32) * 2 - 1,
            "mask": (r.rand(B, HW, HW, 1) > 0.5).astype(np.float32),
            "eps": bf16_round(r.randn(B, HW, HW, 1))}
    pcfg = ModelConfig.from_hparams(dict(default_hparams("WT_PSE"), compute_dtype="bfloat16"))
    assert pcfg.dtype == torch.bfloat16 and pcfg.compute_dtype == "bfloat16"
    gen = torch.Generator().manual_seed(7)
    v_main, v_stud = (jax.tree.map(jnp.asarray, convert_state_dict(net(pcfg, device="cpu",
                                                                     generator=gen).state_dict()))
                      for net in (WTPSE, ShapeStudent))
    hp = jax_default_hparams("WT_PSE")
    img, mask = jnp.asarray(data["image"]), jnp.asarray(data["mask"])
    want = {}
    for dt in (None, "bfloat16"):
        cfg = JaxModelConfig.from_hparams(dict(hp, compute_dtype=dt))
        eps = jnp.asarray(data["eps"], BF if dt else jnp.float32)
        (out, _, feats), _ = JaxWTPSE(cfg).apply(v_main, img, mask, img, True, eps,
                                                 mutable=["batch_stats"])
        student = JaxStudent(cfg)
        (z, mu, _), _ = student.apply(v_stud, img, True, eps, mutable=["batch_stats"],
                                      method=JaxStudent.update_forward)
        predict = student.apply(v_stud, img, method=JaxStudent.sample_from_image)
        want[dt] = {"out": as_np(out), "feats": [as_np(f) for f in feats], "z": as_np(z),
                    "mu": as_np(mu), "predict": as_np(predict), "jax": (out, feats)}
    return data, pcfg, v_main, v_stud, want


def assert_net_close(got, want: dict, key: str):
    """``got`` within ``BF16_NET`` of JAX's bf16 ``key`` and nearer it than
    JAX's bf16 result is to JAX's f32 one."""
    assert_norm_close(got, want["bfloat16"][key], BF16_NET, key)
    own = rel_error(want["bfloat16"][key], want[None][key])
    assert rel_error(got, want["bfloat16"][key]) <= own, key


def test_wtpse_forward_in_bf16(nets):
    data, pcfg, v, _, want = nets
    pm = carry(WTPSE(pcfg, device="cpu"), v)
    out, att, feats = pm(nchw(data["image"]), nchw(data["mask"]), nchw(data["image"]),
                         eps=nchw(data["eps"]))
    assert out.dtype == torch.bfloat16 and all(f.dtype == torch.bfloat16 for f in feats)
    assert att.dtype == torch.float32
    assert_net_close(as_np(out), want, "out")
    for i, (g, w) in enumerate(zip(feats, want["bfloat16"]["feats"])):
        assert_norm_close(as_np(g), w, BF16_BLOCK, f"DeepWT map {i}")  # measured <= 1.2e-3


def test_student_forward_in_bf16(nets):
    data, pcfg, _, v, want = nets
    pm = carry(ShapeStudent(pcfg, device="cpu"), v)
    z, mu, _ = pm.update_forward(nchw(data["image"]), eps=nchw(data["eps"]))
    assert z.dtype == mu.dtype == torch.bfloat16
    assert_net_close(as_np(z), want, "z")
    assert_net_close(as_np(mu), want, "mu")
    # a fresh copy: the train-mode call above moved the BN running statistics
    got = carry(ShapeStudent(pcfg, device="cpu"), v).eval().sample_from_image(
        nchw(data["image"]))
    assert got.dtype == torch.bfloat16
    assert_net_close(as_np(got), want, "predict")


def test_phase1_loss_in_bf16(nets):
    """Forward, BCE and the whitening losses of phase 1 from the same weights
    and eps. The port takes the BCE of the f32-widened logits, JAX of the bf16
    ones; both take the whitening losses in f32 over the bf16 maps."""
    data, pcfg, v, _, want = nets
    out, feats = want["bfloat16"]["jax"]
    want_seg = float(jax_bce_probs(out, jnp.asarray(data["mask"])))
    want_inst, want_dom = (float(t) for t in jax_main_whitening_loss(feats, 3, 1))
    pm = carry(WTPSE(pcfg, device="cpu"), v)
    out, _, feats = pm(nchw(data["image"]), nchw(data["mask"]), nchw(data["image"]),
                       eps=nchw(data["eps"]))
    with torch.no_grad():
        got_seg = float(bce_probs(out.float(), nchw(data["mask"])))
        got_inst, got_dom = (float(t) for t in main_whitening_loss(feats, 3, 1))
    # measured relative errors: seg 1.5e-4 (JAX's BCE of bf16 logits), instance
    # 1.9e-7, domain 3.6e-6
    for name, got, w, rtol in (("seg", got_seg, want_seg, 2e-3),
                               ("instance", got_inst, want_inst, 1e-4),
                               ("domain", got_dom, want_dom, 1e-3)):
        np.testing.assert_allclose(got, w, rtol=rtol, err_msg=name)


def test_bf16_steps_learn_and_keep_f32_state():
    """8 bf16 steps on one fixed batch (``tests/test_train_step.py:76-93``), at
    16x16 to keep the file short: finite, the seg loss falls, parameters, BN
    statistics and Adam's moments stay f32."""
    hp = dict(default_hparams("WT_PSE"), compute_dtype="bfloat16")
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    step = make_train_step(StepConfig(hp, 3, 1), device="cpu")
    r = np.random.RandomState(8)
    hw = 16
    yy, xx = np.mgrid[0:hw, 0:hw]
    od = ((yy - 8) ** 2 + (xx - 8) ** 2 < 25).astype(np.float32)
    batch = {"image": r.rand(B, 3, hw, hw).astype(np.float32) * 2 - 1 + 0.3 * od,
             "target_od": np.tile(od[None, None], (B, 1, 1, 1)),
             "target_oc": np.tile((od * r.rand(hw, hw) > 0.7)[None, None], (B, 1, 1, 1))
             .astype(np.float32)}
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(8):
        metrics = step(state, batch, generator=gen)
        assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in metrics.values())
        losses.append(float(metrics["loss_seg"]))
    assert losses[-1] < losses[0], losses
    for ns in state.net_states():
        for name, t in list(ns.net.named_parameters()) + list(ns.net.named_buffers()):
            if not name.endswith("num_batches_tracked"):
                assert t.dtype == torch.float32, name
        for group in ns.opt.state.values():
            assert all(s.dtype == torch.float32 for s in group.values() if s.dim()), "Adam"
