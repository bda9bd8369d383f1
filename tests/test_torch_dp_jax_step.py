"""One data-parallel step of the port on 2 gloo ranks
(``tests/torch_dp_worker.py``) against the JAX package's
``make_train_step(StepConfig(..., axis_name='data', axis_size=2))`` under
``shard_map`` on 2 of the 8 virtual CPU devices, as ``parallel/dp.py`` runs
it (replicated state, each device's domain-contiguous shard, the metrics
``pmean``-ed).

The configuration is the deterministic one of ``tests/test_torch_step.py``
(``shape_prior=False``: no draw, which the JAX step could not take injected)
with whitening on, at that file's bounds; the weights cross by
``state_dict_from_jax``. JAX's WTPSE makes its DeepWT maps only under
``shape_prior``, so the whitening terms are 0 on both sides: this case holds
sync BN in whole nets, each phase's gradient mean, the ``pos_weight`` sum
and the metric mean. So a second case holds phase 1 with shape prior and
whitening on (the draws injected), against a test-side composition of JAX's
phase under ``shard_map``, as ``tests/test_torch_step_phases.py`` composes
it on one device, with ``main_whitening_loss(axis_name='data')`` and the
gradient ``pmean``: the MMD gather, sync BN and the gradient mean in one
phase, at class ``conv`` and ``tests/test_torch_step.py``'s net bounds. Both
ranks end with bitwise-equal states.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from wt_pse_tpu.config import default_hparams as jax_default_hparams
from wt_pse_tpu.models.common import ModelConfig as JaxModelConfig
from wt_pse_tpu.models.shape_prior import ShapeStudent as JaxStudent
from wt_pse_tpu.models.wt_pse import WTPSE as JaxWTPSE
from wt_pse_tpu.io.torch_import import convert_state_dict
from wt_pse_tpu.ops.whitening import main_whitening_loss
from wt_pse_tpu.train.state import NetState, reference_adam
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu.train.step import StepConfig as JaxStepConfig
from wt_pse_tpu.train.step import bce_probs
from wt_pse_tpu.train.step import make_train_step as jax_make_train_step
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.io.convert import state_dict_from_jax
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.models.wt_pse import WTPSE

from test_torch_dp import DOMAINS, HW, N, NETS, _batch, mesh2
from test_torch_step import LR, OD_SHIFT, assert_net_close
from torch_dp_worker import run, seg_phase_rank, step_rank
from torch_port import CONV, nchw, torch_single_thread  # noqa: F401


def test_dp_step_matches_jax_shard_map_step(tmp_path):
    hp = dict(jax_default_hparams("WT_PSE"), shape_prior=False, whitening=True)
    jcfg = JaxModelConfig.from_hparams(hp, bn_axis_name="data")
    jnets = (JaxWTPSE(jcfg), JaxStudent(jcfg), JaxWTPSE(jcfg, two_step=True), JaxStudent(jcfg))
    jstate, txs = jax_init_ensemble(*jnets, (DOMAINS, HW, HW, 3), jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jstate.od.params)
    params["outc"]["c0"]["bias"] = params["outc"]["c0"]["bias"] + OD_SHIFT  # a non-empty ROI
    jstate = jstate.replace(od=jstate.od.replace(params=jax.tree.map(jnp.asarray, params)))
    state_dicts = {name: state_dict_from_jax({"params": getattr(jstate, name).params,
                                              "batch_stats": getattr(jstate, name).batch_stats})
                   for name in NETS}

    shards = [_batch(10 + rank, DOMAINS) for rank in range(N)]  # 3 domains x 1 a rank
    step = jax_make_train_step(*jnets, txs, JaxStepConfig(hp, DOMAINS, 1, axis_name="data",
                                                          axis_size=N))

    def device_fn(state, batch, key):
        new_state, metrics = step(state, batch, key)
        return new_state, jax.lax.pmean(metrics, "data")

    dp_step = jax.jit(shard_map(device_fn, mesh=mesh2(), in_specs=(P(), P("data"), P()),
                                out_specs=(P(), P()), check_vma=False))
    jbatch = {k: jnp.concatenate([jnp.asarray(s[k]) for s in shards]) for k in shards[0]}
    jnew, jm = dp_step(jstate, jbatch, jax.random.PRNGKey(0))

    php = dict(default_hparams("WT_PSE"), shape_prior=False, whitening=True)
    got = run(step_rank, tmp_path, php, state_dicts,
              [{k: nchw(v).numpy() for k, v in s.items()} for s in shards], None, DOMAINS, N)
    assert got[0]["digest"] == got[1]["digest"]
    pm = got[0]["metrics"]
    assert set(pm) == set(jm)
    assert float(jm["pos_weight_oc"]) != 1.0 and pm["loss_dom_wt"] == 0.0
    for k in ("loss_seg", "loss_seg_oc", "loss_ins_wt", "loss_dom_wt"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(pm["pos_weight_oc"], float(jm["pos_weight_oc"]), rtol=1e-4)
    for name in ("od", "oc"):
        have = {k: torch.from_numpy(v) for k, v in got[0]["state_dicts"][name].items()}
        assert_net_close(have, getattr(jnew, name), LR)


def test_dp_phase_one_with_whitening_matches_jax_composition(tmp_path):
    php = default_hparams("WT_PSE")  # shape prior and whitening on
    net = WTPSE(ModelConfig.from_hparams(php), device="cpu",
                generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.outc[0].bias += OD_SHIFT
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    shards = [_batch(30 + rank, DOMAINS) for rank in range(N)]
    r = np.random.RandomState(6)
    eps = [r.randn(DOMAINS, HW, HW, 1).astype(np.float32) for _ in range(N)]
    got = run(seg_phase_rank, tmp_path, php, sd,
              [{k: nchw(v).numpy() for k, v in s.items()} for s in shards],
              [nchw(e).numpy() for e in eps], DOMAINS)
    assert got[0]["digest"] == got[1]["digest"]

    model = JaxWTPSE(JaxModelConfig.from_hparams(jax_default_hparams("WT_PSE"),
                                                 bn_axis_name="data"))
    tx = reference_adam(LR)
    jnet = NetState.create(jax.tree.map(jnp.asarray, convert_state_dict(sd)), tx)

    def device_fn(net, image, target, e):
        def loss(params):
            (out, _att, feats), mut = model.apply(
                {"params": params, "batch_stats": net.batch_stats}, image, target, image,
                True, e, mutable=["batch_stats"])
            seg = bce_probs(out, target)
            inst, dom = main_whitening_loss(feats, DOMAINS, 1, 0.0, True, "data", N)
            return seg + inst + dom, (mut["batch_stats"], seg, inst, dom)

        grads, (bs, seg, inst, dom) = jax.grad(loss, has_aux=True)(net.params)
        new = net.apply_updates(jax.lax.pmean(grads, "data"), tx, bs)
        return new, jax.lax.pmean({"loss_seg": seg, "loss_ins_wt": inst,
                                   "loss_dom_wt": dom}, "data")

    phase = jax.jit(shard_map(device_fn, mesh=mesh2(), in_specs=(P(), P("data"), P("data"),
                                                                  P("data")),
                              out_specs=(P(), P()), check_vma=False))
    cat = lambda k: jnp.concatenate([jnp.asarray(s[k]) for s in shards])
    jnew, jm = phase(jnet, cat("image"), cat("target_od"), jnp.concatenate(eps))
    rtol, atol = CONV
    assert got[0]["metrics"]["loss_dom_wt"] > 0
    for k, v in jm.items():
        np.testing.assert_allclose(got[0]["metrics"][k], float(v), rtol=rtol, atol=atol,
                                   err_msg=f"{k} (class conv)")
    assert_net_close({k: torch.from_numpy(v) for k, v in got[0]["state_dict"].items()},
                     jnew, LR)
