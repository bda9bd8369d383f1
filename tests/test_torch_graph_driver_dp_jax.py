"""The graph's step body under data parallelism against the JAX package's
one-program epoch, on the CPU: :meth:`GraphedStep.body` on fed buffers
(``batch_fn=None``) runs the port's DP step (``make_dp_fused``) on 2 gloo ranks
(``tests/torch_dp_worker.py``) for 2 consecutive steps, against JAX's
``make_train_step(StepConfig(..., axis_name='data', axis_size=2))`` under
``shard_map`` on 2 of the 8 virtual CPU devices, run as a ``jax.lax.scan``
over the same 2 fed batches: the form of JAX's ``epoch``
(``wt_pse_tpu/train/trainer.py:302-315``), each step's metrics ``pmean``-ed.

The configuration is ``tests/test_torch_dp_jax_step.py``'s: ``shape_prior=False``
(no draw), whitening on, the weights carried by ``state_dict_from_jax``, with
one change: the OD head is lifted so far (``ROI_LIFT``) that the phase-3 ROI
is the whole image at both steps. With that file's lift, half the OD logits
lie near the 0.75 threshold, and once the first step has left the weights
apart in their last bits, pixels cross it and move the second step's OC
metrics (measured: ``pos_weight_oc`` 1.2e-3 and ``loss_seg_oc`` 2.5e-3 apart,
relative); that file holds the partial ROI from equal weights. Bounds:
step 0, from equal weights, at ``tests/test_torch_step.py``'s (losses rtol
1e-5, ``pos_weight`` rtol 1e-4); step 1, from weights one Adam step left up
to 2 lr apart where a gradient is at noise, the losses at class ``conv``
(measured 1.1e-5 and 1.2e-5 relative) and ``pos_weight`` (exact here) at
rtol 1e-4; the nets after the two steps at ``assert_net_close``'s bounds
with 2.2 lr a step taken. Every rank ends with the same state, bitwise, and
the same metric columns.
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
from wt_pse_tpu.train.state import init_ensemble as jax_init_ensemble
from wt_pse_tpu.train.step import StepConfig as JaxStepConfig
from wt_pse_tpu.train.step import make_train_step as jax_make_train_step
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.io.convert import state_dict_from_jax

from test_torch_dp import DOMAINS, HW, N, NETS, _batch, mesh2
from test_torch_step import LR, OD_SHIFT, assert_net_close
from torch_dp_worker import graph_body_fed_rank, run
from torch_port import CONV, nchw, torch_single_thread  # noqa: F401

STEPS = 2
ROI_LIFT = OD_SHIFT + 5.0


def test_dp_body_over_two_steps_matches_jax_scanned_shard_map_step(tmp_path):
    hp = dict(jax_default_hparams("WT_PSE"), shape_prior=False, whitening=True)
    jcfg = JaxModelConfig.from_hparams(hp, bn_axis_name="data")
    jnets = (JaxWTPSE(jcfg), JaxStudent(jcfg), JaxWTPSE(jcfg, two_step=True), JaxStudent(jcfg))
    jstate, txs = jax_init_ensemble(*jnets, (DOMAINS, HW, HW, 3), jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jstate.od.params)
    params["outc"]["c0"]["bias"] = params["outc"]["c0"]["bias"] + ROI_LIFT  # ROI: all
    jstate = jstate.replace(od=jstate.od.replace(params=jax.tree.map(jnp.asarray, params)))
    state_dicts = {name: state_dict_from_jax({"params": getattr(jstate, name).params,
                                              "batch_stats": getattr(jstate, name).batch_stats})
                   for name in NETS}

    # step s, rank r: 3 domains x 1
    shards = [[_batch(40 + 10 * s + r, DOMAINS) for r in range(N)] for s in range(STEPS)]
    step = jax_make_train_step(*jnets, txs, JaxStepConfig(hp, DOMAINS, 1, axis_name="data",
                                                          axis_size=N))

    def device_fn(state, batches, key):
        def body(st, i_batch):
            i, batch = i_batch
            st, metrics = step(st, batch, jax.random.fold_in(key, i))
            return st, jax.lax.pmean(metrics, "data")

        return jax.lax.scan(body, state, (jnp.arange(STEPS), batches))

    epoch = jax.jit(shard_map(device_fn, mesh=mesh2(), in_specs=(P(), P(None, "data"), P()),
                              out_specs=(P(), P()), check_vma=False))
    jbatches = {k: jnp.stack([jnp.concatenate([jnp.asarray(sh[k]) for sh in step_shards])
                              for step_shards in shards]) for k in shards[0][0]}
    jnew, jm = epoch(jstate, jbatches, jax.random.PRNGKey(0))

    php = dict(default_hparams("WT_PSE"), shape_prior=False, whitening=True)
    per_rank = [[{k: nchw(v).numpy() for k, v in shards[s][r].items()} for s in range(STEPS)]
                for r in range(N)]
    got = run(graph_body_fed_rank, tmp_path, php, state_dicts, per_rank, DOMAINS, N)
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["step"] == STEPS
    pm = got[0]["metrics"]
    assert set(pm) == set(jm)
    for k, v in pm.items():
        assert np.array_equal(v, got[1]["metrics"][k]) and v.shape == (STEPS,), k
    # the ROI is the whole image at both steps: pos_weight is the global
    # pixel count over the global cup count
    for s in range(STEPS):
        cup = sum(float(np.sum(sh["target_oc"])) for sh in shards[s])
        assert float(jm["pos_weight_oc"][s]) == np.float32(N * DOMAINS * HW * HW / cup)
    for s in range(STEPS):
        # step 0 from equal weights at tests/test_torch_step.py's bounds; step 1
        # from weights that one Adam step left up to 2 lr apart, at class conv
        rtol, atol = (1e-5, 0.0) if s == 0 else CONV
        for k in ("loss_seg", "loss_seg_oc", "loss_ins_wt", "loss_dom_wt"):
            np.testing.assert_allclose(pm[k][s], float(jm[k][s]), rtol=rtol, atol=atol,
                                       err_msg=f"{k} step {s}")
        np.testing.assert_allclose(pm["pos_weight_oc"][s], float(jm["pos_weight_oc"][s]),
                                   rtol=1e-4, err_msg=f"pos_weight_oc step {s}")
    for name in ("od", "oc"):  # 2.2 lr a step taken
        have = {k: torch.from_numpy(v) for k, v in got[0]["state_dicts"][name].items()}
        assert_net_close(have, getattr(jnew, name), STEPS * LR)
