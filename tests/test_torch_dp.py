"""The port's data parallelism on 2 gloo ranks (``tests/torch_dp_worker.py``)
against the JAX package's under ``shard_map`` on 2 of the 8 virtual CPU
devices of ``tests/conftest.py``, and against the port's own single process.

- sync BN against ``BatchNorm(axis_name='data')``: output, running
  statistics and the input gradient of a global loss, at class ``conv``;
- the whitening losses against ``main_whitening_loss`` /
  ``student_whitening_loss`` with ``axis_name``: each rank's values and the
  gradients of the ranks' summed losses with respect to the maps, at class
  ``f32_reduce`` (3 domains x 2 samples a rank);
- the port's DP step (shape phases and whitening on, draws injected) against
  its single-process step on the interleaved global batch, at the bounds of
  ``tests/test_parallel.py:227-236``.

Every rank's parameters, BN statistics and optimizer state are bitwise equal
after each step (the digests of ``torch_dp_worker.state_digest``).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from wt_pse_tpu.models.layers import BatchNorm as JaxBatchNorm
from wt_pse_tpu.ops.whitening import main_whitening_loss, student_whitening_loss
from wt_pse_tpu_torch.config import default_hparams
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.train.state import init_ensemble
from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

from test_torch_step import LR, OD_SHIFT
from torch_dp_worker import bn_rank, run, step_rank, whitening_rank
from torch_port import CONV, F32_REDUCE, assert_close, nchw, nhwc, torch_single_thread  # noqa: F401

NETS = ("od", "od_shape", "oc", "oc_shape")
N, DOMAINS, HW = 2, 3, 32


def mesh2():
    return Mesh(np.array(jax.devices()[:N]), ("data",))


def test_sync_bn_matches_jax_batchnorm_over_two_devices(tmp_path):
    r = np.random.RandomState(0)
    x = (r.randn(4, 8, 16, 16) * 2 + 0.5).astype(np.float32)  # NCHW, 2 rows a rank
    w = r.randn(4, 8, 16, 16).astype(np.float32)
    got = run(bn_rank, tmp_path, [x[:2], x[2:]], [w[:2], w[2:]])

    bn = JaxBatchNorm(8, axis_name="data")
    variables = JaxBatchNorm(8).init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 8)), False)

    def forward(xg):
        def local(xl):
            out, mut = bn.apply(variables, xl, True, mutable=["batch_stats"])
            return out, mut["batch_stats"]

        return shard_map(local, mesh=mesh2(), in_specs=P("data"),
                         out_specs=(P("data"), P()))(xg)

    xj, wj = jnp.asarray(nhwc(torch.from_numpy(x))), jnp.asarray(nhwc(torch.from_numpy(w)))
    out, stats = forward(xj)
    grad = jax.grad(lambda xg: jnp.sum(forward(xg)[0] * wj))(xj)
    for rank, res in enumerate(got):
        rows = slice(2 * rank, 2 * rank + 2)
        assert_close(res["out"], nchw(out[rows]).numpy(), CONV, f"rank {rank} output")
        assert_close(res["grad"], nchw(grad[rows]).numpy(), CONV, f"rank {rank} input grad")
        assert_close(res["mean"], stats["mean"], CONV, f"rank {rank} running mean")
        assert_close(res["var"], stats["var"], CONV, f"rank {rank} running var")
        assert res["tracked"] == 1
    for k in ("mean", "var"):
        assert np.array_equal(got[0][k], got[1][k])


def _jax_whitening(maps_global, pdb):
    """Per device (main terms, student terms) and the gradients of the
    devices' summed weighted losses with respect to the global maps."""

    def per_device(fn, weights):
        def local(*maps):
            terms = fn(list(maps), DOMAINS, pdb, 0.1, True, "data", N)
            return jnp.stack(terms)[None], sum(w * t for w, t in zip(weights, terms))[None]

        return shard_map(local, mesh=mesh2(), in_specs=(P("data"),) * 3,
                         out_specs=(P("data"), P("data")))

    out = {}
    for name, fn, weights in (("main", main_whitening_loss, (1.0, 2.0)),
                              ("student", student_whitening_loss, (1.0, 0.5, 3.0, 2.0))):
        sm = per_device(fn, weights)
        out[name] = np.asarray(jax.jit(sm)(*maps_global)[0])
        out[name + "_grads"] = jax.jit(jax.grad(lambda *m: jnp.sum(sm(*m)[1]),
                                                argnums=(0, 1, 2)))(*maps_global)
    return out


def test_whitening_losses_gather_the_mmd_like_jax(tmp_path):
    pdb = 2  # a rank's share of each domain
    r = np.random.RandomState(1)
    maps = [[(r.randn(DOMAINS * pdb, 16, 8, 8) * (1 + d) + 0.3 * rank).astype(np.float32)
             for d in range(3)] for rank in range(N)]
    got = run(whitening_rank, tmp_path, maps, DOMAINS, pdb)
    # JAX: the devices' local batches stacked along the batch axis, NHWC
    want = _jax_whitening([jnp.asarray(np.concatenate(
        [nhwc(torch.from_numpy(maps[rank][i])) for rank in range(N)])) for i in range(3)], pdb)
    for name in ("main", "student"):
        for rank in range(N):
            np.testing.assert_allclose(got[rank][name], want[name][rank],
                                       rtol=F32_REDUCE[0], atol=F32_REDUCE[1],
                                       err_msg=f"{name} rank {rank}")
            rows = slice(rank * DOMAINS * pdb, (rank + 1) * DOMAINS * pdb)
            for i, g in enumerate(got[rank][name + "_grads"][:2]):
                assert_close(g, nchw(want[name + "_grads"][i][rows]).numpy(), F32_REDUCE,
                             f"{name} rank {rank} map {i} gradient")
        # the MMD is computed on the gathered set: the same on both ranks
        assert got[0][name][-1] == got[1][name][-1] and got[0][name][-1] > 0


def _batch(seed, b):
    """A domain-contiguous NHWC batch of ``b`` = 3 domains x b/3 at 32x32:
    images with a per-domain shift, disk masks of seeded centres."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    od = np.zeros((b, HW, HW, 1), np.float32)
    oc = np.zeros_like(od)
    for i in range(b):
        cy, cx = r.uniform(12, 20, 2)
        od[i, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 < 100
        oc[i, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 < 36
    img = r.rand(b, HW, HW, 3).astype(np.float32) * 1.6 - 0.8
    img += 0.2 * (np.arange(b) // (b // DOMAINS))[:, None, None, None] - 0.2
    return {"image": img, "target_od": od, "target_oc": oc}


def assert_nets_close(have: dict, want: dict, lr=LR):
    """Parameters within 2.2*lr elementwise and 6e-5 in the mean, BN running
    statistics within 2e-3 and 2e-4 (``tests/test_torch_step.py:6-10``)."""
    pdiff, sdiff = [], []
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            d = np.abs(np.asarray(have[k]) - w.numpy()).ravel()
            (sdiff if k.endswith(("running_mean", "running_var")) else pdiff).append(d)
    pdiff, sdiff = np.concatenate(pdiff), np.concatenate(sdiff)
    assert pdiff.max() <= 2.2 * lr and pdiff.mean() <= 6e-5, ("params", pdiff.max())
    assert sdiff.max() <= 2e-3 and sdiff.mean() <= 2e-4, ("bn stats", sdiff.max())


def test_dp_step_matches_single_process_step_on_the_global_batch(tmp_path):
    """2 ranks of 3 domains x 1 against one process on the 3 x 2 global batch
    laid out as the MMD gather lays it: each domain's rank-0 row, then its
    rank-1 row."""
    hp = default_hparams("WT_PSE")
    state = init_ensemble(ModelConfig.from_hparams(hp), device="cpu",
                          generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        state.od.net.outc[0].bias += OD_SHIFT
    state_dicts = {name: {k: v.clone() for k, v in getattr(state, name).net.state_dict().items()}
                   for name in NETS}
    r = np.random.RandomState(4)
    shards = [{k: nchw(v).numpy() for k, v in _batch(20 + rank, DOMAINS).items()}
              for rank in range(N)]
    eps = [{k: r.randn(DOMAINS, 1, HW, HW).astype(np.float32) for k in EPS_KEYS}
           for _ in range(N)]
    got = run(step_rank, tmp_path, hp, state_dicts, shards, eps, DOMAINS, N)
    assert got[0]["digest"] == got[1]["digest"]

    def interleave(parts):  # (domain, rank) order
        return torch.from_numpy(np.concatenate([p[d:d + 1] for d in range(DOMAINS)
                                                for p in parts]))

    batch = {k: interleave([s[k] for s in shards]) for k in shards[0]}
    want = make_train_step(StepConfig(hp, DOMAINS, N), device="cpu")(
        state, batch, eps={k: interleave([e[k] for e in eps]) for k in EPS_KEYS})
    pm = got[0]["metrics"]
    assert set(pm) == set(want) and pm["loss_dom_wt"] > 0 and pm["loss_dom_wt_shape"] > 0
    # tests/test_parallel.py:227-236
    np.testing.assert_allclose(pm["loss_seg"], float(want["loss_seg"]), rtol=2e-3)
    np.testing.assert_allclose(pm["loss_ins_wt"], float(want["loss_ins_wt"]), rtol=5e-3)
    np.testing.assert_allclose(pm["loss_dom_wt"], float(want["loss_dom_wt"]), rtol=5e-3,
                               atol=1e-5)
    # the other losses at the loosest of those bounds; the train Dice is a
    # count of thresholded pixels, where one pixel across 0.75 moves it
    for k in sorted(set(want) - {"train_dice", "train_dice_oc"}):
        np.testing.assert_allclose(pm[k], float(want[k]), rtol=5e-3, atol=1e-5, err_msg=k)
    # every net at the Adam-step bounds of tests/test_torch_step.py: Adam's
    # first step is about lr*sign(grad), and where a gradient is at f32 noise
    # the two summation orders flip its sign (1 of the 432 weights of the
    # first leaf moves 2*lr the other way, past tests/test_parallel.py:236's
    # rtol 1e-2)
    for name in NETS:
        assert_nets_close(got[0]["state_dicts"][name], getattr(state, name).net.state_dict())
