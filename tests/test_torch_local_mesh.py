"""The sharded predicts over a mesh of one process's devices
(``data_mesh(devices=...)``, ``wt_pse_tpu_torch/parallel/mesh.py::LocalMesh``),
on CPU shards, each a thread of its own, as JAX's virtual CPU devices stand
in for chips (``tests/conftest.py``).

- The in-process group: the all-reduce sums in rank order, bitwise the same
  on every shard; the rows all-gather, the float broadcast and the barrier
  over it; ``halo_rows`` gives the rows of ``tests/test_torch_spatial.py``'s
  3-rank test (zero and replicate fill, bf16 kept bf16) and counts one an
  exchange, from however many threads; ``row_shard`` holds in its own
  thread only.
- A failing shard: the call raises that shard's own exception within
  ``FAIL_S``, no shard thread is left, and the next call predicts.
- ``spatial_sharded`` over 2 and 4 shards for ``test_torch_spatial.py``'s
  WT_PSE f32, joint and bf16 cases against the port's unsharded predict (OD
  at class ``conv``, 0 OD pixels thresholded the other way, OC at class
  ``conv``), the f32 ones also against JAX's ``make_predict_fn`` at that
  file's bounds; at H = 64 over 8 shards (4 of them idle) against JAX's own
  ``spatial_sharded`` on ``data_mesh(8)`` of the virtual devices;
  ``batch_sharded`` of a chunk of 5 over 2 shards.
- Training code refuses such a mesh.
"""

import concurrent.futures
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wt_pse_tpu.parallel.mesh import data_mesh as jax_data_mesh
from wt_pse_tpu.parallel.spatial import spatial_sharded as jax_spatial_sharded
from wt_pse_tpu.train.eval import make_predict_fn as jax_predict_fn
from wt_pse_tpu.train.eval import make_predict_fn_joint as jax_predict_fn_joint
from wt_pse_tpu_torch.config import JOINT, default_hparams
from wt_pse_tpu_torch.models import layers
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.parallel.collectives import (all_gather_rows, all_reduce_sum, barrier,
                                                   broadcast_floats, halo_rows)
from wt_pse_tpu_torch.parallel.dp import make_dp_fused
from wt_pse_tpu_torch.parallel.mesh import LocalMesh, data_mesh
from wt_pse_tpu_torch.parallel.spatial import (SHARD_THREAD, batch_sharded, nets_on,
                                               spatial_sharded)
from wt_pse_tpu_torch.train.eval import make_predict_fn_for
from wt_pse_tpu_torch.train.state import init_ensemble

import test_torch_spatial as S
from torch_port import CONV, assert_close, nchw, torch_single_thread  # noqa: F401

WAIT_S = 30.0  # a test that waits on shard threads fails after this
FAIL_S = 5.0   # a failing shard ends the call within this
# test_torch_spatial.py's cases of one process each: (algorithm, dtype, H = W, batch)
PREDICT_CASES = [(a, d, hw, b) for a, d, n, hw, b in S.CASES if n == 2]


def cpu_mesh(n: int) -> LocalMesh:
    return data_mesh(devices=["cpu"] * n)


def on_shards(mesh: LocalMesh, fn) -> list:
    """``fn(r, shard view)`` on every shard of ``mesh``, each in a thread of
    its own; the results by shard. Fails if they take over ``WAIT_S``."""
    pool = concurrent.futures.ThreadPoolExecutor(mesh.size)
    try:
        futures = [pool.submit(fn, r, mesh.shard(r)) for r in range(mesh.size)]
        done, _ = concurrent.futures.wait(futures, timeout=WAIT_S)
        if len(done) < len(futures):
            mesh.group.abort()
            pytest.fail(f"shard threads still running after {WAIT_S} s")
        return [f.result() for f in futures]
    finally:
        pool.shutdown(wait=True)


def shard_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith(SHARD_THREAD)]


def sharded(wrap, algorithm, dtype, n, image):
    """The outputs of ``wrap`` (spatial or batch) over ``n`` CPU shards, each
    with its own copy of the seeded nets, for ``image``; the wrapper is
    closed after."""
    nets = S._port_nets(algorithm, dtype)
    predict = wrap(lambda dev: make_predict_fn_for(algorithm, nets_on(nets, dev), device=dev),
                   cpu_mesh(n))
    try:
        return predict(image)
    finally:
        predict.close()


@pytest.fixture(scope="module")
def bases():
    """Each case's image, the port's unsharded predict and (f32) JAX's."""
    out = {}
    for algorithm, dtype, hw, b in PREDICT_CASES:
        img = S._image(b, hw)
        with torch.no_grad():
            base = make_predict_fn_for(algorithm, S._port_nets(algorithm, dtype),
                                       device="cpu")(nchw(img))
        jax_out = None
        if dtype is None:
            jnets = S._jax_nets(algorithm)
            predict = (jax_predict_fn_joint(jnets[0], jnets[2]) if algorithm == JOINT
                       else jax_predict_fn(*jnets))
            jax_out = predict(*S._jax_variables(algorithm), jnp.asarray(img))
        out[(algorithm, dtype)] = (img, base, jax_out)
    return out


def test_all_reduce_sums_in_rank_order_bitwise_on_every_shard():
    r = np.random.RandomState(3)
    xs = [torch.from_numpy((r.randn(4, 257) * 10.0 ** (3 * k)).astype(np.float32))
          for k in range(3)]
    inputs = [x.clone() for x in xs]
    got = on_shards(cpu_mesh(3), lambda k, view: all_reduce_sum(xs[k], view))
    want = (xs[0] + xs[1]) + xs[2]
    assert not torch.equal((xs[2] + xs[1]) + xs[0], want)  # the order shows
    for k, g in enumerate(got):
        assert torch.equal(g, want), k
        assert torch.equal(xs[k], inputs[k])


def test_all_gather_broadcast_and_barrier_over_the_local_group():
    def shard(k, view):
        rows = all_gather_rows(torch.full((2, 3), float(k)), view)
        barrier(view)
        return rows, broadcast_floats([10.0 + k, -1.5], view)

    for rows, floats in on_shards(cpu_mesh(3), shard):
        assert torch.equal(rows, torch.arange(3.0)[:, None, None].expand(3, 2, 3))
        assert floats == [10.0, -1.5]


def test_halo_rows_over_the_local_mesh():
    """The rows of ``test_torch_spatial.py::test_halo_rows_on_three_ranks``."""
    x = np.random.RandomState(2).rand(2, 3, 12, 5).astype(np.float32)
    slabs = [x[:, :, 4 * r:4 * r + 4] for r in range(3)]
    before = halo_rows.exchanges

    def shard(r, view):
        t = torch.from_numpy(slabs[r])
        out = {fill: halo_rows(t, view, fill).numpy() for fill in ("zero", "replicate")}
        out["bf16"] = halo_rows(t.to(torch.bfloat16), view, "zero")
        return out

    res = on_shards(cpu_mesh(3), shard)
    assert halo_rows.exchanges - before == 3
    for r, out in enumerate(res):
        for fill in ("zero", "replicate"):
            edge = (lambda row: np.zeros_like(row)) if fill == "zero" else (lambda row: row)
            above = x[:, :, 4 * r - 1:4 * r] if r > 0 else edge(slabs[r][:, :, :1])
            below = x[:, :, 4 * r + 4:4 * r + 5] if r < 2 else edge(slabs[r][:, :, -1:])
            np.testing.assert_array_equal(out[fill],
                                          np.concatenate([above, slabs[r], below], axis=2))
        assert out["bf16"].dtype == torch.bfloat16
        want = torch.from_numpy(out["zero"]).to(torch.bfloat16)
        assert torch.equal(out["bf16"], want)


def test_row_shard_holds_in_its_own_thread_only():
    mesh = cpu_mesh(2)
    entered, release = threading.Event(), threading.Event()

    def holder():
        with layers.row_shard(mesh.shard(0)):
            entered.set()
            release.wait(WAIT_S)
            return layers._ROW_MESH.get()

    def other():
        seen = [layers._ROW_MESH.get()]
        with layers.row_shard(mesh.shard(1)):
            seen.append(layers._ROW_MESH.get())
        return seen + [layers._ROW_MESH.get()]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        held = pool.submit(holder)
        assert entered.wait(WAIT_S)
        seen = pool.submit(other).result(timeout=WAIT_S)
        assert layers._ROW_MESH.get() is None
        release.set()
        assert held.result(timeout=WAIT_S).rank == 0
    assert seen[0] is None and seen[1].rank == 1 and seen[2] is None


def test_the_exchange_counter_adds_one_an_exchange_from_every_thread():
    """Two meshes of 6 shards exchange at once (more threads than this
    machine's cores, the interpreter switching threads every microsecond):
    the counter adds exactly one an exchange of each mesh."""
    x = torch.zeros(1, 1, 2, 3)
    meshes = [cpu_mesh(6), cpu_mesh(6)]
    switch = sys.getswitchinterval()
    before = halo_rows.exchanges
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(on_shards, m, lambda r, view: [
                halo_rows(x, view, "zero") for _ in range(100)]) for m in meshes]
            for run in runs:
                run.result(timeout=2 * WAIT_S)
    finally:
        sys.setswitchinterval(switch)
    assert halo_rows.exchanges - before == 200


class ShardFailure(RuntimeError):
    pass


def test_a_failing_shard_raises_its_own_exception_and_leaves_no_thread():
    """Shard 1 of 3 fails at its fifth 3x3 conv, after four exchanges, while
    the others wait at their fifth: the call raises shard 1's exception
    within ``FAIL_S`` with no shard thread left, and the next call
    predicts."""
    nets = S._port_nets("WT_PSE", None)
    fail = {"armed": True}
    made = []

    def fifth_conv(module, args):
        if fail["armed"]:
            raise ShardFailure("shard 1 fails")

    def predict_for(dev):
        copies = nets_on(nets, dev)
        if len(made) == 1:
            convs = [m for m in copies[1].modules()
                     if isinstance(m, layers.Conv2d) and m.kernel_size == (3, 3)]
            convs[4].register_forward_pre_hook(fifth_conv)
        made.append(dev)
        return make_predict_fn_for("WT_PSE", copies, device=dev)

    predict = spatial_sharded(predict_for, cpu_mesh(3))
    img = S._image(1, 48)
    others = set(shard_threads())  # other wrappers' pools, not yet collected
    t0 = time.perf_counter()
    with pytest.raises(ShardFailure, match="shard 1 fails"):
        predict(nchw(img))
    assert time.perf_counter() - t0 < FAIL_S
    assert set(shard_threads()) <= others
    fail["armed"] = False
    od, _ = predict(nchw(img))
    predict.close()
    assert set(shard_threads()) <= others
    base_od, _ = make_predict_fn_for("WT_PSE", nets, device="cpu")(nchw(img))
    assert_close(od.numpy(), base_od.numpy(), CONV, "od after the failure")


@functools.lru_cache(maxsize=None)
def spatial_run(case, shards):
    """A case's sharded predict over ``shards`` CPU shards: its outputs and
    the halo exchanges it made."""
    algorithm, dtype, hw, b = case
    before = halo_rows.exchanges
    outs = sharded(spatial_sharded, algorithm, dtype, shards, nchw(S._image(b, hw)))
    return outs, halo_rows.exchanges - before


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", PREDICT_CASES, ids=lambda c: f"{c[0][:6]}-{c[1] or 'f32'}")
def test_spatial_sharded_matches_the_unsharded_predict(bases, case, shards):
    algorithm, dtype, hw, b = case
    _, (base_od, base_oc), _ = bases[(algorithm, dtype)]
    (od, oc), exchanges = spatial_run(case, shards)
    assert exchanges == S.EXCHANGES[algorithm]
    held = S._hold(od, oc, base_od, base_oc, f"{shards} shards", 0)
    assert 0.02 < held["roi_share"] < 0.9, held


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", [c for c in PREDICT_CASES if c[1] is None],
                         ids=lambda c: c[0][:6])
def test_spatial_sharded_matches_jax(bases, case, shards):
    algorithm = case[0]
    _, _, (want_od, want_oc) = bases[(algorithm, None)]
    (od, oc), _ = spatial_run(case, shards)
    S._hold(od, oc, want_od, want_oc, "against JAX", 1e-4)


def test_spatial_sharded_over_8_shards_matches_jax_spatial_sharded():
    """JAX's own arrangement (``tests/test_spatial.py``): H = 64 over 8
    devices, 8 rows each under GSPMD; here 4 shards of 16 rows, 4 idle."""
    img = S._image(1, 64, seed=6)
    jnets = S._jax_nets("WT_PSE")
    want_od, want_oc = jax_spatial_sharded(jax_predict_fn(*jnets), jax_data_mesh(8))(
        *S._jax_variables("WT_PSE"), jnp.asarray(img))
    before = halo_rows.exchanges
    od, oc = sharded(spatial_sharded, "WT_PSE", None, 8, nchw(img))
    assert halo_rows.exchanges - before == S.EXCHANGES["WT_PSE"]
    S._hold(od, oc, want_od, want_oc, "against JAX's spatial_sharded", 1e-4)


def test_batch_sharded_matches_the_unsharded_predict():
    img = nchw(S._image(5, 32, seed=7))
    base = make_predict_fn_for("WT_PSE", S._port_nets("WT_PSE", None), device="cpu")(img)
    got = sharded(batch_sharded, "WT_PSE", None, 2, img)
    for g, w, name in zip(got, base, ("od", "oc")):
        assert g.shape == w.shape
        assert_close(g.numpy(), w.numpy(), CONV, name)


def test_data_mesh_of_devices_keeps_their_order_cut_to_n():
    mesh = data_mesh(2, devices=["cpu", "meta", "cpu"])
    assert isinstance(mesh, LocalMesh) and mesh.size == 2
    assert mesh.devices == [torch.device("cpu"), torch.device("meta")]
    view = mesh.shard(1)
    assert (view.rank, view.size, view.device, view.group) == (1, 2, torch.device("meta"),
                                                              mesh.group)
    assert mesh.shard(0, 1).size == 1 and mesh.shard(0, 1).group is mesh.group.sub(1)
    with pytest.raises(ValueError, match="needs a device"):
        data_mesh(devices=[])


def test_training_refuses_a_mesh_of_one_process():
    mesh = cpu_mesh(2)
    hp = default_hparams("WT_PSE")
    with pytest.raises(ValueError, match="item 24"):
        init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh), device="cpu")
    with pytest.raises(ValueError, match="item 24"):
        init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh.shard(0)), device="cpu")
    nets = [ns.net for ns in init_ensemble(ModelConfig.from_hparams(hp), device="cpu")
            .net_states()]
    with pytest.raises(ValueError, match="item 24"):
        make_dp_fused(nets, hp, mesh.shard(0), 3, 2, device="cpu")
