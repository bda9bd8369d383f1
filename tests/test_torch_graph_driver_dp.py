"""The graph driver under data parallelism (``train/graph.py`` with
``parallel/dp.py::make_dp_fused``) on 2 gloo ranks (``tests/torch_dp_worker.py``),
on the CPU, at 32x32 with batch 6 = 3 domains x 2 (one item a domain a rank,
3 steps an epoch), port against port:

- two epochs through :meth:`GraphedStep.body` with the DP step and the
  rank-seeded sampler equal the DP eager loop (``Trainer.train``) bitwise on
  each rank: per-step metrics, weights, BatchNorm statistics, Adam state and
  step count; and the two ranks' states are bitwise equal;
- :meth:`GraphedStep.prepare`, the capture's preparation (a warm-up on a copy
  whose collectives are real, then ``init_adam_state``), leaves each rank's
  nets, step count and generator as they were and creates the same Adam
  state on both ranks, for the parameters the loop's steps give state;
- ``scan_epochs`` under gloo: ``True`` raises ``ValueError`` naming gloo,
  ``None`` and ``False`` take the loop.

A CPU has no CUDA graph and gloo's collectives cannot be captured, so the
capture itself and NCCL's replay are held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 10), at world 1: NCCL refuses two ranks on one card.
The body against the JAX package: ``test_torch_graph_driver_dp_jax.py``.
"""

import numpy as np
import pytest

from wt_pse_tpu_torch.data.fundus import FundusDomain

from torch_dp_worker import graph_driver_dp_rank, run
from torch_port import torch_single_thread  # noqa: F401

HW, SEED = 32, 3


def _domains(n=6):
    r = np.random.RandomState(0)
    yy, xx = np.mgrid[0:HW, 0:HW]
    gray = np.full((HW, HW), 255, np.uint8)
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 90] = 128
    gray[(yy - 15) ** 2 + (xx - 17) ** 2 < 25] = 0
    return [FundusDomain(images=r.randint(0, 256, (n, HW, HW, 3)).astype(np.uint8),
                         labels=np.stack([gray] * n)) for _ in range(3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_dp")
    # 15 steps a rank (about 35 s alone): a deadline above the other files'
    # minute, for a loaded machine
    return run(graph_driver_dp_rank, tmp, _domains(), str(tmp), SEED, timeout_s=150.0)


def test_dp_body_equals_the_dp_loop_bitwise_and_ranks_agree(ranks):
    for res in ranks:
        assert res["iter_per_epoch"] == 3 and len(res["loop"]) == len(res["body"]) == 2
        for loop, body in zip(res["loop"], res["body"]):
            assert sorted(loop) == sorted(body) and len(body) == 19
            for k, v in loop.items():
                assert v.shape == (3,) and np.array_equal(v, body[k]), k
        assert res["digests"][0] == res["digests"][1]
        assert res["steps"] == [6, 6]
    assert ranks[0]["digests"] == ranks[1]["digests"]
    for k, v in ranks[0]["loop"][0].items():  # the metrics are meaned over the ranks
        assert np.array_equal(v, ranks[1]["loop"][0][k]), k


def test_prepare_leaves_each_rank_as_it_was_and_makes_the_same_adam_state(ranks):
    for res in ranks:
        p = res["prepare"]
        assert p["nets_unchanged"] and p["generator_unchanged"] and p["step_unchanged"]
        assert p["with_state_before"] == [[]] * 4
        assert p["with_state"] == p["loop_with_state"]
        assert all(p["with_state"])
    assert ranks[0]["prepare"]["digest"] == ranks[1]["prepare"]["digest"]


def test_scan_epochs_resolution_under_gloo(ranks):
    for rank, res in enumerate(ranks):
        r = res["resolution"]
        assert "gloo" in r["true"] and "cannot be captured" in r["true"], r["true"]
        assert r["none"]["scan_epochs"] is False and not r["none"]["graph"]
        assert r["false"]["scan_epochs"] is False and not r["false"]["graph"]
        if rank == 0:
            assert r["none"]["driver"] == r["false"]["driver"] == "eager"
