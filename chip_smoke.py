#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wt_pse_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase falls back to the CPU:

1. build the hand-written kernels from ``wt_pse_tpu_torch/csrc`` (nvcc, sm_90a:
   the covariance, the BatchNorm and the upsample libraries)
   and, at the same time, the native eval operators (``csrc/evalops.cpp``,
   g++), and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, forward and
   backward, for an f32 and a bf16 z, at shapes that reach every variant: the
   main-path shape (9, 16, 256, 256), ragged HW (HW % 8 == 4 for bf16), other
   C, and a z whose storage starts 4 (f32) or 2 and 8 (bf16) bytes past a
   16-byte boundary; for bf16 also the tensor-core kernels' edges (a tail
   inside a tile, B = 1 and B = 32, large and small values); and check that
   two calls are bitwise equal. The Gram is
   held at ``f32_reduce`` for either type, a bf16 dz within 1 bf16 ulp of its
   plain version (plus the f32 kernel's ``f32_reduce`` allowance for the
   summation order, which decides only where a value's products cancel);
3. hold one small step and a predict on the card against the same on the CPU
   (the port's plain path, which the CPU tests hold against the JAX package);
4. the main path: full-width training steps (256x256, batch 9 = 3 domains x 3,
   base width 16, f32, TF32 off) from seeded weights on a synthetic batch, with
   the launch counts set to 0 just before and read just after (8 of each
   covariance kernel, 198 BatchNorm forwards and 148 backwards, 32 upsample
   forwards and 24
   upsample backwards a step); two more steady
   steps traced with ``torch.profiler`` (device time by kernel, the card's busy
   share of the step: the breakdown in PERF.md; the hand-written kernels'
   device time a call); both kernels held against their plain versions on the
   main path's own DeepWT maps (the OD net's, since the OC ROI is empty at
   initialisation); then the two-stage predict;
5. time each kernel, for an f32 and a bf16 z, beside its bound, its plain
   version and one PyTorch call that computes the same function (a yardstick
   the port never calls: ``torch.bmm``, for bf16 with an f32 result where this
   torch takes ``out_dtype``), in turns in one loop, so that all three are
   timed on one card at one time: after a write that fills the L2 with dirty
   lines (the record), then after a read (a second reading); and the host
   time of a wrapper call;
6. the f32 trainer: ``Trainer`` at full width (256x256,
   batch 9 = 3 domains x 3 of 12 images each, f32) on numpy-made pools (no
   PIL, no YAML, no file read), under its default driver on the card, the
   graph (the sample + step captured once as a CUDA graph and replayed once a
   step; its capture time and memory pool), trains 5 epochs of 4 steps, with
   the launch counts set to 0 just before and read just after (8 of each
   covariance kernel, 198 BatchNorm forwards and 148 backwards a replayed
   step),
   and validates after epochs 3 and 4 on 8 images whose labels are at two
   native resolutions (512x512 and 640x640). It checks finite losses, the
   log rows, the 7 finite validation metrics, best.json and a checkpoint; a
   checkpoint of the trained nets reloaded into fresh nets (strictly, and by
   the reference's filtered partial load: 336/158/336/158 leaves) must
   predict bitwise equal on the card; a resume from the newest checkpoint
   must start at its epoch with the best objective restored (into the
   capturable Adams, in place) and train one more epoch, which is traced
   with ``torch.profiler`` (the card's busy share of the epoch; the device
   time of sampling and augmentation only under the loop, whose range the
   graph does not replay); the same checkpoint resumed under the loop
   (``scan_epochs=False``) must hold the same step count, weights and Adam
   state bitwise. It prints
   the epoch times, steps a second, each validation's time split into the
   predict on the card, the host upsample and the host scoring, the peak
   device memory, and whether PIL and PyYAML import on this machine; the
   validations must have scored on the native operators;
7. the evaluation path, from phase 6's trained nets and newest checkpoint,
   each part with the launch counts set to 0 just before and read just after
   (none launches a covariance kernel but the training epoch of (c)):
   (a) the native operators against the scipy path on a 640x640 mask (LCC +
   fill bitwise, surface distances within 1e-5) and their times; (b)
   ``label_components``, ``largest_component`` and ``fill_holes`` on the card
   bitwise equal to the CPU on the masks thresholded once from the trained
   logits of the 8 validation images (and 8 seeded masks, one a path longer
   than H + W), and ``device_metrics`` within ``f32_reduce``; (c) a
   ``Trainer(fast_validation=True, train_visualization=True,
   train_viz_interval=2)`` resumed from the checkpoint trains one epoch and
   validates on the card; its validation time beside a host validation of
   the same nets and images, both objectives, and the montage PNGs; (d) the
   eval CLI (``--save-images``, native scoring) on a synthetic test split
   written with PIL at native 512x512 and 640x640: its metrics equal
   ``evaluate_domain`` on the reloaded nets, ``resize='device'`` is within
   ``f32_reduce`` of the f64 host upsample, 8 overlays and 8 originals; (e)
   ``load_predictor`` on 8 uint8 images at 412x412: masks (8, 412, 412),
   finite logits, a steady call timed;
8. the bf16 main path (``compute_dtype='bfloat16'``): 8 full-width bf16
   steps from seeded weights on one fixed batch, with the launch counts set
   to 0 just before and read just after (8 of each bf16 covariance kernel,
   148 bf16 BatchNorm backwards and no forward of the port's, 32 bf16
   upsample forwards and 24 backwards a step, no f32 launch; the Trainer's run below likewise but the upsample's,
   which its validations launch too), finite losses and a loss that falls over the 8 steps, f32
   parameters and BatchNorm statistics after them, the steady bf16 step time
   beside phase 4's f32 step of the same call, a ``torch.profiler`` breakdown
   of two more steps by layer (convolutions, BatchNorm, casts, the card's busy
   share); both bf16 kernels held against their plain versions on the main
   path's own bf16 DeepWT maps; a ``Trainer`` in bf16 for 3 epochs and one validation (finite
   metrics, ``run_meta.json`` records the dtype); a small bf16 step and predict
   on the card against the CPU at class bf16; the peak device memory;
9. the joint variant (``Unet_nips2023_joint_shape_regularization``): a
   full-width ``Trainer`` at its default hparams (whitening off) for 3 epochs
   and one validation, with no covariance launch; one epoch with
   ``whitening=True`` (4 launches of each kernel a step); a small joint step
   and predict (whitening on, bf16) against the CPU; the eval CLI on the
   joint checkpoint (its metrics equal ``evaluate_domain`` on the reloaded
   nets) and ``load_predictor``; epoch, validation and CLI times;
10. data parallelism and the sweep (``parallel/``), each part in processes of
   its own that this script starts and stops: (a) ``Trainer(dp=True)`` at
   full width in one spawned rank of a world-1 NCCL process group, in f32 and
   in bf16, under both drivers from one seed: the graph (the default under
   NCCL: the DP sample + step, its collectives included, captured once and
   replayed a step) and the loop (``scan_epochs=False``); one epoch of both
   step by step, every replayed batch bitwise equal to the loop's and the
   first step's metrics within the scan-vs-loop bounds (in bf16 the
   ``POST_UPDATE`` metrics at class bf16, as phase 12); 2 epochs of 4 steps
   of each through ``train()`` with the launch counts set to 0 just before
   and read just after (8 of each kernel of the dtype a step, and 8 a step
   in the graph beside 32 upsample forwards and 24 backwards); one more epoch of each traced (the card's busy share), the
   epoch and host enqueue times, the capture time and the graph's pool;
   ``run_meta.json`` naming each driver; in f32 one step's metrics within
   rtol 2e-3 of a ``dp=False`` trainer's on the same state and draws and a
   batch-sharded validation of the graph's nets (finite). At world 1 the MMD
   gather does not run (it gathers only over more than one rank). After
   phase 12 the DP graph's epoch and busy share are printed beside the
   single-device graph's; (b) two
   gloo ranks sharing the one card (NCCL refuses two ranks on one card): one
   DP step at 256x256, global batch 12 = 3 x 4, shape prior and whitening on,
   the draws injected, in f32 and in bf16, against rank 0's single-process
   step on the global batch (``tests/test_parallel.py:227-236``'s bounds;
   bf16 at class bf16), 8 launches of each kernel of the dtype a step on each
   rank, every rank's state bitwise equal, and the host-staged gloo step time;
   and the Trainer's driver over gloo: ``scan_epochs=True`` raises
   ``ValueError`` naming gloo, ``None`` trains an epoch under the loop;
   (c) ``python -m wt_pse_tpu_torch.cli.sweep`` with 2 jobs (target 4, OD
   and OC) on a synthetic on-disk split of 4 domains written with PIL, to one
   validation each: exit 0, ``sweep_results.json`` with both keys and the
   summary. A rank on any card but the first cannot run here (one card), so
   ``torch.cuda.set_device`` of another rank is not exercised;
11. the rest of the JAX package's surface, each sharded part in processes of
   its own that this script starts and stops: (a) ``spatial_sharded``, the
   two-stage predict of WT_PSE at full width in f32 on a batch of 2 at
   1024x1024 with the image's rows split over 2, then 4, gloo ranks sharing
   the card (the halo exchanges by hand, over all-reduce), against the
   single-process predict on the card (and that one against the CPU): OD
   logits at class conv, the OD pixels on the other side of the 0.75
   threshold (at most 1 in 10^4), OC at class conv farther than the OC
   stage's reach (170 pixels) from any of them, every rank holding the same outputs,
   the halo exchanges of a predict and no covariance launch, and the times
   of both; (b) every op of ``data/augment_extras.py`` at 256x256 on the card
   against the CPU with the same injected draws (images at ``f32_reduce``,
   masks exact, the floored gamma curve within 1 at no more than 1 in 10^3
   pixels; the elastic transform's and the rotation's images at class conv,
   the elastic transform's blurred field at ``f32_reduce``) and each op's
   median time; (c) ``InstanceWhitening`` on the card
   against the CPU at ``f32_reduce``;
12. the one-program epoch (``train/graph.py``), for WT_PSE f32, WT_PSE bf16
   and the joint variant at full width on phase 6's pools: a graphed
   ``Trainer`` (the default) and an eager-loop one (``scan_epochs=False``)
   from one seed, with ``run_meta.json`` naming each driver; one epoch of
   both, step by step, every replayed step's batch bitwise equal to the
   loop's and the first step's metrics within the JAX package's
   scan-vs-loop bounds (rtol 1e-4, atol 1e-6; in bf16 the two metrics read
   through a teacher after its update, ``POST_UPDATE``, at class bf16);
   3 epochs of each through ``train()`` with the launch counts set to 0
   just before and read just after (8 of each kernel of the dtype a
   replayed step; none for the joint variant at its default hparams); one
   more epoch of each traced (the card's busy share), the epoch and host
   enqueue times, the capture time, the graph's memory pool and the peak
   memory. For f32 and bf16 also one step graphed against the same step run
   eagerly with the same capturable Adam (fixed batch, injected draws):
   metrics within the same bounds, and the largest parameter difference
   beside the one between two eager runs;
13. the training CLI as a user starts it, without torchrun, each run a
   process of its own (``python -m wt_pse_tpu_torch.cli.train`` run by
   ``runpy``, as ``-m`` runs it, with a probe in whichever process trains:
   launch counts set to 0 just before ``train()`` and read just after, the
   state's digest, the epoch times), on phase 6's pools written as a Fundus
   tree with PIL (256x256, f32, 3 train domains of 12 images, phase 7's
   test split): (a) on every machine, with only the first card visible:
   ``--dp`` starts one NCCL rank, which holds both kernels against their
   plain versions on its card and trains the DP graph at world 1
   (``run_meta`` dp enabled, ``n_devices`` 1, ``n_processes`` 1; 8 launches
   of each kernel a step); auto trains in the CLI's own process with data
   parallelism off; a rank made to fail in its second epoch ends the CLI
   non-zero within ``CLI_FAIL_S``, its error naming the rank; (b) where two
   or more cards are visible: auto at batch 9 starts 3 ranks, at batch 12
   on 4 cards 4 (to a validation and its checkpoint), each rank on its own
   card holding both kernels against their plain versions there, their final
   states bitwise equal; that checkpoint resumed with ``--nan-recovery``,
   one epoch made non-finite, rolled back and trained to its last epoch, the
   ranks again equal; the epoch time and images a second beside phase 6's
   one-card epoch. On one card (b) prints that it did not run;
14. the sharded predicts across the cards of one process
   (``data_mesh(devices=...)``, one thread a shard, the halo exchanges an
   all-reduce by hand between barriers), on phase 11 (a)'s nets and image
   (WT_PSE at full width, f32, batch 2 at 1024x1024): (a) on every machine,
   ``spatial_sharded`` over ``[card 0]`` and ``[card 0, card 0]``, at H =
   1040 (65 row blocks, which H % (16 N) refused) over 2 and 4 shards of the
   card, and ``batch_sharded`` of 5 images at 512x512 over 2, each against
   the single-process predict in this process at phase 11 (a)'s bounds, the
   outputs on the mesh's first card, the halo exchanges of a predict equal
   to phase 11 (a)'s, no covariance launch, the median times, no shard
   thread left once each wrapper is closed; a shard made to fail ends the
   call with its own exception within ``SHARD_FAIL_S`` and leaves no
   thread; (b) where two
   or more cards are visible, the same over every card, with its times
   against one card and phase 11 (a)'s gloo ranks. On one card (b) prints
   that it did not run.

15. the BatchNorm + ReLU kernels (``ops/batchnorm_cuda.py``) at every
   training-mode BatchNorm's shape of the default step (N = 9; 9 (C, H, W)),
   in f32 and bf16, with and without the ReLU, through ``BatchNormReLU`` (the
   forward kernels in f32, the library's forward, ATen's, in bf16; then the
   backward kernels), held by ``check_batchnorm``: in f32 the forward's y
   within 1 f32 ulp of its plain version, whose saved and running
   statistics and ``num_batches_tracked`` it equals bit for bit, and y, the
   saved mean and invstd and the running statistics within f32_reduce of an
   f64 truth; in bf16 the forward bit for bit the library's; dx, dweight and
   dbias within their tolerance (dx at f32_reduce, or 1 bf16 ulp +
   f32_reduce; dweight and dbias at f32_reduce of the sum of their terms'
   magnitudes) of an f64 truth with the kernels' ReLU mask and of their plain
   version; against the library's backward through its own forward +
   ``F.relu`` (autograd) within that tolerance plus the library's own
   distance from its f64 truth; the recomputed mask's flips against the
   path's forward counted: none in f32, in bf16 at most 1e-5 of the elements
   and each within 8 f32 ulps of 0; then, at (9, 16, 256, 256), (9, 32, 128,
   128) and (9, 256, 16, 16) with the ReLU, each kernel pair timed by CUDA
   events after a 256 MB write (dirty L2, as phase 5) and about 1 ms of
   sleep on the card (so that the host's enqueue is not timed), in turns with
   its plain version and the library's call (the backward's: autograd
   through the library's forward; the f32 forward's: cuDNN's forward and the
   ReLU in place), a yardstick the port never calls; beside each, the
   pass bound (the forward's 3: x read twice, y written; the backward's 5: x
   and dy read twice, dx written) and the strict one (each byte once) at
   3.35 TB/s.
16. the 2x bilinear upsample's kernels (``ops/upsample_cuda.py``) at the
   decoders' four shapes (batch 9; ``UP_SHAPES``), in f32 and bf16: the
   forward held bit for bit to the ``F.interpolate`` calls it replaces (two
   passes in bf16), the backward bit for bit to its plain version and within
   f32_reduce (bf16: half an ulp) of an f64 ``F.interpolate`` backward; then
   each timed in turns with ATen's forward and backward kernels (in bf16 each
   pass alone, and both) after a 256 MB write and about 1 ms of sleep, beside
   the bound: x read and y written once (forward), dy read and dx written
   once (backward), at 3.35 TB/s.

``python3 chip_smoke.py --phases N ...`` runs only those phases (and the
ones they read); with no arguments it runs them all.

The card's name and power limit follow the build line. With phase 15 a JSON
``batchnorm_kernels`` record of its timed rows comes before the ``kernels``
line (``launches``: the BatchNorm kernels of the row's name and type counted
in the trainer runs of phases 6 and 8, ``steps`` their steps); with phase 16 an
``upsample_kernels`` record of its timed rows before that.
The line before the last is a JSON ``kernels`` record of four rows, the f32 and the bf16 variant
of each kernel (``launches`` counted in the trainer runs of phases 6 and 8);
the last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or the
JAX package.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
F32_REDUCE_RTOL = 2e-5     # tolerance class f32_reduce (tests/test_goldens.py:49)
CONV = (5e-4, 1e-5)        # tolerance class conv
STEPS = 4
EPOCHS = 5  # phase 6: 4 steps an epoch, validation after epochs 3 and 4
MAIN_SHAPE = (9, 16, 256, 256)
# (shape, storage offset in floats): HW % 4 == 0 with an aligned base (the
# 16-byte variants, at C = 16 and at another C); ragged HW and an unaligned
# base (the 4-byte variants)
CHECK_CASES = ((MAIN_SHAPE, 0), ((9, 16, 64, 64), 0), ((2, 32, 16, 16), 0),
               ((9, 16, 250, 250), 0), ((3, 16, 47, 47), 0), ((2, 32, 33, 31), 0),
               ((1, 5, 1, 3), 0), (MAIN_SHAPE, 1))
# bf16 (offset in bf16 values, scale of z): C = 16 with HW % 8 == 0 and an
# aligned base (the tensor-core kernels; a base 16 bytes in too), with a tail
# inside a tile (24 x 24; 40 x 37, HW % 16 == 8), B = 1 and B = 32 (the Gram's
# chunk plan and scratch), values of large and small magnitude; C != 16 with
# HW % 8 == 0 (the 16-byte FFMA variants); HW % 8 == 4, an odd HW, and bases
# 2 and 8 bytes past a 16-byte boundary (the narrow ones)
BF16_CHECK_CASES = ((MAIN_SHAPE, 0, 1.0), ((9, 16, 64, 64), 0, 1.0), ((9, 16, 24, 24), 0, 1.0),
                    ((2, 16, 40, 37), 0, 1.0), ((1, 16, 256, 256), 0, 1.0),
                    ((32, 16, 64, 64), 0, 1.0), ((9, 16, 64, 64), 0, 3e4),
                    ((9, 16, 64, 64), 0, 1e-3), ((2, 32, 16, 16), 0, 1.0),
                    ((9, 16, 250, 250), 0, 1.0), ((3, 16, 47, 47), 0, 1.0),
                    ((2, 32, 33, 31), 0, 1.0), ((1, 5, 1, 3), 0, 1.0), (MAIN_SHAPE, 1, 1.0),
                    (MAIN_SHAPE, 4, 1.0), (MAIN_SHAPE, 8, 1.0))
# the bf16 rows' times with the FFMA kernels that the tensor-core ones
# replaced (this measurement, NVIDIA H100 80GB HBM3 at 700 W): their earlier times
EARLIER_MS = {"covariance_gram_bf16": 0.0208, "covariance_dz_bf16": 0.0272}
BF16_TOL = (2e-2, 1e-3)    # tolerance class bf16 (card against CPU, both in bf16)
STEPS_BF16 = 8             # phase 8: full-width bf16 steps on one fixed batch
JOINT = "Unet_nips2023_joint_shape_regularization"
DP_EPOCHS = 2              # phase 10 (a): 2 epochs of 4 steps a driver, then one validation
DP_RANK_TIMEOUT_S = 420.0  # a phase 10 rank that hangs fails the run
DP_STEP_HW = 256           # phase 10 (b): the image size of the 2-rank step
SPATIAL_HW = 1024          # phase 11 (a): a megapixel image, batch 2, rows split over ranks
SPATIAL_WORLDS = (2, 4)
# the seeded OD head's logits are scaled by this, so that few lie near the
# 0.75 threshold, then shifted so that their median lies on it (half the image
# is ROI): the draws behind a seed differ between torch versions
SPATIAL_OD_GAIN = 20.0
# the two-stage predict's OC logit at a pixel reads the ROI within this many
# pixels (the receptive field of a 5-level U-Net of 3x3 convs, 167, or of its
# student's DeepWT + trunk, 168, with a margin): an OD pixel thresholded the
# other way changes the OC logits this far around it
OC_REACH = 170
EXTRAS_HW = 256            # phase 11 (b): the transform library's image size
GRAPH_EPOCHS = 3           # phase 12: epochs of each driver a variant
CLI_EPOCHS = 2             # phase 13: epochs of a CLI run that writes no checkpoint
CLI_FAIL_S = 15.0          # phase 13 (a): a failing rank ends the CLI within this
CLI_TIMEOUT_S = 300.0      # phase 13: a CLI run that outlasts this fails the script
SHARDED_H = 1040           # phase 14: 65 row blocks, which H % (16 N) refused for every N > 1
SHARDED_BATCH = (5, 512)   # phase 14: batch_sharded's chunk (images, H = W)
SHARD_FAIL_S = 10.0        # phase 14 (a): a failing shard ends the call within this
# the JAX package's scan-vs-loop bounds of one step's metrics
# (tests/test_trainer_e2e.py:137-138)
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-6
# the metrics a step reads through a teacher after that teacher's Adam update.
# An update that differs by an ulp (the capturable Adam's f32 bias
# correction), or by 2 lr where a gradient at noise flips the sign of Adam's
# first step, moves the bf16 teacher's roundings.
# In bf16 they are held at class bf16; every other metric, and all in f32, at
# the scan-vs-loop bounds
POST_UPDATE = ("loss_kd", "loss_kd_oc")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def cov_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max error relative to sqrt(cov_cc * cov_dd))."""
    d = torch.sqrt(torch.diagonal(want, dim1=1, dim2=2).abs())
    scale = d[:, :, None] * d[:, None, :]
    err = (got - want).abs()
    return float(err.max()), float((err / scale).max())


def bf16_ulp_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want| / (ulp + a)``: one bf16 ulp of the larger
    magnitude plus ``a = f32_reduce * max|want|``, the f32 dz kernel's
    allowance for its summation order. Both sides round an f32 sum once; the
    allowance decides only where a value's 16 products cancel to the f32
    noise floor, where another order rounds the small result otherwise."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(((got - want).abs() / (ulp + F32_REDUCE_RTOL * want.abs().max())).max())


def check_pair(cc, z: torch.Tensor, g: torch.Tensor, what: str) -> dict:
    """Both kernels against their plain versions on (z, g), and a second call of
    each bitwise equal to the first. The Gram is held at f32_reduce; dz at
    f32_reduce for an f32 z, within 1 bf16 ulp (``bf16_ulp_error``) for a bf16
    one. Returns the max abs errors."""
    got_f, want_f = cc.covariance_forward(z), cc.covariance_forward_plain(z)
    got_b, want_b = cc.covariance_backward(z, g), cc.covariance_backward_plain(z, g)
    again_f, again_b = cc.covariance_forward(z), cc.covariance_backward(z, g)
    torch.cuda.synchronize()
    f_abs, f_rel = cov_error(got_f, want_f)
    b_abs = float((got_b.float() - want_b.float()).abs().max())
    repeat = torch.equal(got_f, again_f) and torch.equal(got_b, again_b)
    if z.dtype == torch.bfloat16:
        b_err = bf16_ulp_error(got_b, want_b)
        exact = float((got_b == want_b).float().mean())
        dz_ok = b_err <= 1.0 and got_b.dtype == torch.bfloat16
        dz_msg = (f"dz max_abs {b_abs:.3e}, {b_err:.3f} of (1 bf16 ulp + f32_reduce), "
                  f"{exact:.4%} bitwise equal")
    else:
        b_err = b_abs / float(want_b.abs().max())
        dz_ok = b_err <= F32_REDUCE_RTOL
        dz_msg = f"dz max_abs {b_abs:.3e} rel-to-max {b_err:.3e}"
    log(f"kernel check {str(z.dtype)[6:]} {what}: gram max_abs {f_abs:.3e} scaled "
        f"{f_rel:.3e} (f32_reduce {F32_REDUCE_RTOL}); {dz_msg}; second call bitwise "
        f"equal: {repeat}")
    if not (f_rel <= F32_REDUCE_RTOL and dz_ok and got_f.dtype == torch.float32):
        raise SystemExit(f"kernel disagrees with its plain version at {what}")
    if not repeat:
        raise SystemExit(f"a second kernel call differs from the first at {what}")
    return {"gram": f_abs, "dz": b_abs}


def check_kernels(cc, dev) -> dict:
    """Phase 2. Returns the max abs errors at the main-path shape, by kernel
    row name."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for dtype, cases, suffix in ((torch.float32, [c + (1.0,) for c in CHECK_CASES], ""),
                                 (torch.bfloat16, BF16_CHECK_CASES, "_bf16")):
        for shape, offset, scale in cases:
            n = math.prod(shape)
            z = (torch.randn(n + offset, device=dev, generator=gen) * scale).to(dtype)
            z = z[offset:].view(shape)
            g = torch.randn(shape[0], shape[1], shape[1], device=dev, generator=gen)
            got = check_pair(cc, z, g, f"{shape} storage offset {offset}" +
                             (f" scale {scale:g}" if scale != 1.0 else ""))
            if (shape, offset) == (MAIN_SHAPE, 0):
                errs.update({f"covariance_{k}{suffix}": v for k, v in got.items()})
    return errs


BN_LAUNCHES_A_STEP = 148  # training-mode BatchNorm backwards in a default WT_PSE step
BN_FORWARDS_A_STEP = 198  # ... and forwards (the teachers' no-grad ones too): f32 alone


UP_FORWARDS_A_STEP = 32   # upsample forwards in a default WT_PSE step (8 U-Nets x 4)
UP_BACKWARDS_A_STEP = 24  # ... and backwards (the 2 teachers' U-Nets run without grad)


def zero_counts(cc) -> None:
    """Sets every kernel's launch count to 0."""
    from wt_pse_tpu_torch.ops.batchnorm_cuda import batch_norm_backward, batch_norm_forward
    from wt_pse_tpu_torch.ops.upsample_cuda import upsample2x_backward, upsample2x_forward

    for fn in (cc.covariance_forward, cc.covariance_backward, batch_norm_forward,
               batch_norm_backward, upsample2x_forward, upsample2x_backward):
        fn.launches = fn.launches_bf16 = 0


def expect_up_counts(steps: int, bf16: bool, what: str) -> None:
    """The upsample kernels' launches since ``zero_counts``: ``steps`` default
    steps' of the row's type, none of the other."""
    from wt_pse_tpu_torch.ops.upsample_cuda import upsample2x_backward, upsample2x_forward

    got = {f"{fn.__name__}.{a}": getattr(fn, a) for fn in (upsample2x_forward,
                                                           upsample2x_backward)
           for a in ("launches", "launches_bf16")}
    key, other = ("launches_bf16", "launches") if bf16 else ("launches", "launches_bf16")
    want = {f"upsample2x_forward.{key}": UP_FORWARDS_A_STEP * steps,
            f"upsample2x_backward.{key}": UP_BACKWARDS_A_STEP * steps,
            f"upsample2x_forward.{other}": 0, f"upsample2x_backward.{other}": 0}
    if got != want:
        raise SystemExit(f"{what}: expected upsample launches {want}, got {got}")


def read_bn_counts() -> dict:
    """The BatchNorm kernels' launch counts by row name."""
    from wt_pse_tpu_torch.ops.batchnorm_cuda import batch_norm_backward, batch_norm_forward

    return {"bn_forward": batch_norm_forward.launches,
            "bn_forward_bf16": batch_norm_forward.launches_bf16,
            "bn_backward": batch_norm_backward.launches,
            "bn_backward_bf16": batch_norm_backward.launches_bf16}


def expect_bn_counts(got: dict, steps: int, bf16: bool, what: str) -> None:
    """``steps`` default steps' BatchNorm launches of the row's type: the
    backwards, and the forwards in f32 (bf16 takes the library's)."""
    back = BN_LAUNCHES_A_STEP * steps
    want = {"bn_forward": 0 if bf16 else BN_FORWARDS_A_STEP * steps, "bn_forward_bf16": 0,
            "bn_backward": 0 if bf16 else back, "bn_backward_bf16": back if bf16 else 0}
    if got != want:
        raise SystemExit(f"{what}: expected BatchNorm launches {want}, got {got}")


def read_counts(cc) -> dict:
    """The launch counts by kernel row name."""
    return {"covariance_gram": cc.covariance_forward.launches,
            "covariance_dz": cc.covariance_backward.launches,
            "covariance_gram_bf16": cc.covariance_forward.launches_bf16,
            "covariance_dz_bf16": cc.covariance_backward.launches_bf16}


def expect_counts(got: dict, f32: int, bf16: int, what: str) -> None:
    want = {"covariance_gram": f32, "covariance_dz": f32,
            "covariance_gram_bf16": bf16, "covariance_dz_bf16": bf16}
    if got != want:
        raise SystemExit(f"{what}: expected launches {want}, got {got}")


def synthetic_batch(n_dom: int, per_dom: int, hw: int, seed: int) -> dict:
    """Domain-contiguous batch: images in [-1, 1] with a per-domain brightness
    shift, binary disk masks for OD and OC (NCHW, numpy)."""
    r = np.random.RandomState(seed)
    b = n_dom * per_dom
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    img = r.rand(b, 3, hw, hw).astype(np.float32) * 1.6 - 0.8
    od = np.zeros((b, 1, hw, hw), np.float32)
    oc = np.zeros((b, 1, hw, hw), np.float32)
    for i in range(b):
        cy, cx = r.uniform(0.35, 0.65, 2) * hw
        rad = r.uniform(0.15, 0.22) * hw
        dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
        od[i, 0] = dist2 < rad ** 2
        oc[i, 0] = dist2 < (0.5 * rad) ** 2
        img[i] += 0.2 * (i // per_dom) - 0.2 + 0.3 * od[i]
    return {"image": np.clip(img, -1, 1), "target_od": od, "target_oc": oc}


def check_against_cpu(dev) -> None:
    """Phase 3: a 32x32, batch-3 step and predict on the card against the CPU."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

    hp = default_hparams("WT_PSE")
    cfg = ModelConfig.from_hparams(hp)
    batch = synthetic_batch(3, 1, 32, seed=1)
    r = np.random.RandomState(2)
    eps = {k: torch.from_numpy(r.randn(3, 1, 32, 32).astype(np.float32)) for k in EPS_KEYS}
    out = {}
    for d in ("cpu", dev):
        state = init_ensemble(cfg, device=d, generator=torch.Generator().manual_seed(1))
        nets = (state.od.net, state.od_shape.net, state.oc.net, state.oc_shape.net)
        pred = make_predict_fn(*nets, device=d)(batch["image"])
        metrics = make_train_step(StepConfig(hp, 3, 1), device=d)(
            state, batch, eps={k: v.to(d) for k, v in eps.items()})
        out[str(d)] = (pred, metrics)
    (p_cpu, m_cpu), (p_gpu, m_gpu) = out["cpu"], out[str(dev)]
    rtol, atol = CONV
    worst = 0.0
    for a, b in zip(p_gpu, p_cpu):
        err = float((a.cpu() - b).abs().max())
        bound = atol + rtol * float(b.abs().max())
        worst = max(worst, err / bound)
    # loss_kd{,_oc} read the teacher after an Adam step; a gradient at f32 noise
    # flips its lr*sign(grad) update between devices, so they are only finite-checked
    for k, v in m_cpu.items():
        got = float(m_gpu[k])
        if not math.isfinite(got):
            raise SystemExit(f"non-finite {k} on the card")
        if k.startswith(("loss_kd", "train_dice")):
            continue
        worst = max(worst, abs(got - float(v)) / (atol + rtol * abs(float(v))))
    log(f"card vs CPU (32x32, batch 3): worst error / conv tolerance = {worst:.3f}")
    if worst > 1.0:
        raise SystemExit("the card disagrees with the CPU reference on a small input")


def device_time(prof, by_card: bool = False):
    """(busy us: the union of the device kernels' and copies' intervals, or
    with ``by_card`` each card's by its index, first-to-last window us, us by
    name, calls by name) of a trace; the annotation ranges are left out. It
    reads the profiler's raw events: ``prof.events()`` builds every host op's
    event tree first, which took 38-41 s for one traced data-parallel loop
    epoch on an H100 machine's host."""
    from torch.autograd import DeviceType

    spans, by_name, calls = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not getattr(e, "is_user_annotation",
                                                               lambda: False)():
            start = e.start_ns() / 1e3
            spans.setdefault(e.device_index(), []).append((start, start + e.duration_ns() / 1e3))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
            calls[e.name()] = calls.get(e.name(), 0) + 1
    every = [x for v in spans.values() for x in v]
    if not every:
        raise SystemExit("the profiler saw no device time")
    window = max(e for _, e in every) - min(s for s, _ in every)
    busy = {k: union_us(v) for k, v in sorted(spans.items())} if by_card else union_us(every)
    return busy, window, by_name, calls


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# device kernels by the layer they belong to, for the step's breakdown
# (first match wins: cuDNN's BatchNorm kernels also carry "cudnn")
KERNEL_GROUPS = (("covariance", r"gram_\w+_kernel|dz_(\w+_)?kernel"),
                 ("batchnorm", r"batch_norm|bn_fw|bn_bw|welford"),
                 ("convolution", r"conv|cudnn|fft|implicit|xmma|wgrad|dgrad|winograd|"
                                 r"nchwToNhwc|nhwcToNchw|sm90_|sm80_"),
                 ("cast", r"direct_copy|copy_kernel"),
                 ("upsample", r"upsample"),
                 ("nccl", r"nccl"))


def kernel_group(name: str) -> str:
    for group, pattern in KERNEL_GROUPS:
        if re.search(pattern, name, re.I):
            return group
    return "other"


def profile_eager_steps(step, state, batch, gen, step_ms: float, n: int = 2) -> None:
    """Device time by kernel over ``n`` steady traced steps, by layer
    (``KERNEL_GROUPS``), and the device's busy share of ``step_ms``, the
    untraced steady step time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, window, by_name, calls = device_time(prof)
    n_events = sum(calls.values())
    total = sum(by_name.values())
    log(f"profile ({n} steps): traced wall {wall_us / n / 1e3:.2f} ms/step, device "
        f"busy {busy / n / 1e3:.2f} ms/step = {busy / n / 1e3 / step_ms:.1%} of the "
        f"untraced {step_ms:.2f} ms step, {busy / window:.1%} of the traced "
        f"first-to-last-kernel window; {n_events // n} device events/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        log(f"  {us / n / 1e3:8.3f} ms/step {us / total:6.1%}  {name[:110]}")
    groups: dict[str, float] = {}
    for name, us in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + us
    log("device time by layer: " + ", ".join(
        f"{g} {us / n / 1e3:.2f} ms/step ({us / total:.1%})"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))
    # the hand-written kernels as the step calls them, the L2 left as the
    # step's other kernels leave it
    own = {re.sub(r"^void |\(anonymous namespace\)::|[(<].*$", "", k): (v, calls[k])
           for k, v in by_name.items()
           if re.search(r"gram_\w+_kernel|dz_(\w+_)?kernel|bn_bw_\w+_kernel", k)}
    own_us = sum(v for v, _ in own.values())
    log(f"the hand-written kernels: {own_us / n / 1e3:.3f} ms/step, "
        f"{own_us / total:.2%} of device time; " +
        ", ".join(f"{k} {v / n / 1e3:.3f} ms/step ({v / k_n:.2f} us a call)"
                  for k, (v, k_n) in sorted(own.items())))


def main_path(cc, dev) -> float:
    """Phase 4: full-width steps and the two-stage predict. Returns the
    steady step time in ms."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import StepConfig, make_train_step

    hp = default_hparams("WT_PSE")
    n_dom, per_dom, hw = 3, 3, 256
    cfg = ModelConfig.from_hparams(hp)
    state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(StepConfig(hp, n_dom, per_dom), device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(n_dom, per_dom, hw, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()

    zero_counts(cc)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"non-finite metrics at step {state.step}: {bad}")
    launches, bn_launches = read_counts(cc), read_bn_counts()
    steady_ms = statistics.median(times[1:]) * 1e3
    log(f"train steps ({STEPS}, 256x256, batch 9 = 3x3, f32): " +
        ", ".join(f"{t * 1e3:.2f} ms" for t in times) +
        f"; steady median {steady_ms:.2f} ms/step")
    log("last step metrics: " + json.dumps({k: float(v) for k, v in sorted(metrics.items())}))
    log(f"covariance launches over the {STEPS} steps: {launches}; BatchNorm "
        f"launches {bn_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    expect_counts(launches, 8 * STEPS, 0, "phase 4")
    expect_bn_counts(bn_launches, STEPS, False, "phase 4")
    expect_up_counts(STEPS, False, "phase 4")
    profile_eager_steps(step, state, batch, gen, steady_ms)

    # the maps in train mode, as the step makes them; the BatchNorm running
    # statistics that this forward updates are put back before the predict
    wt = state.od.net.wt_model
    saved = [b.clone() for b in wt.buffers()]
    with torch.no_grad():
        maps = wt(batch["image"])[:2]  # the DeepWT maps 0 and 1
        for b, s in zip(wt.buffers(), saved):
            b.copy_(s)
    g = torch.randn(9, 16, 16, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    for i, z in enumerate(maps):
        if tuple(z.shape) != MAIN_SHAPE:
            raise SystemExit(f"DeepWT map {i} has shape {tuple(z.shape)}, not {MAIN_SHAPE}")
        check_pair(cc, z.contiguous(), g, f"OD DeepWT map {i} after the steps")

    predict = make_predict_fn(state.od.net, state.od_shape.net, state.oc.net,
                              state.oc_shape.net, device=dev)
    ptimes = []
    for _ in range(3):
        t0 = time.perf_counter()
        od, oc = predict(batch["image"])
        torch.cuda.synchronize()
        ptimes.append(time.perf_counter() - t0)
    for name, t in (("od", od), ("oc", oc)):
        if t.shape != (9, 1, hw, hw) or not torch.isfinite(t).all():
            raise SystemExit(f"predict {name}: shape {tuple(t.shape)}, finite "
                             f"{bool(torch.isfinite(t).all())}")
    log("two-stage predict (batch 9, 256x256): " +
        ", ".join(f"{t * 1e3:.2f} ms" for t in ptimes) +
        f"; od>0.75 share {float((torch.sigmoid(od) > 0.75).float().mean()):.4f}")
    return steady_ms


def synthetic_pools(seed: int = 11):
    """Phase 6's data, made with numpy: 3 train domains of 12 images at 256x256
    uint8 with gray labels (255 background, 128 disc, 0 cup; a disc disk and a
    cup disk at seeded centres and radii, and a per-domain brightness shift),
    and a validation domain of 8 images at 256x256 whose labels are at native
    512x512 (5) and 640x640 (3), each disk drawn on every grid from the same
    normalised centre and radius."""
    from wt_pse_tpu_torch.data.fundus import FundusDomain

    r = np.random.RandomState(seed)

    def sample(domain: int, label_hws):
        cy, cx = r.uniform(0.35, 0.65, 2)
        rad = r.uniform(0.15, 0.22)
        grays = []
        for hw in (256,) + label_hws:
            yy, xx = (np.mgrid[0:hw, 0:hw] + 0.5) / hw
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            gray = np.full((hw, hw), 255, np.uint8)
            gray[d2 < rad ** 2] = 128
            gray[d2 < (0.5 * rad) ** 2] = 0
            grays.append(gray)
        disc = (grays[0] < 255)[..., None]
        img = r.rand(256, 256, 3) * 120 + 40 + 25 * domain + 50 * disc
        return np.clip(img, 0, 255).astype(np.uint8), grays[-1]

    train = []
    for d in range(3):
        pairs = [sample(d, ()) for _ in range(12)]
        train.append(FundusDomain(images=np.stack([p[0] for p in pairs]),
                                  labels=np.stack([p[1] for p in pairs])))
    pairs = [sample(1, (512 if i < 5 else 640,)) for i in range(8)]
    val = FundusDomain(images=np.stack([p[0] for p in pairs]), labels=[p[1] for p in pairs])
    return train, val


def trainer_path(cc, dev, tmp: str) -> dict:
    """Phase 6: the Trainer, through its entry points, in ``tmp``. Returns the
    launch counts of its run, the trained Trainer, its newest checkpoint and
    its pools."""
    from torch.profiler import ProfilerActivity, profile

    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.io.checkpoint import (load_reference_checkpoint,
                                                restore_ensemble, save_ensemble)
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.trainer import Trainer

    log("importable here: " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}" for m in ("PIL", "yaml")))
    hp = default_hparams("WT_PSE")
    train, val = synthetic_pools()
    kw = dict(batch_size=9, interval_validate=1, label="OD", seed=1, eval_batch_size=8,
              val_visualization=False, device=dev)
    nets = lambda st: (ns.net for ns in st.net_states())
    run = os.path.join(tmp, "run")
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(hp, train, val, run, max_epoch=EPOCHS, **kw)
    if not trainer.scan_epochs:
        raise SystemExit("phase 6: the default Trainer on the card is not the graph driver")
    torch.cuda.synchronize()
    zero_counts(cc)
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches, bn_launches = read_counts(cc), read_bn_counts()
    steps = EPOCHS * trainer.iter_per_epoch
    et = trainer.epoch_seconds
    steady = statistics.median(et[1:])
    log(f"trainer ({EPOCHS} epochs x {trainer.iter_per_epoch} steps, 256x256, batch 9 = "
        f"3x3, f32, the graph driver, captured in {trainer._graph.capture_seconds:.2f} s, "
        f"its pool {trainer._graph.pool_bytes / 2 ** 30:.2f} GiB): {wall:.2f} s in train(); "
        f"epochs " +
        ", ".join(f"{t:.3f}" for t in et) + f" s; first {et[0]:.3f} s, steady median "
        f"{steady:.3f} s = {trainer.iter_per_epoch / steady:.3f} steps/s; the host "
        f"enqueued the steps in " + ", ".join(f"{t:.3f}" for t in trainer.enqueue_seconds) +
        f" s of them; covariance "
        f"launches {launches}; BatchNorm launches {bn_launches} "
        f"({trainer._graph.launches_per_step} a replayed step); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    expect_counts(launches, 8 * steps, 0, "phase 6")
    expect_bn_counts(bn_launches, steps, False, "phase 6")
    for i, v in enumerate(trainer.validation_seconds):
        log(f"validation {i} (8 images, native 512x512 x5 and 640x640 x3): "
            f"{sum(v.values()):.3f} s = predict on the card {v['predict']:.3f} s + "
            f"host upsample {v['upsample']:.3f} s + host scoring {v['score']:.3f} s")

    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "loss_seg" in r]
    vals = [{k: v for k, v in r.items() if k.startswith("val/")}
            for r in recs if "val/objective" in r]
    with open(os.path.join(run, "log.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    ckpts = sorted(glob.glob(os.path.join(run, "checkpoint_*.pth.tar")),
                   key=lambda p: int(re.findall(r"_(\d+)\.pth", p)[0]))
    log("epoch losses: " + json.dumps(
        [{k: r[k] for k in ("loss_seg", "loss_seg_oc", "loss_kd", "loss_kd_oc")}
         for r in epochs]))
    log("validations: " + json.dumps(vals))
    bad = [r["step"] for r in epochs
           if not all(math.isfinite(v) for k, v in r.items() if k != "step")]
    if len(epochs) != EPOCHS or bad:
        raise SystemExit(f"{len(epochs)} epoch records, non-finite at epochs {bad}")
    if len(rows) != EPOCHS:
        raise SystemExit(f"log.csv has {len(rows)} rows, not {EPOCHS}")
    if len(vals) != 2 or any(len(v) != 7 or not all(map(math.isfinite, v.values()))
                             for v in vals):
        raise SystemExit(f"expected 2 validations of 7 finite metrics, got {vals}")
    if not ckpts or not os.path.exists(os.path.join(run, "best.json")):
        raise SystemExit("no checkpoint or no best.json")
    log(f"validations scored on: {trainer.scoring_backend}")
    if trainer.scoring_backend != "native":
        raise SystemExit(f"validation scored on {trainer.scoring_backend}, not the "
                         "native operators")

    # the trained nets, saved and reloaded into fresh nets, predict bitwise equal
    cfg = ModelConfig.from_hparams(hp)
    final = os.path.join(tmp, "final.pth.tar")
    save_ensemble(final, trainer.state)
    images = trainer.val_images.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    want = make_predict_fn(*nets(trainer.state), device=dev)(images)
    strict = restore_ensemble(final, init_ensemble(
        cfg, device=dev, generator=torch.Generator().manual_seed(5)))
    partial = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(6))
    counts = load_reference_checkpoint(final, partial, strict=True)
    for what, st in (("strict load", strict), ("filtered partial load", partial)):
        got = make_predict_fn(*nets(st), device=dev)(images)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"reloaded checkpoint ({what}) predicts bitwise equal: {same}")
        if not same:
            raise SystemExit(f"the checkpoint reloaded by {what} predicts otherwise")
    log(f"filtered partial load matched leaves: {counts}")
    if list(counts.values()) != [336, 158, 336, 158]:
        raise SystemExit(f"expected 336/158/336/158 matched leaves, got {counts}")

    # resume from the newest checkpoint; its one more epoch is profiled
    n = int(re.findall(r"_(\d+)\.pth", ckpts[-1])[0])
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    resumed = Trainer(hp, train, val, os.path.join(tmp, "resumed"), max_epoch=n + 1,
                      stop_epoch=n, resume=ckpts[-1], **kw)
    if resumed.epoch != n or resumed.best["objective"] != best["objective"]:
        raise SystemExit(f"resume from {ckpts[-1]} starts at epoch {resumed.epoch} with "
                         f"best {resumed.best}, not epoch {n} with {best}")
    # the graphed run's checkpoint resumes under the loop too: the same step
    # count, weights and Adam state as the graph driver restored in place
    loop = Trainer(hp, train, val, os.path.join(tmp, "resumed_loop"), max_epoch=n + 1,
                   stop_epoch=n, resume=ckpts[-1], scan_epochs=False, **kw)
    same = loop.state.step == resumed.state.step and all(
        torch.equal(a.cpu(), b.cpu()) for x, y in zip(loop.state.net_states(),
                                                      resumed.state.net_states())
        for a, b in zip(list(x.net.state_dict().values()) +
                        [v for st in x.opt.state.values() for v in st.values()],
                        list(y.net.state_dict().values()) +
                        [v for st in y.opt.state.values() for v in st.values()]))
    log(f"the checkpoint resumed under the loop: step {loop.state.step}, weights and Adam "
        f"state bitwise equal to the graph driver's restore: {same}")
    if not same:
        raise SystemExit("the graphed run's checkpoint resumes otherwise under the loop")
    del loop
    if resumed.scan_epochs:
        resumed.start_device_spans()  # the sampler's span inside the graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        resumed.train()
        torch.cuda.synchronize()
    with open(os.path.join(tmp, "resumed", "log.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    if len(rows) != 1 or rows[0].split(",")[0] != str(n):
        raise SystemExit(f"the resumed run logged {rows}, not one row of epoch {n}")
    busy, window, _, _ = device_time(prof)
    if resumed.scan_epochs:
        # the device span of the sampler, stamped inside the replayed graph
        rec = resumed.tracer.stamped[-1]
        sample = np.diff(rec.stamps, axis=0)[rec.names.index("sample") - 1]
        batch_us = float(sample.sum()) / 1e3
        batch = (f"sampling and augmentation inside the replayed graph {batch_us / 1e3:.3f} ms "
                 f"of device time ({batch_us / busy:.2%} of busy; its `sample` spans, "
                 f"{sample.mean() / 1e6:.3f} ms a step)")
    else:
        ranges = [e for e in prof.events() if e.name == "sample"
                  and e.device_type != torch.autograd.DeviceType.CUDA]
        batch_us = sum(e.device_time_total for e in ranges)
        batch_host_us = sum(e.cpu_time_total for e in ranges)
        batch = (f"sampling and augmentation {batch_us / 1e3:.3f} ms of device time "
                 f"({batch_us / busy:.2%} of busy) and {batch_host_us / 1e3:.3f} ms of host "
                 f"time ({batch_host_us / 1e6 / resumed.epoch_seconds[0]:.2%} of the traced "
                 "epoch; its `sample` spans)")
    log(f"resumed at epoch {n} (best objective {best['objective']:.6f} restored, driver "
        f"{'graph' if resumed.scan_epochs else 'eager'}), one more epoch traced: "
        f"{resumed.epoch_seconds[0]:.3f} s traced; device busy "
        f"{busy / 1e6:.3f} s = {busy / 1e6 / steady:.1%} of the untraced steady "
        f"{steady:.3f} s epoch, {busy / window:.1%} of the traced first-to-last-kernel "
        f"window; {batch}")
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    log("host time of the traced epoch by op (self, top 12): " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}" for e in host[:12]))
    return {"launches": {**launches, **bn_launches}, "steps": steps, "trainer": trainer,
            "checkpoint": ckpts[-1],
            "train": train, "val": val, "epoch_loss_seg": [r["loss_seg"] for r in epochs]}


def blob_masks(b: int = 8, hw: int = 256, seed: int = 13) -> np.ndarray:
    """Seeded (B, H, W) bool masks: disks with specks and a hole, and in the
    last item a serpentine path longer than H + W (the capped propagation)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    m = np.zeros((b, hw, hw), bool)
    for i in range(b - 1):
        for _ in range(4):
            cy, cx = r.randint(hw // 8, hw - hw // 8, 2)
            rad = r.randint(hw // 40, hw // 6)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
        m[i] |= r.rand(hw, hw) > 0.995
        m[i, hw // 2 - 3:hw // 2 + 3, hw // 2 - 3:hw // 2 + 3] = False
    for k, y in enumerate(range(1, hw - 1, 2)):
        m[-1, y, 1:hw - 1] = True
        if y + 1 < hw - 1:
            m[-1, y + 1, hw - 2 if k % 2 == 0 else 1] = True
    return m


def timed(fn):
    """(result, host seconds) of ``fn()``, ended by a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spans_of(fn):
    """(result, seconds by name of its spans) of ``fn(tracer=...)`` run in
    a ``validate`` span of a tracer of its own (``utils/trace.py``)."""
    from wt_pse_tpu_torch.utils.trace import Tracer

    tracer = Tracer()
    with tracer.span("validate") as span:
        out = fn(tracer=tracer)
    return out, tracer.child_seconds(span)


def write_test_split(root: str, val) -> None:
    """Phase 7's synthetic Fundus test split, with PIL, in the layout
    ``data/fundus.py`` reads: ``Domain3/test/ROIs/{image,mask}/G_<i>.png``,
    each image the validation image resized to its label's native size."""
    from PIL import Image

    for sub in ("image", "mask"):
        os.makedirs(os.path.join(root, "Domain3", "test", "ROIs", sub), exist_ok=True)
    for i, (img, lab) in enumerate(zip(val.images, val.labels)):
        hw = lab.shape[-1]
        Image.fromarray(img).resize((hw, hw), Image.BICUBIC).save(
            os.path.join(root, "Domain3", "test", "ROIs", "image", f"G_{i}.png"))
        Image.fromarray(lab).save(os.path.join(root, "Domain3", "test", "ROIs", "mask", f"G_{i}.png"))


def eval_path(cc, dev, tmp: str, p6: dict) -> None:
    """Phase 7: the evaluation path on the card, from phase 6's trained nets
    and newest checkpoint. Each part is driven with the covariance launch
    counts set to 0 just before and read just after."""
    from wt_pse_tpu_torch import native
    from wt_pse_tpu_torch.api import load_predictor
    from wt_pse_tpu_torch.cli import test_visualization as eval_cli
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.data.fundus import encode_masks, load_fundus
    from wt_pse_tpu_torch.ops import metrics as M
    from wt_pse_tpu_torch.ops import postprocess as PP
    from wt_pse_tpu_torch.ops import postprocess_device as PD
    from wt_pse_tpu_torch.train.eval import (_resize_host, evaluate_domain, make_predict_fn,
                                             resize_device)
    from wt_pse_tpu_torch.train.eval_device import device_metrics
    from wt_pse_tpu_torch.train.trainer import Trainer

    def counted(what, fn, expect=0):
        zero_counts(cc)
        out = fn()
        torch.cuda.synchronize()
        got = read_counts(cc)
        log(f"phase 7 {what}: covariance launches {got}")
        expect_counts(got, expect, 0, f"phase 7 {what}")
        return out

    hp = default_hparams("WT_PSE")
    trainer, ckpt, val = p6["trainer"], p6["checkpoint"], p6["val"]
    nets = tuple(ns.net for ns in trainer.state.net_states())

    # (a) the native operators: built with g++ here, the scoring backend
    t0 = time.perf_counter()
    lib = native.build()
    log(f"phase 7 (a): native library {lib.name} ready in {time.perf_counter() - t0:.2f} s; "
        f"scoring backend {native.scoring_backend('native')}")
    m640 = blob_masks(2, 640, seed=14)
    m640[1] = np.roll(m640[0], 5, axis=1)
    lcc_n, t_lcc_n = timed(lambda: PP.largest_component_fill_holes(m640[0], backend="native"))
    lcc_s, t_lcc_s = timed(lambda: PP.largest_component_fill_holes(m640[0], backend="scipy"))
    sd_n, t_sd_n = timed(lambda: M.surface_distances(m640[0], m640[1], backend="native"))
    sd_s, t_sd_s = timed(lambda: M.surface_distances(m640[0], m640[1], backend="scipy"))
    sd_err = float(np.abs(sd_n - sd_s).max() / max(1.0, np.abs(sd_s).max()))
    log(f"phase 7 (a) on a 640x640 mask: LCC + fill native {t_lcc_n * 1e3:.2f} ms, scipy "
        f"{t_lcc_s * 1e3:.2f} ms, bitwise equal {np.array_equal(lcc_n, lcc_s)}; surface "
        f"distances ({len(sd_s)}) native {t_sd_n * 1e3:.2f} ms, scipy {t_sd_s * 1e3:.2f} ms, "
        f"max error / max(1, range) {sd_err:.2e} (tolerance 1e-5)")
    if not np.array_equal(lcc_n, lcc_s) or sd_err > 1e-5:
        raise SystemExit("the native operators disagree with the scipy path")

    # (b) post-processing on the card against the same functions on the CPU
    predict = make_predict_fn(*nets, device=dev)
    images = trainer.val_images.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    od, oc = predict(images)
    logits = torch.cat([od[:, 0], oc[:, 0]])
    size = logits.shape[-1]
    binary = torch.cat([torch.sigmoid(logits) > 0.75,  # thresholded once
                        torch.from_numpy(blob_masks(hw=size)).to(dev)])

    def post_card():
        return [fn(binary) for fn in (PD.label_components, PD.largest_component, PD.fill_holes)]

    card = counted("(b) device post-processing", post_card)
    cpu = [fn(binary.cpu()) for fn in (PD.label_components, PD.largest_component, PD.fill_holes)]
    same = [torch.equal(a.cpu(), b) for a, b in zip(card, cpu)]
    log(f"phase 7 (b): label_components / largest_component / fill_holes on the card equal "
        f"the CPU bitwise: {same} ({int(binary[:16].flatten(1).any(1).sum())} of 16 trained "
        f"masks non-empty, plus 8 seeded)")
    if not all(same):
        raise SystemExit("device post-processing on the card differs from the CPU")
    from PIL import Image

    gts = [encode_masks(np.asarray(Image.fromarray(lab).resize((size, size)), np.uint8))
           for lab in val.labels]  # as the Trainer resizes them
    gt_od = torch.from_numpy(np.stack([g[0] for g in gts])).to(dev)
    gt_oc = torch.from_numpy(np.stack([g[1] for g in gts])).to(dev)
    got = device_metrics(od[:, 0], oc[:, 0], gt_od, gt_oc)
    want = device_metrics(od[:, 0].cpu(), oc[:, 0].cpu(), gt_od.cpu(), gt_oc.cpu())
    near = int(((logits - math.log(3.0)).abs() < 1e-6).sum())
    worst = max(float(((got[k].cpu() - v).abs() / (1e-9 + F32_REDUCE_RTOL * v.abs())).max())
                for k, v in want.items())
    log(f"phase 7 (b): device_metrics on the card vs the CPU, worst error / f32_reduce "
        f"{worst:.3f}; {near} logits within 1e-6 of ln 3")
    if worst > 1.0 and near == 0:
        raise SystemExit("device_metrics on the card disagrees with the CPU")

    # (c) fast validation and the montage, resumed from the checkpoint
    n = int(re.findall(r"_(\d+)\.pth", ckpt)[0])
    run = os.path.join(tmp, "fast")
    batch = trainer.per_domain_batch * trainer.domain_num
    fast = Trainer(hp, p6["train"], val, run, batch_size=batch, interval_validate=1, label="OD",
                   seed=1, eval_batch_size=8, val_visualization=False, device=dev,
                   image_size=size, max_epoch=n + 1, resume=ckpt, fast_validation=True,
                   train_visualization=True, train_viz_interval=2)
    steps = fast.iter_per_epoch
    if fast.epoch != n:
        raise SystemExit(f"the resume from {ckpt} starts at epoch {fast.epoch}, not {n}")
    counted("(c) one epoch with fast validation and the montage", fast.train, 8 * steps)
    shots = sum(1 for g in range(n * steps, (n + 1) * steps) if g % 2 == 0)
    pngs = len(glob.glob(os.path.join(run, "images", "train_*.png")))
    fast_nets = tuple(ns.net for ns in fast.state.net_states())
    fast_predict = make_predict_fn(*fast_nets, device=dev)
    fast_again, t_fast = timed(fast.validate)
    (host_val, host_t), t_host = timed(lambda: spans_of(lambda tracer: evaluate_domain(
        fast_predict, fast.val_images, fast.val_od, fast.val_oc, "OD", 8, tracer=tracer,
        backend="native")))
    log(f"phase 7 (c): resumed at epoch {n}, one epoch of {steps} steps; fast validation "
        f"{fast.validation_seconds[0]['device']:.3f} s in train(), again {t_fast:.3f} s "
        f"(objective {fast_again['objective']:.6f}, scored on {fast.scoring_backend}); host "
        f"validation of the same nets and images {t_host:.3f} s = predict "
        f"{host_t['predict']:.3f} + upsample {host_t['upsample']:.3f} + scoring "
        f"{host_t['score']:.3f} (objective {host_val['objective']:.6f}, native); "
        f"{pngs} montage PNGs ({shots} montages of 4)")
    if fast.scoring_backend != "device" or pngs != 4 * shots or not all(
            math.isfinite(v) for v in list(fast_again.values()) + list(host_val.values())):
        raise SystemExit("fast validation or the montage failed")

    # (d) the eval CLI on a synthetic test split at native 512 and 640
    root, out = os.path.join(tmp, "fundus"), os.path.join(tmp, "vis")
    write_test_split(root, val)
    argv = ["--device", dev.type, "--datasetTest", "3", "--label", "OD", "--data-dir", root,
            "--model-file", ckpt, "--out", out, "--batch-size", "8", "--save-images"]
    if native.scoring_backend("auto") != "native":  # what the CLI scores on
        raise SystemExit(f"the eval CLI would score on scipy: {native.unavailable_reason()}")
    res, t_cli = timed(lambda: counted("(d) the eval CLI", lambda: eval_cli.main(argv)))
    reloaded = eval_cli.build_networks(ckpt, hp, device=dev)
    cli_predict = make_predict_fn(*reloaded, device=dev)
    domain = load_fundus(root, "test", [3], state="prediction")
    masks = [encode_masks(np.asarray(lab, np.uint8)) for lab in domain.labels]
    dom_images = torch.from_numpy(np.asarray(domain.images)).to(dev)
    direct = evaluate_domain(cli_predict, dom_images, [m[0] for m in masks],
                             [m[1] for m in masks], "OD", 8, backend="native")
    (on_card, dev_t), t_dev = timed(lambda: spans_of(lambda tracer: evaluate_domain(
        cli_predict, dom_images, [m[0] for m in masks], [m[1] for m in masks], "OD", 8,
        tracer=tracer, resize="device", backend="native")))
    chunk = dom_images[5:].permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    lg = cli_predict(chunk)[0]
    up = resize_device(lg, (640, 640)).cpu().numpy()
    up_err = float(np.abs(up - _resize_host(lg.cpu().numpy(), (640, 640))).max()
                   / np.abs(up).max())
    files = {sub: len(os.listdir(os.path.join(out, sub))) for sub in ("overlay", "original_image")}
    log(f"phase 7 (d): eval CLI {t_cli:.3f} s (load, predict, native scoring, 8 overlays): "
        f"{json.dumps(res)}; evaluate_domain on the reloaded nets equal: {res == direct}; "
        f"resize='device' {t_dev:.3f} s (predict + upsample on the card "
        f"{dev_t['predict']:.3f} s, scoring {dev_t['score']:.3f} s) objective "
        f"{on_card['objective']:.6f}; device vs host f64 upsample at 640, error / max|logit| "
        f"{up_err:.2e} (f32_reduce {F32_REDUCE_RTOL}); files {files}")
    if res != direct or up_err > F32_REDUCE_RTOL or files != {"overlay": 8, "original_image": 8}:
        raise SystemExit("the eval CLI check failed")

    # (e) load_predictor on 412x412 uint8 images
    imgs412 = np.stack([np.asarray(Image.fromarray(im).resize((412, 412), Image.BICUBIC))
                        for im in val.images])
    predictor = load_predictor(ckpt, device=dev)
    first, t_first = timed(lambda: counted("(e) load_predictor", lambda: predictor(imgs412)))
    steady = [timed(lambda: predictor(imgs412))[1] for _ in range(3)]
    ok = (first["od"].shape == first["oc"].shape == (8, 412, 412)
          and np.isfinite(first["od_logits"]).all() and np.isfinite(first["oc_logits"]).all())
    log(f"phase 7 (e): load_predictor on 8 uint8 images at 412x412: masks "
        f"{first['od'].shape}, logits {first['od_logits'].shape} finite {ok}; first call "
        f"{t_first:.3f} s, steady " + ", ".join(f"{t:.3f}" for t in steady) + " s; od mask "
        f"share {float(first['od'].mean()):.4f}")
    if not ok:
        raise SystemExit("load_predictor returned the wrong shapes or non-finite logits")


def small_card_vs_cpu(dev, hp: dict, algorithm: str, what: str) -> float:
    """A 32x32, batch-3 step and predict of ``algorithm`` under ``hp`` on the
    card against the same on the CPU, at tolerance class bf16 (``BF16_TOL``:
    the two devices round the bf16 convolutions and reductions at other
    places). Thresholded counts are not compared: the sigmoid is bf16, whose
    values near 0.75 lie 1/256 apart, so a 1-ulp difference of a logit moves a
    pixel across the threshold. So ``train_dice`` and ``pos_weight_oc`` (a
    ratio of two counts) are only finite-checked, and the OC logits, which
    the OD prediction masks, are compared where both devices cut the same
    ROI. Returns the worst error / tolerance."""
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.eval import make_predict_fn_for
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

    cfg = ModelConfig.from_hparams(hp)
    batch = synthetic_batch(3, 1, 32, seed=1)
    r = np.random.RandomState(2)
    eps = {k: torch.from_numpy(r.randn(3, 1, 32, 32).astype(np.float32)) for k in EPS_KEYS}
    out = {}
    for d in ("cpu", dev):
        state = init_ensemble(cfg, device=d, generator=torch.Generator().manual_seed(1),
                              algorithm=algorithm)
        nets = [ns.net for ns in state.net_states()]
        pred = make_predict_fn_for(algorithm, nets, device=d)(batch["image"])
        metrics = make_train_step(StepConfig(hp, 3, 1, distill=algorithm != JOINT), device=d)(
            state, batch, eps={k: v.to(d) for k, v in eps.items()})
        out[str(d)] = (pred, metrics)
    (p_cpu, m_cpu), (p_gpu, m_gpu) = out["cpu"], out[str(dev)]
    rtol, atol = BF16_TOL
    errs = {}
    same_roi = (torch.sigmoid(p_gpu[0].cpu()) > 0.75) == (torch.sigmoid(p_cpu[0]) > 0.75)
    for name, a, b in (("predict od", p_gpu[0].cpu(), p_cpu[0]),
                       ("predict oc", p_gpu[1].cpu() * same_roi, p_cpu[1] * same_roi)):
        errs[name] = float((a - b).abs().max()) / (atol + rtol * float(b.abs().max()))
    for k, v in m_cpu.items():
        got = float(m_gpu[k])
        if not math.isfinite(got):
            raise SystemExit(f"{what}: non-finite {k} on the card")
        if k.startswith(("loss_kd", "train_dice", "pos_weight")):
            continue  # read after an Adam step (as phase 3) / thresholded counts
        errs[k] = abs(got - float(v)) / (atol + rtol * abs(float(v)))
    worst = max(errs.values())
    log(f"{what}: card vs CPU (32x32, batch 3): worst error / bf16 tolerance "
        f"(rtol {rtol}, atol {atol}) = {worst:.3f} ({max(errs, key=errs.get)}); "
        f"{int((~same_roi).sum())} of {same_roi.numel()} OD pixels thresholded otherwise; "
        f"pos_weight_oc card {float(m_gpu['pos_weight_oc']):.5f} CPU "
        f"{float(m_cpu['pos_weight_oc']):.5f}")
    if worst > 1.0:
        raise SystemExit(f"{what}: the card disagrees with the CPU on a small input")
    return worst


def bf16_path(cc, dev, tmp: str, f32_step_ms: float, p6: dict) -> dict:
    """Phase 8: the bf16 main path. Full-width bf16 steps from seeded weights
    on one fixed batch (launch counts set to 0 just before, read just after:
    8 of each bf16 kernel a step, no f32 launch), their time beside phase 4's
    f32 step of this call, a profile of two more, the dtypes after the steps
    and a falling loss; a bf16 Trainer for 3 epochs and one validation; a
    small bf16 step and predict against the CPU; the peak device memory.
    Returns the launch counts of the Trainer's run and its steps."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import StepConfig, make_train_step
    from wt_pse_tpu_torch.train.trainer import Trainer

    hp = dict(default_hparams("WT_PSE"), compute_dtype="bfloat16")
    n_dom, per_dom, hw = 3, 3, 256
    cfg = ModelConfig.from_hparams(hp)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(StepConfig(hp, n_dom, per_dom), device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(n_dom, per_dom, hw, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    zero_counts(cc)
    times, losses = [], []
    for _ in range(STEPS_BF16):
        t0 = time.perf_counter()
        metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss_seg"]))
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"phase 8: non-finite metrics at step {state.step}: {bad}")
    launches, bn_launches = read_counts(cc), read_bn_counts()
    bf16_ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"phase 8 bf16 train steps ({STEPS_BF16}, 256x256, batch 9 = 3x3, one fixed batch): " +
        ", ".join(f"{t * 1e3:.2f} ms" for t in times) + f"; steady median {bf16_ms:.2f} "
        f"ms/step against the f32 step's {f32_step_ms:.2f} ms (phase 4, this call): "
        f"{bf16_ms / f32_step_ms:.3f}x; peak device memory {peak:.2f} GiB (f32: phase 4)")
    log(f"phase 8 loss_seg over the {STEPS_BF16} steps: " + ", ".join(f"{v:.5f}" for v in losses))
    log(f"phase 8 covariance launches: {launches}; BatchNorm launches {bn_launches}")
    expect_counts(launches, 0, 8 * STEPS_BF16, "phase 8 steps")
    expect_bn_counts(bn_launches, STEPS_BF16, True, "phase 8 steps")
    expect_up_counts(STEPS_BF16, True, "phase 8 steps")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"phase 8: the bf16 loss did not fall over {STEPS_BF16} steps: {losses}")
    dtypes = {str(t.dtype) for ns in state.net_states() for n, t in
              list(ns.net.named_parameters()) + list(ns.net.named_buffers())
              if not n.endswith("num_batches_tracked")}
    log(f"phase 8 parameter and BatchNorm statistic dtypes after the steps: {sorted(dtypes)}")
    if dtypes != {"torch.float32"}:
        raise SystemExit(f"phase 8: parameters or BN statistics left f32: {dtypes}")
    profile_eager_steps(step, state, batch, gen, bf16_ms)
    # the bf16 kernels on the main path's own bf16 DeepWT maps (the OD net's)
    wt = state.od.net.wt_model
    saved = [b.clone() for b in wt.buffers()]
    with torch.no_grad():
        maps = wt(batch["image"])[:2]
        for b, s in zip(wt.buffers(), saved):
            b.copy_(s)
    g = torch.randn(9, 16, 16, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    for i, z in enumerate(maps):
        if tuple(z.shape) != MAIN_SHAPE or z.dtype != torch.bfloat16:
            raise SystemExit(f"phase 8: DeepWT map {i} is {z.dtype} {tuple(z.shape)}")
        check_pair(cc, z.contiguous(), g, f"phase 8 OD DeepWT map {i} after the bf16 steps")

    run = os.path.join(tmp, "bf16_run")
    trainer = Trainer(hp, p6["train"], p6["val"], run, max_epoch=3, batch_size=9,
                      interval_validate=1, label="OD", seed=1, eval_batch_size=8,
                      val_visualization=False, device=dev)
    torch.cuda.synchronize()
    zero_counts(cc)
    trainer.train()
    t_launches, t_bn = read_counts(cc), read_bn_counts()
    steps = 3 * trainer.iter_per_epoch
    expect_counts(t_launches, 0, 8 * steps, "phase 8 trainer")
    expect_bn_counts(t_bn, steps, True, "phase 8 trainer")
    val, t_val = timed(trainer.validate)
    with open(os.path.join(run, "run_meta.json")) as f:
        meta = json.load(f)
    et = trainer.epoch_seconds
    with open(os.path.join(run, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss_seg"] for line in f if "loss_seg" in line]
    log(f"phase 8 bf16 trainer epoch loss_seg {losses} (phase 6's f32 trainer, the same "
        f"seed and pools: the first 3 of {p6['epoch_loss_seg']})")
    log(f"phase 8 bf16 trainer (3 epochs x {trainer.iter_per_epoch} steps): epochs " +
        ", ".join(f"{t:.3f}" for t in et) + f" s (steady median {statistics.median(et[1:]):.3f}"
        f" s; phase 6's f32 epochs in this call: " +
        ", ".join(f"{t:.3f}" for t in p6["trainer"].epoch_seconds) + " s); host enqueue " +
        ", ".join(f"{t:.3f}" for t in trainer.enqueue_seconds) + f" s; launches {t_launches}, "
        f"BatchNorm {t_bn} ({getattr(trainer._graph, 'launches_per_step', None)} a "
        f"replayed step); "
        f"validation {t_val:.3f} s: {json.dumps(val)}; run_meta compute_dtype "
        f"{meta['compute_dtype']!r}")
    if len(val) != 7 or not all(map(math.isfinite, val.values())) or \
            meta["compute_dtype"] != "bfloat16":
        raise SystemExit("phase 8: the bf16 trainer's validation or run_meta failed")
    small_card_vs_cpu(dev, dict(hp), "WT_PSE", "phase 8 bf16 step and predict")
    log(f"phase 8 peak device memory (steps, trainer, small check): "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    return {"launches": {**t_launches, **t_bn}, "steps": steps}


def joint_path(cc, dev, tmp: str, p6: dict) -> None:
    """Phase 9: the joint variant. A full-width ``Trainer(algorithm=joint)`` at
    its default hparams for 3 epochs and one validation (no covariance
    launch), one epoch with ``whitening=True`` (4 launches of each f32 kernel a
    step), a small joint step and predict (whitening on, bf16) against the
    CPU, and the eval CLI and ``load_predictor`` on the joint checkpoint: the
    CLI's metrics must equal ``evaluate_domain`` on the reloaded nets."""
    from PIL import Image

    from wt_pse_tpu_torch.api import load_predictor
    from wt_pse_tpu_torch.cli import test_visualization as eval_cli
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.data.fundus import encode_masks, load_fundus
    from wt_pse_tpu_torch.io.checkpoint import save_ensemble
    from wt_pse_tpu_torch.train.eval import evaluate_domain, make_predict_fn_joint
    from wt_pse_tpu_torch.train.trainer import Trainer

    hp = default_hparams(JOINT)
    kw = dict(batch_size=9, interval_validate=1, label="OD", seed=1, eval_batch_size=8,
              val_visualization=False, device=dev, algorithm=JOINT)
    trainer = Trainer(hp, p6["train"], p6["val"], os.path.join(tmp, "joint"), max_epoch=3, **kw)
    torch.cuda.synchronize()
    zero_counts(cc)
    trainer.train()
    expect_counts(read_counts(cc), 0, 0, "phase 9 joint trainer")
    val, t_val = timed(trainer.validate)
    with open(os.path.join(tmp, "joint", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "loss_seg" in line]
    et = trainer.epoch_seconds
    log(f"phase 9 joint trainer (3 epochs x {trainer.iter_per_epoch} steps, default hparams: "
        f"whitening {hp['whitening']}): epochs " + ", ".join(f"{t:.3f}" for t in et) +
        f" s (steady median {statistics.median(et[1:]):.3f} s); host enqueue " +
        ", ".join(f"{t:.3f}" for t in trainer.enqueue_seconds) + f" s; validation "
        f"{t_val:.3f} s ({json.dumps(trainer.validation_seconds[-1])}): {json.dumps(val)}; "
        "epoch losses " + json.dumps([{k: r[k] for k in ("loss_seg", "loss_seg_oc")}
                                      for r in recs]))
    if len(recs) != 3 or any("loss_kd" in r for r in recs) or not all(
            math.isfinite(v) for r in recs for k, v in r.items() if k != "step"):
        raise SystemExit(f"phase 9: expected 3 finite joint epochs without KD, got {recs}")
    if len(val) != 7 or not all(map(math.isfinite, val.values())):
        raise SystemExit(f"phase 9: the joint validation is not finite: {val}")

    wt = Trainer(dict(hp, whitening=True), p6["train"], p6["val"],
                 os.path.join(tmp, "joint_wt"), max_epoch=1, **kw)
    torch.cuda.synchronize()
    zero_counts(cc)
    wt.train()
    wt_launches = read_counts(cc)
    log(f"phase 9 joint with whitening (1 epoch x {wt.iter_per_epoch} steps): "
        f"{wt.epoch_seconds[0]:.3f} s; launches {wt_launches}")
    expect_counts(wt_launches, 4 * wt.iter_per_epoch, 0, "phase 9 joint with whitening")
    small_card_vs_cpu(dev, dict(hp, whitening=True, compute_dtype="bfloat16"), JOINT,
                      "phase 9 joint step and predict (whitening on, bf16)")

    ckpt = os.path.join(tmp, "joint.pth.tar")
    save_ensemble(ckpt, trainer.state)
    root = os.path.join(tmp, "fundus")  # phase 7's test split at native 512 and 640
    argv = ["--device", dev.type, "--datasetTest", "3", "--label", "OD", "--data-dir", root,
            "--model-file", ckpt, "--out", os.path.join(tmp, "joint_vis"), "--batch-size", "8",
            "--algorithm", JOINT]
    zero_counts(cc)
    res, t_cli = timed(lambda: eval_cli.main(argv))
    expect_counts(read_counts(cc), 0, 0, "phase 9 eval CLI")
    nets = eval_cli.build_networks(ckpt, hp, algorithm=JOINT, device=dev)
    domain = load_fundus(root, "test", [3], state="prediction")
    masks = [encode_masks(np.asarray(lab, np.uint8)) for lab in domain.labels]
    direct = evaluate_domain(make_predict_fn_joint(nets[0], nets[2], device=dev),
                             torch.from_numpy(np.asarray(domain.images)).to(dev),
                             [m[0] for m in masks], [m[1] for m in masks], "OD", 8,
                             backend="native")
    imgs412 = np.stack([np.asarray(Image.fromarray(im).resize((412, 412), Image.BICUBIC))
                        for im in p6["val"].images])
    predictor = load_predictor(ckpt, algorithm=JOINT, device=dev)
    first = predictor(imgs412)
    steady = [timed(lambda: predictor(imgs412))[1] for _ in range(3)]
    ok = (first["od"].shape == first["oc"].shape == (len(imgs412), 412, 412)
          and np.isfinite(first["od_logits"]).all() and np.isfinite(first["oc_logits"]).all())
    log(f"phase 9 eval CLI on the joint checkpoint {t_cli:.3f} s: {json.dumps(res)}; "
        f"evaluate_domain on the reloaded nets equal: {res == direct}; load_predictor masks "
        f"{first['od'].shape}, finite {ok}, steady " + ", ".join(f"{t:.3f}" for t in steady) +
        " s")
    if res != direct or not ok:
        raise SystemExit("phase 9: the joint eval CLI or load_predictor check failed")


def _dp_trainer_rank(rank: int, tmp: str) -> dict:
    """Phase 10 (a), in a spawned rank of a world-1 NCCL group, on phase 6's
    pools: for f32 and bf16, a ``dp=True`` Trainer under each driver from one
    seed, the graph (the default) and the loop (``scan_epochs=False``): one
    epoch of both step by step (every batch, the first step's metrics),
    ``DP_EPOCHS`` epochs of each through ``train()`` with the launch counts
    set to 0 just before and read just after, and one more epoch of each
    traced; in f32 also one step against a ``dp=False`` Trainer's from the
    same state and draws, and a validation of the graph's nets."""
    import copy

    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.parallel.dp import rank_seed
    from wt_pse_tpu_torch.runtime import resolve_device
    from wt_pse_tpu_torch.train.trainer import Trainer

    dev = resolve_device(f"cuda:{torch.cuda.current_device()}")
    train, val = synthetic_pools()
    kw = dict(batch_size=9, interval_validate=99, label="OD", seed=1, eval_batch_size=8,
              val_visualization=False, device=dev, max_epoch=DP_EPOCHS)

    def build(name: str, hp: dict, **extra):
        t = Trainer(hp, train, val, os.path.join(tmp, f"dp_{name}"), **kw, **extra)
        with open(os.path.join(t.out, "run_meta.json")) as f:
            return t, json.load(f)

    def drive(t) -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(cc)
        t0 = time.perf_counter()
        t.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_counts(cc)
        with open(os.path.join(t.out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if "loss_seg" in line]
        rec = {"steps": DP_EPOCHS * t.iter_per_epoch, "launches": launches,
               "epoch_s": t.epoch_seconds, "enqueue_s": t.enqueue_seconds, "records": recs,
               "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "train_s": train_s}
        t0 = time.perf_counter()
        rec["profile"] = profile_epoch(t)
        rec["profile_s"] = time.perf_counter() - t0
        if t._graph is not None:
            rec.update(capture_s=t._graph.capture_seconds,
                       pool_gib=t._graph.pool_bytes / 2 ** 30,
                       launches_a_step={f"{n}.{a}": c for (n, a), c in
                                        t._graph.launches_per_step.items() if c})
        return rec

    hp32 = default_hparams("WT_PSE")
    out = {"drivers": {}, "seconds": {}}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        hp = dict(hp32, compute_dtype=dtype)
        g, meta = build(f"graph_{dtype}", hp, dp=True)
        loop, loop_meta = build(f"loop_{dtype}", hp, dp=True, scan_epochs=False)
        out["seconds"][f"{dtype} built"] = time.perf_counter() - t0
        if dtype == "float32":  # one step against dp=False, from the same state and draws
            single, _ = build("single", hp, dp=False, scan_epochs=False)
            out["step"] = {}
            for dp, t in ((False, single), (True, g)):
                gen = torch.Generator(device=dev).manual_seed(rank_seed(7, t.mesh))
                m = t._train_step(copy.deepcopy(t.state), t._batch_fn(t.data, gen),
                                  generator=gen)
                out["step"][dp] = {k: float(v) for k, v in m.items()}
            del single
            out.update(meta_dp=meta["dp"],
                       backend=torch.distributed.get_backend(g.mesh.group))
        t1 = time.perf_counter()
        rec = {"run_meta_driver": {"graph": meta["driver"], "loop": loop_meta["driver"]},
               "vs_loop": graph_vs_loop_epoch(g, loop)}
        out["seconds"][f"{dtype} vs loop"] = time.perf_counter() - t1
        rec.update(graph=drive(g), loop=drive(loop))
        if dtype == "float32":
            rec["val"], rec["val_s"] = timed(g.validate)
            rec["sharded"] = g._shard_eval
        out["drivers"][dtype] = rec
        out["seconds"][dtype] = time.perf_counter() - t0
        del g, loop
    return out


def _dp_step_rank(rank: int, tmp: str) -> dict:
    """Phase 10 (b), in one of two gloo ranks on the one card: for f32 and
    bf16, one DP step at 256x256 on this rank's half of a global batch of 12
    (3 domains x 4, shape prior and whitening on, the draws injected), its
    launch counts, a digest of its state and a second step timed; rank 0 then
    runs the single-process step on the global batch."""
    import hashlib

    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.parallel.dp import make_dp_fused
    from wt_pse_tpu_torch.parallel.mesh import data_mesh
    from wt_pse_tpu_torch.runtime import resolve_device
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

    dev = resolve_device("cuda:0")
    mesh = data_mesh()
    n_dom, pdb, hw = 3, 4, DP_STEP_HW
    local = pdb // mesh.size
    glob_batch = {k: torch.from_numpy(v).to(dev)
                  for k, v in synthetic_batch(n_dom, pdb, hw, seed=0).items()}
    r = np.random.RandomState(5)
    glob_eps = {k: torch.from_numpy(r.randn(n_dom * pdb, 1, hw, hw).astype(np.float32)).to(dev)
                for k in EPS_KEYS}
    # this rank's rows: local of each domain, in the order the MMD gather
    # re-interleaves them
    rows = torch.tensor([d * pdb + rank * local + i for d in range(n_dom) for i in range(local)],
                        device=dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        hp = dict(default_hparams("WT_PSE"), compute_dtype=dtype)
        state = init_ensemble(ModelConfig.from_hparams(hp, bn_mesh=mesh), device=dev,
                              generator=torch.Generator().manual_seed(2))
        step = make_dp_fused([ns.net for ns in state.net_states()], hp, mesh, n_dom, pdb,
                             device=dev)
        batch = {k: v[rows] for k, v in glob_batch.items()}
        eps = {k: v[rows] for k, v in glob_eps.items()}
        torch.cuda.synchronize()
        zero_counts(cc)
        metrics = {k: float(v) for k, v in step.train_step(state, batch, eps=eps).items()}
        torch.cuda.synchronize()
        launches = read_counts(cc)
        h = hashlib.sha256()
        for ns in state.net_states():  # parameters and BatchNorm statistics (f32)
            for name, t in ns.net.state_dict().items():
                h.update(name.encode() + t.cpu().numpy().tobytes())
        od_params = {k: v.detach().cpu().clone() for k, v in state.od.net.named_parameters()}
        _, t_step = timed(lambda: step.train_step(state, batch, eps=eps))
        res = {"metrics": metrics, "launches": launches, "digest": h.hexdigest(),
               "step_seconds": t_step}
        if rank == 0:
            single = init_ensemble(ModelConfig.from_hparams(hp), device=dev,
                                   generator=torch.Generator().manual_seed(2))
            want = make_train_step(StepConfig(hp, n_dom, pdb), device=dev)(
                single, glob_batch, eps=glob_eps)
            res["single"] = {k: float(v) for k, v in want.items()}
            diff = {k: (od_params[k] - v.detach().cpu()).abs()
                    for k, v in single.od.net.named_parameters()}
            flat = torch.cat([d.flatten() for d in diff.values()])
            # the first parameter against tests/test_parallel.py:236's bound
            # (rtol 1e-2, atol 5e-5): the largest error / bound
            w = od_params["inc.conv1.weight"].abs()
            res["od_param_diff"] = {
                "max": float(flat.max()), "mean": float(flat.mean()),
                "first_leaf_of_bound": float((diff["inc.conv1.weight"] / (5e-5 + 1e-2 * w)).max())}
        out[dtype] = res
    out["drivers"] = _gloo_drivers(dev, tmp, rank)
    return out


def _gloo_drivers(dev, tmp: str, rank: int) -> dict:
    """Phase 10 (b)'s driver resolution over gloo, on 64x64 pools of 3
    domains x 2 at batch 6 (one step an epoch): ``Trainer(dp=True,
    scan_epochs=True)`` raises ``ValueError`` (gloo's collectives cannot be
    captured), and ``scan_epochs=None`` takes the eager loop and trains an
    epoch."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.data.fundus import FundusDomain
    from wt_pse_tpu_torch.train.trainer import Trainer

    r = np.random.RandomState(8)
    doms = [FundusDomain(images=r.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
                         labels=r.choice([0, 128, 255], size=(2, 64, 64)).astype(np.uint8))
            for _ in range(3)]
    kw = dict(batch_size=6, max_epoch=1, interval_validate=99, val_visualization=False,
              device=dev, dp=True)
    out = {}
    try:
        Trainer(default_hparams("WT_PSE"), doms, doms[0], os.path.join(tmp, "gloo_true"),
                scan_epochs=True, **kw)
        out["scan_epochs_true"] = "built"
    except ValueError as e:
        out["scan_epochs_true"] = f"ValueError: {e}"
    t = Trainer(default_hparams("WT_PSE"), doms, doms[0], os.path.join(tmp, "gloo_none"), **kw)
    t.train()
    out.update(scan_epochs=t.scan_epochs, graph=t._graph is not None, step=t.state.step)
    if rank == 0:
        with open(os.path.join(t.out, "run_meta.json")) as f:
            out["run_meta_driver"] = json.load(f)["driver"]
    return out


FUNDUS_PREFIX = {1: "gd", 2: "g", 3: "G", 4: "V"}  # a file-name prefix each site uses


def write_sweep_split(root: str, seed: int = 21) -> None:
    """Phase 10 (c)'s synthetic Fundus tree, with PIL: Domain1-3 ``train`` of
    3 images and Domain4 ``test`` of 2, all 256x256, with 255/128/0 disc and
    cup masks at seeded centres."""
    from PIL import Image

    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:256]
    for dom, phase, n in ((1, "train", 3), (2, "train", 3), (3, "train", 3), (4, "test", 2)):
        d = os.path.join(root, f"Domain{dom}", phase, "ROIs")
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(n):
            cy, cx = r.uniform(90, 166, 2)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask = np.full((256, 256), 255, np.uint8)
            mask[d2 < 45 ** 2] = 128
            mask[d2 < 22 ** 2] = 0
            img = np.clip(r.rand(256, 256, 3) * 120 + 40 + 25 * dom + 50 * (mask < 255)[..., None],
                          0, 255).astype(np.uint8)
            name = f"{FUNDUS_PREFIX[dom]}_{i}.png"  # the loader keys pools by prefix
            Image.fromarray(img).save(os.path.join(d, "image", name))
            Image.fromarray(mask).save(os.path.join(d, "mask", name))


def dp_path(tmp: str) -> dict:
    """Phase 10: data parallelism and the sweep, each part in processes of its
    own, started here and stopped before the next part. Returns (a)'s records
    by dtype."""
    from wt_pse_tpu_torch.parallel.distributed import run_local_ranks

    # (a) the DP trainer, world 1 over NCCL, under both drivers
    t0 = time.perf_counter()
    (a,) = run_local_ranks(_dp_trainer_rank, 1, f"file://{tmp}/rdzv_a", (tmp,),
                           backend="nccl", timeout_s=DP_RANK_TIMEOUT_S)
    wall_a = time.perf_counter() - t0
    worst = max(abs(a["step"][True][k] - v) / (1e-5 + 2e-3 * abs(v))
                for k, v in a["step"][False].items())
    log(f"phase 10 (a) on {card_line()}: Trainer(dp=True), world 1 over {a['backend']} (the "
        f"MMD gather runs only at world > 1: not in this graph), 256x256, batch 9 = 3x3, "
        f"{DP_EPOCHS} epochs x 4 steps a driver; one step against dp=False, worst |error| / "
        f"(1e-5 + 2e-3 |want|) {worst:.3f}; run_meta dp {json.dumps(a['meta_dp'])}; seconds by dtype "
        f"{json.dumps(a['seconds'])}")
    for dtype, rec in a["drivers"].items():
        n_f32, n_bf16 = (8, 0) if dtype == "float32" else (0, 8)
        log(f"phase 10 (a) {dtype}: {json.dumps(rec)}")
        g, loop = rec["graph"], rec["loop"]
        log(f"phase 10 (a) {dtype} on {card_line()}: steady epoch, DP graph "
            f"{steady_epoch(g):.4f} s, DP loop {steady_epoch(loop):.4f} s "
            f"({steady_epoch(g) / steady_epoch(loop):.3f}x); card busy "
            f"{g['profile']['busy_share']:.1%} of a traced DP graph epoch, "
            f"{loop['profile']['busy_share']:.1%} of a DP loop epoch; host enqueue a DP graph "
            f"epoch " + ", ".join(f"{t:.3f}" for t in g["enqueue_s"]) + " s, a DP loop epoch " +
            ", ".join(f"{t:.3f}" for t in loop["enqueue_s"]) + f" s; capture "
            f"{g['capture_s']:.2f} s, the graph's pool {g['pool_gib']:.2f} GiB; peak allocated "
            f"{g['peak_allocated_gib']:.2f} GiB (graph), {loop['peak_allocated_gib']:.2f} GiB "
            f"(loop)")
        for driver, r in (("graph", g), ("loop", loop)):
            expect_counts(r["launches"], n_f32 * r["steps"], n_bf16 * r["steps"],
                          f"phase 10 (a) {dtype} {driver}")
            bad = [x["step"] for x in r["records"]
                   if not all(math.isfinite(v) for k, v in x.items() if k != "step")]
            if len(r["records"]) != DP_EPOCHS or bad:
                raise SystemExit(f"phase 10 (a) {dtype} {driver}: {len(r['records'])} epoch "
                                 f"records, non-finite at {bad}")
        key = "launches_bf16" if n_bf16 else "launches"
        # sync BatchNorm launches none of the port's kernels
        if g["launches_a_step"] != {f"covariance_forward.{key}": 8,
                                    f"covariance_backward.{key}": 8,
                                    f"upsample2x_forward.{key}": UP_FORWARDS_A_STEP,
                                    f"upsample2x_backward.{key}": UP_BACKWARDS_A_STEP}:
            raise SystemExit(f"phase 10 (a) {dtype}: the graph holds launches "
                             f"{g['launches_a_step']} a step, not 8 of each covariance kernel "
                             f"and {UP_FORWARDS_A_STEP} + {UP_BACKWARDS_A_STEP} upsamples")
        if rec["run_meta_driver"] != {"graph": "graph", "loop": "eager"}:
            raise SystemExit(f"phase 10 (a) {dtype}: run_meta records the drivers "
                             f"{rec['run_meta_driver']}")
        check = rec["vs_loop"]
        if not all(check["batches_bitwise_equal"]) or check["first_step"]["err_of_bound"] > 1.0:
            raise SystemExit(f"phase 10 (a) {dtype}: the DP graph and the DP loop disagree: "
                             f"{check}")
    f32 = a["drivers"]["float32"]
    log(f"phase 10 (a) validation of the DP graph's nets "
        f"({'batch-sharded' if f32['sharded'] else 'unsharded'}) {f32['val_s']:.3f} s: "
        f"{json.dumps(f32['val'])}; {wall_a:.1f} s with the rank's start")
    if worst > 1.0:
        raise SystemExit(f"phase 10 (a): step against dp=False {worst:.3f} of rtol 2e-3")
    if len(f32["val"]) != 7 or not all(map(math.isfinite, f32["val"].values())) or \
            not a["meta_dp"]["enabled"] or not f32["sharded"]:
        raise SystemExit(f"phase 10 (a): validation {f32['val']}, run_meta {a['meta_dp']}")

    # (b) two gloo ranks sharing the card
    t0 = time.perf_counter()
    b = run_local_ranks(_dp_step_rank, 2, f"file://{tmp}/rdzv_b", (tmp,), backend="gloo",
                        timeout_s=DP_RANK_TIMEOUT_S)
    wall_b = time.perf_counter() - t0
    for dtype in ("float32", "bfloat16"):
        r0, r1 = b[0][dtype], b[1][dtype]
        got, want = r0["metrics"], r0["single"]
        if dtype == "float32":  # tests/test_parallel.py:227-236
            bounds = {"loss_seg": (2e-3, 0.0), "loss_ins_wt": (5e-3, 0.0),
                      "loss_dom_wt": (5e-3, 1e-5)}
        else:
            bounds = dict.fromkeys(("loss_seg", "loss_ins_wt", "loss_dom_wt"), BF16_TOL)
        errs = {k: abs(got[k] - want[k]) / (atol + rtol * abs(want[k]))
                for k, (rtol, atol) in bounds.items()}
        n_f32, n_bf16 = (8, 0) if dtype == "float32" else (0, 8)
        log(f"phase 10 (b) {dtype}: 2 gloo ranks on one card, one DP step at 256x256, global "
            f"batch 12 = 3x4: metrics {json.dumps(got)}; single process on the global batch "
            f"{json.dumps(want)}; error / bound {json.dumps(errs)}; OD parameters against the "
            f"single process {json.dumps(r0['od_param_diff'])}; launches rank 0 "
            f"{r0['launches']}, rank 1 {r1['launches']}; ranks' states bitwise equal: "
            f"{r0['digest'] == r1['digest']}; a second step {r0['step_seconds'] * 1e3:.1f} / "
            f"{r1['step_seconds'] * 1e3:.1f} ms (host-staged gloo over one shared card, not an "
            f"NCCL figure)")
        for rank, res in enumerate((r0, r1)):
            expect_counts(res["launches"], n_f32, n_bf16, f"phase 10 (b) {dtype} rank {rank}")
        if max(errs.values()) > 1.0 or r0["digest"] != r1["digest"] or \
                r0["od_param_diff"]["max"] > 2.2 * 5e-4:
            raise SystemExit(f"phase 10 (b) {dtype}: the DP step disagrees with the single "
                             "process, or the ranks' states differ")
    drivers = [res["drivers"] for res in b]
    log(f"phase 10 (b) the Trainer's driver over gloo, by rank: {json.dumps(drivers)}")
    if not all(d["scan_epochs_true"].startswith("ValueError") and "gloo" in
               d["scan_epochs_true"] and d["scan_epochs"] is False and not d["graph"] and
               d["step"] == 1 for d in drivers) or drivers[0]["run_meta_driver"] != "eager":
        raise SystemExit(f"phase 10 (b): over gloo, scan_epochs=True must raise and None "
                         f"must train under the loop: {drivers}")
    log(f"phase 10 (b): {wall_b:.1f} s with the ranks' start")

    # (c) the sweep CLI, 2 jobs on the card
    root, out = os.path.join(tmp, "sweep_data"), os.path.join(tmp, "sweep")
    write_sweep_split(root)
    cmd = [sys.executable, "-m", "wt_pse_tpu_torch.cli.sweep", "--data-dir", root,
           "--targets", "4", "--labels", "OD", "OC", "--batch-size", "9", "--max-epoch", "4",
           "--stop-epoch", "4", "--interval-validate", "4", "--running_times", "1",
           "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_RANK_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_c = time.perf_counter() - t0
    summary = proc.stdout[proc.stdout.find("sweep summary"):].strip().splitlines()
    results = {}
    if os.path.exists(os.path.join(out, "sweep_results.json")):
        with open(os.path.join(out, "sweep_results.json")) as f:
            results = json.load(f)
    log(f"phase 10 (c) the sweep CLI (target 4, OD and OC, 4 epochs of 1 step, a validation "
        f"each): exit {proc.returncode} in {wall_c:.1f} s; sweep_results.json {json.dumps(results)}"
        f"; summary {summary}")
    if proc.returncode != 0 or set(results) != {"target4_OD", "target4_OC"} or \
            len(summary) != 3:
        raise SystemExit(f"phase 10 (c): the sweep CLI failed:\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return a["drivers"]


def spatial_nets(dev, lift: float = 0.0):
    """Phase 11 (a)'s WT_PSE nets at full width from a seed, the OD head's
    logits scaled by ``SPATIAL_OD_GAIN`` and shifted by ``lift``."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.state import init_ensemble

    state = init_ensemble(ModelConfig.from_hparams(default_hparams("WT_PSE")), device=dev,
                          generator=torch.Generator().manual_seed(8))
    nets = [ns.net for ns in state.net_states()]
    with torch.no_grad():
        nets[0].outc[0].weight *= SPATIAL_OD_GAIN
        nets[0].outc[0].bias.mul_(SPATIAL_OD_GAIN).add_(lift)
    return nets


def median_lift(nets, image, dev) -> float:
    """The shift that puts the median OD logit of ``image`` just above the
    0.75 threshold (by 0.01: no logit is put on it), so that about half of
    the image is ROI."""
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    od, _ = make_predict_fn(*nets, device=dev)(image)
    return math.log(3.0) - float(od.median()) + 0.01


def spatial_image(dev, h: int = SPATIAL_HW) -> torch.Tensor:
    """(2, 3, h, SPATIAL_HW) in [-1, 1]: noise over a bright disc."""
    r = np.random.RandomState(12)
    yy, xx = np.mgrid[0:h, 0:SPATIAL_HW]
    disc = ((yy - 500) ** 2 + (xx - 540) ** 2 < 300 ** 2).astype(np.float32)
    img = r.rand(2, 3, h, SPATIAL_HW).astype(np.float32) * 1.4 - 1 + 0.6 * disc
    return torch.from_numpy(img).to(dev)


def time_predicts(predict, image, n: int = 3) -> tuple:
    """A warm-up call (cuDNN picks its algorithms for the shapes), then ``n``
    timed calls: (the last outputs, their host seconds, each ended by a
    synchronize)."""
    predict(image)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        out, t = timed(lambda: predict(image))
        times.append(t)
    return out, times


def profile_predict(predict, image) -> dict:
    """One traced predict: each card's busy ms, the window from the first
    device event to the last, and the three kernels that took the most
    device time over all cards."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(image)
        torch.cuda.synchronize()
    busy, window, by_name, _ = device_time(prof, by_card=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"busy_ms": {f"cuda:{k}": round(us / 1e3, 2) for k, us in busy.items()},
            "window_ms": round(window / 1e3, 2),
            "top": [(name[:70], round(us / 1e3, 2)) for name, us in top]}


def _spatial_rank(rank: int, lift: float, sharded: bool) -> dict:
    """Phase 11 (a), in a process of its own on the card: the two-stage
    predict, ``spatial_sharded`` over the world's gloo ranks or (``sharded``
    False, a world of 1) unsharded. Its outputs (rank 0) or their digest, the
    halo exchanges and covariance launches of one predict, the predict's
    times and a profile of one."""
    import hashlib

    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.parallel.collectives import halo_rows
    from wt_pse_tpu_torch.parallel.mesh import data_mesh
    from wt_pse_tpu_torch.parallel.spatial import spatial_sharded
    from wt_pse_tpu_torch.runtime import resolve_device
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    dev = resolve_device("cuda:0")
    predict = make_predict_fn(*spatial_nets(dev, lift), device=dev)
    if sharded:
        predict = spatial_sharded(predict, data_mesh())
    image = spatial_image(dev)
    predict(image)
    torch.cuda.synchronize()
    zero_counts(cc)
    before = halo_rows.exchanges
    predict(image)
    torch.cuda.synchronize()
    exchanges, launches = halo_rows.exchanges - before, read_counts(cc)
    (od, oc), times = time_predicts(predict, image)
    od, oc = od.cpu().numpy(), oc.cpu().numpy()
    return {"od": od if rank == 0 else None, "oc": oc if rank == 0 else None,
            "digest": hashlib.sha256(od.tobytes() + oc.tobytes()).hexdigest(),
            "exchanges": exchanges, "launches": launches, "seconds": times,
            "profile": profile_predict(predict, image)}


def hold_two_stage(got_od, got_oc, want_od, want_oc) -> dict:
    """NCHW OD logits against ``want`` (worst |error| / class conv's bound),
    the OD pixels on the other side of sigmoid 0.75 (the predict's own f32
    test), and OC farther than ``OC_REACH`` from any such pixel (a flip
    changes the ROI that the OC stage reads around it), as
    ``tests/test_torch_spatial.py`` holds them."""
    rtol, atol = CONV

    def mask(od):
        return (torch.sigmoid(torch.tensor(np.asarray(od, np.float32))) > 0.75).numpy()

    got_m, want_m = mask(got_od), mask(want_od)
    got_od, got_oc, want_od, want_oc = (np.asarray(a, np.float64)
                                        for a in (got_od, got_oc, want_od, want_oc))
    flips = got_m != want_m
    near = np.zeros_like(flips)
    for b, c, y, x in np.argwhere(flips):
        near[b, c, max(0, y - OC_REACH):y + OC_REACH + 1, max(0, x - OC_REACH):x + OC_REACH + 1] = 1
    od_err = float(np.abs(got_od - want_od).max() / (atol + rtol * np.abs(want_od).max()))
    oc_err = float(np.abs(np.where(near, 0.0, got_oc - want_oc)).max()
                   / (atol + rtol * np.abs(want_oc).max()))
    return {"od_err_of_bound": od_err, "oc_err_of_bound": oc_err,
            "flipped": int(flips.sum()), "pixels": int(flips.size),
            "oc_left_out": float(near.mean()), "roi_share": float(want_m.mean())}


def extras_cases(hw: int = EXTRAS_HW, seed: int = 21) -> dict:
    """Phase 11 (b): every op of ``data/augment_extras.py`` on inputs and
    draws made on the CPU from a seed, each gate drawn so the op applies.
    ``name -> (fn(device) -> tuple of outputs, how to hold each output)``:
    ``'exact'``, ``'f32'`` (class f32_reduce, normwise), ``'conv'`` (class
    conv, normwise) or ``'floor'`` (a floored power curve: pixels within 1 of
    each other, counted). The images of the elastic transform and the
    rotation are held at class conv: each moves its samples by coordinates
    that carry a rounding of their own on each device, multiplied on the way
    to the output by the image's gradient: the elastic transform's blurred
    field (held at f32_reduce on its own, as ``_gaussian_blur_2d``) times
    alpha = 2 H pixels, and the rotation's cos and sin (an ulp apart between
    CUDA's and the CPU's libraries) times up to H / 2 pixels."""
    from wt_pse_tpu_torch.data import augment_extras as X

    g = torch.Generator().manual_seed(seed)
    r = np.random.RandomState(seed)
    u = lambda *shape: torch.rand(shape, generator=g)
    img = torch.from_numpy(np.floor(r.rand(hw, hw, 3) * 256).astype(np.float32))
    unit = img / 255.0  # on the CPU: the card divides by a scalar otherwise
    mask = torch.from_numpy((r.rand(hw, hw) > 0.5).astype(np.float32))
    yy, xx = np.mgrid[0:hw, 0:hw]
    two = np.stack([(yy - hw / 2) ** 2 + (xx - hw / 2) ** 2 < (hw / 8) ** 2,
                    (yy - hw / 2) ** 2 + (xx - hw / 2) ** 2 < (hw / 4) ** 2], -1)
    two = torch.from_numpy(two.astype(np.float32))
    gray = torch.from_numpy(r.choice([0, 30, 128, 200, 255], (hw, hw)).astype(np.uint8))
    draws = {
        "salt_pepper_noise": (torch.tensor(0.9), u(hw, hw)),
        "adjust_light": (torch.tensor(0.9), u()),
        "random_eraser": (torch.tensor(0.9), u(), u(), torch.randint(0, hw, (), generator=g),
                          torch.randint(0, hw, (), generator=g), u()),
        "elastic_transform": (torch.tensor(0.9), u(hw, hw), u(hw, hw)),
        "random_flip": torch.tensor(0.1),
        "random_rotate": u(),
        "random_sized_crop": tuple(u() for _ in range(5)),
        "soft_label": (u(), u(3)),
    }

    def on(dev, x):
        return tuple(on(dev, t) for t in x) if isinstance(x, tuple) else x.to(dev)

    def op(name, call):
        return lambda dev: call(on(dev, img), on(dev, mask), on(dev, draws.get(name)), dev)

    return {
        "salt_pepper_noise": (op("salt_pepper_noise", lambda i, m, d, dev: (
            X.salt_pepper_noise(unit.to(dev), 0.05, draws=d),)), ("exact",)),
        "adjust_light": (op("adjust_light", lambda i, m, d, dev: (
            X.adjust_light(i, draws=d),)), ("floor",)),
        "random_eraser": (op("random_eraser", lambda i, m, d, dev: (
            X.random_eraser(i, draws=d),)), ("exact",)),
        "_gaussian_blur_2d": (lambda dev: (X._gaussian_blur_2d(
            draws["elastic_transform"][1].to(dev) * 2 - 1, 0.08 * hw),), ("f32",)),
        "elastic_transform": (op("elastic_transform", lambda i, m, d, dev: X.elastic_transform(
            i, m, draws=d)), ("conv", "conv")),
        "random_flip": (op("random_flip", lambda i, m, d, dev: X.random_flip(
            i, m, draws=d)), ("exact", "exact")),
        "random_rotate": (op("random_rotate", lambda i, m, d, dev: X.random_rotate(
            i, m, draws=d)), ("conv", "exact")),
        "random_sized_crop": (op("random_sized_crop", lambda i, m, d, dev: X.random_sized_crop(
            i, m, hw, draws=d)), ("f32", "exact")),
        "get_boundary": (lambda dev: (X.get_boundary(two.to(dev)),), ("exact",)),
        "normalize_single_label": (lambda dev: X.normalize_single_label(
            img.to(dev), gray.to(dev), "OD"), ("f32", "exact")),
        "center_crop": (lambda dev: (X.center_crop(img.to(dev), hw // 2),), ("exact",)),
        "soft_label": (lambda dev: (X.soft_label(torch.eye(3)[1].to(dev), draws=on(
            dev, draws["soft_label"])),), ("f32",)),
        "fixed_resize": (lambda dev: (X.fixed_resize(img.to(dev), 2 * hw),), ("f32",)),
        "normalize_mean_std": (lambda dev: (X.normalize_mean_std(
            img.to(dev), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),), ("f32",)),
        "normalize_cityscapes": (lambda dev: (X.normalize_cityscapes(
            img.to(dev), (73.2, 82.9, 72.4)),), ("f32",)),
    }


def hold_extras(got: tuple, want: tuple, kinds: tuple) -> dict:
    """Each output of an op on the card against the CPU's, held as ``kinds``
    says (``extras_cases``); returns the worst error / bound of the f32
    outputs, the differing elements of the exact ones and the floor ties."""
    res = {"f32_err_of_bound": 0.0, "conv_err_of_bound": 0.0, "exact_diffs": 0,
           "floor_ties": 0, "floor_max": 0.0}
    for a, b, kind in zip(got, want, kinds):
        a, b = a.cpu().double(), b.double()
        if a.shape != b.shape:
            raise SystemExit(f"phase 11 (b): shape {tuple(a.shape)} against {tuple(b.shape)}")
        if kind in ("f32", "conv"):
            rtol, atol = (F32_REDUCE_RTOL, 1e-9) if kind == "f32" else CONV
            key = f"{kind}_err_of_bound"
            res[key] = max(res[key], float((a - b).abs().max()) / (atol + rtol * float(b.abs().max())))
        elif kind == "exact":
            res["exact_diffs"] += int((a != b).sum())
        else:
            res["floor_ties"] += int((a != b).sum())
            res["floor_max"] = max(res["floor_max"], float((a - b).abs().max()))
    return res


def spatial_path(cc, dev, tmp: str) -> dict:
    """Phase 11: (a) H-axis sharded two-stage predict at 1024x1024 on 2 and 4
    gloo ranks sharing the card, against the single-process predict on the
    card; (b) the transform library on the card against the CPU; (c)
    ``InstanceWhitening`` on the card against the CPU."""
    from wt_pse_tpu_torch.models.layers import InstanceWhitening
    from wt_pse_tpu_torch.parallel.distributed import run_local_ranks
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    # (a) the single process (here, against the CPU, and in a fresh process),
    # then each world, each rank a process of its own
    nets = spatial_nets(dev)
    image = spatial_image(dev)
    lift = median_lift(nets, image, dev)
    with torch.no_grad():
        nets[0].outc[0].bias += lift
    predict = make_predict_fn(*nets, device=dev)
    zero_counts(cc)
    (want_od, want_oc), t_single = time_predicts(predict, image)
    expect_counts(read_counts(cc), 0, 0, "phase 11 (a) single-process predict")
    want_od, want_oc = want_od.cpu().numpy(), want_oc.cpu().numpy()
    t0 = time.perf_counter()
    cpu_od, cpu_oc = make_predict_fn(*spatial_nets("cpu", lift), device="cpu")(image.cpu())
    t_cpu = time.perf_counter() - t0
    vs_cpu = hold_two_stage(want_od, want_oc, cpu_od.numpy(), cpu_oc.numpy())
    log(f"phase 11 (a) single-process two-stage predict, WT_PSE f32, batch 2 at "
        f"{SPATIAL_HW}x{SPATIAL_HW} (OD head shifted by {lift:.4f}): " +
        ", ".join(f"{t * 1e3:.1f}" for t in t_single) + f" ms; profile "
        f"{json.dumps(profile_predict(predict, image))}; against the same predict on the "
        f"CPU ({t_cpu:.1f} s) {json.dumps(vs_cpu)}")
    if vs_cpu["od_err_of_bound"] > 1.0 or vs_cpu["oc_err_of_bound"] > 1.0 or \
            vs_cpu["flipped"] > 1e-4 * vs_cpu["pixels"]:
        raise SystemExit("phase 11 (a): the megapixel predict on the card disagrees with the CPU")
    (fresh,) = run_local_ranks(_spatial_rank, 1, f"file://{tmp}/rdzv_s1", (lift, False),
                               backend="gloo", timeout_s=DP_RANK_TIMEOUT_S)
    log(f"phase 11 (a) the same predict in a fresh process: " +
        ", ".join(f"{t * 1e3:.1f}" for t in fresh["seconds"]) + f" ms, bitwise equal to this "
        f"process's: {np.array_equal(fresh['od'], want_od) and np.array_equal(fresh['oc'], want_oc)}"
        f"; profile {json.dumps(fresh['profile'])}")
    out = {"single_ms": [t * 1e3 for t in t_single], "fresh_ms": fresh["seconds"],
           "vs_cpu": vs_cpu}
    for world in SPATIAL_WORLDS:
        t0 = time.perf_counter()
        ranks = run_local_ranks(_spatial_rank, world, f"file://{tmp}/rdzv_s{world}",
                                (lift, True), backend="gloo", timeout_s=DP_RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        held = hold_two_stage(ranks[0]["od"], ranks[0]["oc"], want_od, want_oc)
        same = all(r["digest"] == ranks[0]["digest"] for r in ranks)
        log(f"phase 11 (a) spatial_sharded over {world} gloo ranks on one card "
            f"({SPATIAL_HW // world} rows a rank): against the single process {json.dumps(held)}; "
            f"every rank holds the same outputs: {same}; halo exchanges a predict "
            f"{[r['exchanges'] for r in ranks]}; covariance launches "
            f"{[sum(r['launches'].values()) for r in ranks]}; predict ms by rank " +
            "; ".join(", ".join(f"{t * 1e3:.1f}" for t in r["seconds"]) for r in ranks) +
            f" (host-staged gloo exchanges on one shared card); rank 0's profile "
            f"{json.dumps(ranks[0]['profile'])}; {wall:.1f} s with the ranks' start")
        for r in ranks:
            expect_counts(r["launches"], 0, 0, f"phase 11 (a) {world} ranks")
        if held["od_err_of_bound"] > 1.0 or held["oc_err_of_bound"] > 1.0 or not same or \
                held["flipped"] > 1e-4 * held["pixels"] or \
                len({r["exchanges"] for r in ranks}) != 1 or ranks[0]["exchanges"] == 0:
            raise SystemExit(f"phase 11 (a): the sharded predict over {world} ranks disagrees "
                             "with the single process")
        out[f"ranks_{world}"] = {**held, "exchanges": ranks[0]["exchanges"],
                                 "seconds": [r["seconds"] for r in ranks]}

    # (b) the transform library, the same draws on the card and on the CPU
    zero_counts(cc)
    worst = {"f32_err_of_bound": 0.0, "conv_err_of_bound": 0.0, "exact_diffs": 0,
             "floor_ties": 0, "floor_max": 0.0}
    times = {}
    for name, (fn, kinds) in extras_cases().items():
        want = fn("cpu")
        got = fn(dev)
        torch.cuda.synchronize()
        res = hold_extras(got, want, kinds)
        runs = [timed(lambda: fn(dev))[1] for _ in range(20)]
        times[name] = statistics.median(runs) * 1e3
        for k in ("f32_err_of_bound", "conv_err_of_bound", "floor_max"):
            worst[k] = max(worst[k], res[k])
        for k in ("exact_diffs", "floor_ties"):
            worst[k] += res[k]
        if res["f32_err_of_bound"] > 1.0 or res["conv_err_of_bound"] > 1.0 or \
                res["exact_diffs"] or res["floor_max"] > 1.0 or \
                res["floor_ties"] > 1e-3 * EXTRAS_HW * EXTRAS_HW * 3:
            raise SystemExit(f"phase 11 (b) {name}: the card disagrees with the CPU: {res}")
    expect_counts(read_counts(cc), 0, 0, "phase 11 (b)")
    log(f"phase 11 (b) the transform library at {EXTRAS_HW}x{EXTRAS_HW} on the card against the "
        f"CPU, the same draws (14 ops and the elastic transform's blur; to_multilabel and "
        f"domain_code_one_hot are host helpers): "
        f"worst {json.dumps(worst)}; median ms a call (inputs moved to the card, ended by a "
        f"synchronize) {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    out["extras"] = {**worst, "ms": times}

    # (c) InstanceWhitening
    x = torch.from_numpy(np.random.RandomState(23).randn(*MAIN_SHAPE).astype(np.float32) * 3 + 1)
    want = InstanceWhitening()(x)
    got = InstanceWhitening()(x.to(dev)).cpu()
    err = float((got - want).abs().max()) / (1e-9 + F32_REDUCE_RTOL * float(want.abs().max()))
    log(f"phase 11 (c) InstanceWhitening on {tuple(MAIN_SHAPE)} on the card against the CPU: "
        f"worst |error| / f32_reduce bound {err:.3f}")
    if err > 1.0:
        raise SystemExit("phase 11 (c): InstanceWhitening on the card disagrees with the CPU")
    out["instance_whitening_err_of_bound"] = err
    return out


class ShardFailure(RuntimeError):
    """Phase 14 (a): the exception of the shard made to fail."""


def _fail_at_fifth_conv(module, args):
    raise ShardFailure("shard 1 made to fail at its fifth 3x3 conv")


def shard_threads() -> list:
    """The live shard threads of the in-process meshes' pools."""
    from wt_pse_tpu_torch.parallel.spatial import SHARD_THREAD

    return [t for t in threading.enumerate() if t.name.startswith(SHARD_THREAD)]


def local_mesh_path(cc, dev, p11: dict | None) -> dict:
    """Phase 14: the sharded predicts over a mesh of this one process's
    devices (``data_mesh(devices=...)``, one thread a shard) on phase 11
    (a)'s nets and image (WT_PSE at full width, f32, batch 2 at 1024x1024):
    (a) on every machine, ``spatial_sharded`` over the first card as one
    shard and as two, and at H = ``SHARDED_H`` over 2 and 4 shards of it,
    and ``batch_sharded`` of ``SHARDED_BATCH`` over 2, each against the
    single-process predict in this process at phase 11 (a)'s bounds, with
    the halo exchanges of a predict (phase 11 (a)'s), no covariance launch
    and the median times; a shard made to fail ends the call with its own exception within
    ``SHARD_FAIL_S`` and leaves no shard thread, nor does a closed wrapper;
    (b) where more cards are
    visible, the same over every card, with times against one card and
    against phase 11 (a)'s gloo ranks."""
    from wt_pse_tpu_torch.models.layers import Conv2d
    from wt_pse_tpu_torch.parallel.collectives import halo_rows
    from wt_pse_tpu_torch.parallel.mesh import data_mesh
    from wt_pse_tpu_torch.parallel.spatial import batch_sharded, nets_on, spatial_sharded
    from wt_pse_tpu_torch.train.eval import make_predict_fn

    nets = spatial_nets(dev)
    images = {"square": spatial_image(dev), "tall": spatial_image(dev, SHARDED_H)}
    b, hw = SHARDED_BATCH
    images["chunk"] = torch.from_numpy(
        np.random.RandomState(14).rand(b, 3, hw, hw).astype(np.float32) * 2 - 1).to(dev)
    lift = median_lift(nets, images["square"], dev)
    with torch.no_grad():
        nets[0].outc[0].bias += lift
    single = make_predict_fn(*nets, device=dev)
    wants, single_ms = {}, {}
    zero_counts(cc)
    for key, img in images.items():
        out, times = time_predicts(single, img, n=3 if key == "square" else 2)
        wants[key] = [o.cpu().numpy() for o in out]
        single_ms[key] = statistics.median(times) * 1e3
    expect_counts(read_counts(cc), 0, 0, "phase 14 single-process predicts")
    log(f"phase 14 single-process predict on {card_line()}, median ms: {json.dumps(single_ms)} "
        f"(square: 2 x {SPATIAL_HW}x{SPATIAL_HW}; tall: 2 x {SHARDED_H}x{SPATIAL_HW}; chunk: "
        f"{b} x {hw}x{hw})")
    want_x = p11["ranks_2"]["exchanges"] if p11 else None

    def predict_for(d):
        return make_predict_fn(*nets_on(nets, d), device=d)

    def run(what: str, wrap, devices: list, key: str) -> dict:
        nonlocal want_x
        mesh = data_mesh(devices=devices)
        predict = wrap(predict_for, mesh)
        zero_counts(cc)
        before = halo_rows.exchanges
        (od, oc), _ = timed(lambda: predict(images[key]))  # cuDNN picks for each slab
        exchanges, launches = halo_rows.exchanges - before, read_counts(cc)
        times = [timed(lambda: predict(images[key]))[1] * 1e3
                 for _ in range(3 if key == "square" else 2)]
        held = hold_two_stage(od.cpu().numpy(), oc.cpu().numpy(), *wants[key])
        sharded = wrap is spatial_sharded
        if sharded and want_x is None:
            want_x = exchanges
        rec = {**held, "exchanges": exchanges, "ms": times, "median_ms": statistics.median(times),
               "single_ms": single_ms[key], "profile": profile_predict(predict, images[key])}
        predict.close()
        log(f"phase 14 {what}: {json.dumps(rec)}; covariance launches {launches}")
        expect_counts(launches, 0, 0, f"phase 14 {what}")
        if held["od_err_of_bound"] > 1.0 or held["oc_err_of_bound"] > 1.0 or \
                held["flipped"] > 1e-4 * held["pixels"] or od.device != mesh.devices[0] or \
                exchanges != (want_x if sharded else 0):
            raise SystemExit(f"phase 14 {what}: disagrees with the single-process predict, or "
                             f"made {exchanges} halo exchanges (want {want_x if sharded else 0})")
        return rec

    out = {}
    for name, wrap, devices, key in (
            ("(a) spatial_sharded over [card 0]", spatial_sharded, [dev], "square"),
            ("(a) spatial_sharded over [card 0, card 0]", spatial_sharded, [dev] * 2, "square"),
            (f"(a) spatial_sharded at H = {SHARDED_H} over 2 shards of card 0", spatial_sharded,
             [dev] * 2, "tall"),
            (f"(a) spatial_sharded at H = {SHARDED_H} over 4 shards of card 0", spatial_sharded,
             [dev] * 4, "tall"),
            (f"(a) batch_sharded of {b} over 2 shards of card 0", batch_sharded, [dev] * 2,
             "chunk")):
        out[name] = run(name, wrap, devices, key)

    if shard_threads():
        raise SystemExit(f"phase 14 (a): shard threads outlive their closed wrappers: "
                         f"{shard_threads()}")

    # a shard made to fail, at its OD net's fifth 3x3 conv
    made = []

    def failing_for(d):
        copies = nets_on(nets, d)
        if len(made) == 1:
            convs = [m for m in copies[0].modules()
                     if isinstance(m, Conv2d) and m.kernel_size == (3, 3)]
            convs[4].register_forward_pre_hook(_fail_at_fifth_conv)
        made.append(d)
        return make_predict_fn(*copies, device=d)

    failing = spatial_sharded(failing_for, data_mesh(devices=[dev] * 2))
    t0 = time.perf_counter()
    try:
        failing(images["square"][:, :, :256, :256])
        raised = None
    except ShardFailure as e:
        raised = e
    t_fail = time.perf_counter() - t0
    left = shard_threads()
    log(f"phase 14 (a) a shard made to fail: raised {raised!r} in {t_fail:.3f} s "
        f"(bound {SHARD_FAIL_S} s); shard threads left {len(left)}")
    if raised is None or t_fail > SHARD_FAIL_S or left:
        raise SystemExit("phase 14 (a): the failing shard did not end the call with its own "
                         "exception in time, or left threads")
    out["fail_s"] = t_fail

    # (b) every visible card
    n = torch.cuda.device_count()
    if n < 2:
        log(f"phase 14 (b) did not run: {n} card visible (it needs two or more)")
        return out
    cards = [torch.device("cuda", i) for i in range(n)]
    log(f"phase 14 (b) peer access between the cards: " + json.dumps(
        {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
         for i in range(n) for j in range(n) if i != j}))
    for name, wrap, key in ((f"(b) spatial_sharded over {n} cards", spatial_sharded, "square"),
                            (f"(b) spatial_sharded at H = {SHARDED_H} over {n} cards",
                             spatial_sharded, "tall"),
                            (f"(b) batch_sharded of {b} over {n} cards", batch_sharded, "chunk")):
        out[name] = run(name, wrap, cards, key)
    one = out["(a) spatial_sharded over [card 0]"]["median_ms"]
    many = out[f"(b) spatial_sharded over {n} cards"]["median_ms"]
    gloo = {f"{w} gloo ranks": statistics.median(p11[f"ranks_{w}"]["seconds"][0]) * 1e3
            for w in SPATIAL_WORLDS} if p11 else "phase 11 did not run"
    log(f"phase 14 (b) on {card_line()}: 2 x {SPATIAL_HW}x{SPATIAL_HW} over {n} cards in one "
        f"process {many:.1f} ms against one card {one:.1f} ms as one shard and "
        f"{single_ms['square']:.1f} ms unsharded ({one / many:.2f}x, {single_ms['square'] / many:.2f}x); "
        f"phase 11 (a)'s ranks sharing one card, rank 0's median ms: "
        f"{json.dumps(gloo) if isinstance(gloo, dict) else gloo}")
    return out


def steady_epoch(rec: dict) -> float:
    """The median of a driver's epoch times after the first."""
    return statistics.median(rec["epoch_s"][1:])


def metric_errors(got: dict, want: dict, bf16: bool) -> dict:
    """One step's metrics (one-element tensors) against another's: the worst
    |got - want| / (atol + rtol |want|) at each metric's bound (the
    scan-vs-loop bound; class bf16 for ``POST_UPDATE`` in bf16) and its
    metric, and the worst of ``POST_UPDATE`` at the scan-vs-loop bound."""
    if set(got) != set(want):
        raise SystemExit(f"the drivers report other metrics: {sorted(got)} / {sorted(want)}")
    held, scan = {}, {}
    for k, v in want.items():
        a, b = float(got[k].reshape(-1)[0]), float(v.reshape(-1)[0])
        scan[k] = abs(a - b) / (SCAN_ATOL + SCAN_RTOL * abs(b))
        rtol, atol = BF16_TOL if bf16 and k in POST_UPDATE else (SCAN_RTOL, SCAN_ATOL)
        held[k] = abs(a - b) / (atol + rtol * abs(b))
    worst = max(held, key=held.get)
    kd = [scan[k] for k in POST_UPDATE if k in scan]
    return {"err_of_bound": held[worst], "worst_metric": worst,
            "kd_err_of_scan_bound": max(kd) if kd else None}


def max_param_diff(a, b) -> float:
    """The largest |a - b| over the parameters of two training states."""
    return max(float((p - q).abs().max()) for x, y in zip(a.net_states(), b.net_states())
               for p, q in zip(x.net.parameters(), y.net.parameters()))


def graph_vs_eager_step(dev, hp: dict, algorithm: str, hw: int = 256) -> dict:
    """One step from one seeded state (batch 9 = 3x3 at ``hw``, a fixed
    batch and injected draws through the static buffers) graphed against the
    same step run eagerly, both with the capturable Adam, and a second eager
    run beside the first. Returns the worst metric error of graph against
    eager (1.0 = the scan-vs-loop bound), its metric, the largest parameter
    difference of each pair, the capture's launches a step and seconds."""
    from wt_pse_tpu_torch.models.common import ModelConfig
    from wt_pse_tpu_torch.train.graph import GraphedStep
    from wt_pse_tpu_torch.train.state import init_ensemble
    from wt_pse_tpu_torch.train.step import EPS_KEYS, StepConfig, make_train_step

    cfg = ModelConfig.from_hparams(hp)
    step = make_train_step(StepConfig(hp, 3, 3, distill=algorithm != JOINT), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(3, 3, hw, 4).items()}
    r = np.random.RandomState(5)
    eps = {k: torch.from_numpy(r.randn(9, 1, hw, hw).astype(np.float32)).to(dev)
           for k in EPS_KEYS}
    bf16 = hp.get("compute_dtype") == "bfloat16"
    runs = []
    for _ in range(3):  # graph, eager, eager
        state = init_ensemble(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                              algorithm=algorithm, capturable=True)
        gs = GraphedStep(state, step, batch, capacity=1, eps_keys=EPS_KEYS)
        for k, v in batch.items():
            gs.batch[k].copy_(v)
        for k, v in eps.items():
            gs.eps[k].copy_(v)
        runs.append(gs)
    graph, eager, again = runs
    graph.capture()
    got = graph.replay(1)
    for gs in (eager, again):
        gs.body()
    torch.cuda.synchronize()
    return {"graph_vs_eager": metric_errors(got, eager.read(1), bf16),
            "eager_vs_eager": metric_errors(again.read(1), eager.read(1), bf16),
            "param_diff_graph_eager": max_param_diff(graph.state, eager.state),
            "param_diff_eager_eager": max_param_diff(eager.state, again.state),
            "launches_a_step": {f"{n}.{a}": c for (n, a), c in
                                graph.launches_per_step.items() if c},
            "capture_s": graph.capture_seconds}


def graph_vs_loop_epoch(graph_trainer, loop_trainer) -> dict:
    """One epoch of a graphed and an eager-loop Trainer from the same seed,
    step by step: every step's batch bitwise equal between the two, and the
    first step's metrics against the scan-vs-loop bound."""
    for t in (graph_trainer, loop_trainer):
        t._gen.manual_seed(123)
    same, first = [], None
    bf16 = graph_trainer.hparams.get("compute_dtype") == "bfloat16"
    for it in range(graph_trainer.iter_per_epoch):
        mg, ml = graph_trainer.epoch_step(it, 1), loop_trainer.epoch_step(it, 1)
        same.append(all(torch.equal(graph_trainer.last_batch[k], v)
                        for k, v in loop_trainer.last_batch.items()))
        if it == 0:
            first = metric_errors(mg, ml, bf16)
    return {"batches_bitwise_equal": same, "first_step": first}


def profile_epoch(trainer) -> dict:
    """One epoch of ``trainer``'s driver (``epoch_step``) traced with
    torch.profiler: the card's busy share of the traced wall time, the
    device events a step and the device ms a step by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.epoch_step(0, trainer.iter_per_epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, window, by_name, calls = device_time(prof)
    by_group: dict[str, float] = {}
    for name, us in by_name.items():
        group = kernel_group(name)
        by_group[group] = by_group.get(group, 0.0) + us / 1e3 / trainer.iter_per_epoch
    return {"wall_s": wall, "busy_s": busy / 1e6, "busy_share": busy / 1e6 / wall,
            "busy_of_window": busy / window,
            "events_a_step": sum(calls.values()) / trainer.iter_per_epoch,
            "device_ms_a_step_by_group": by_group}


def graph_path(cc, dev, tmp: str, train, val) -> dict:
    """Phase 12: the one-program epoch. For WT_PSE f32, WT_PSE bf16 and the
    joint variant at full width on ``train``'s pools: a graphed ``Trainer``
    (the default) and an eager-loop one (``scan_epochs=False``) from one
    seed; one epoch of both step by step (every batch bitwise equal, the
    first step's metrics within the scan-vs-loop bound); ``GRAPH_EPOCHS``
    epochs of each through ``train()``, with the launch counts set to 0 just
    before and read just after (8 of each kernel of the dtype a replayed
    step; none for the joint variant at its default hparams); one epoch of
    each traced (the card's busy share); the capture time and the peak
    memory. For f32 and bf16 also one step graphed against the same step
    eager with the same capturable Adam (metrics within the bound, the
    largest parameter difference beside two eager runs')."""
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.train.trainer import Trainer

    variants = (("WT_PSE f32", default_hparams("WT_PSE"), "WT_PSE", (8, 0)),
                ("WT_PSE bf16", dict(default_hparams("WT_PSE"), compute_dtype="bfloat16"),
                 "WT_PSE", (0, 8)),
                ("joint", default_hparams(JOINT), JOINT, (0, 0)))
    out = {}
    for name, hp, algorithm, (n_f32, n_bf16) in variants:
        kw = dict(batch_size=9, interval_validate=10 ** 6, label="OD", seed=1,
                  val_visualization=False, device=dev, algorithm=algorithm,
                  max_epoch=GRAPH_EPOCHS)
        res = {}
        built = {}
        for driver, scan in (("graph", None), ("loop", False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            t = Trainer(hp, train, val, os.path.join(tmp, f"graph_{name}_{driver}"),
                        scan_epochs=scan, **kw)
            built[driver] = time.perf_counter() - t0
            with open(os.path.join(t.out, "run_meta.json")) as f:
                meta = json.load(f)
            if meta["driver"] != ("graph" if scan is None else "eager"):
                raise SystemExit(f"phase 12 {name}: run_meta records driver {meta['driver']}")
            res[driver] = t
        g, loop = res["graph"], res["loop"]
        steps = GRAPH_EPOCHS * g.iter_per_epoch
        check = graph_vs_loop_epoch(g, loop)
        rec = {"capture_s": g._graph.capture_seconds,
               "graph_pool_gib": g._graph.pool_bytes / 2 ** 30,
               "construct_s": built, "vs_loop": check}
        for driver, t in res.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts(cc)
            t0 = time.perf_counter()
            t.train()
            launches = read_counts(cc)
            expect_counts(launches, n_f32 * steps, n_bf16 * steps, f"phase 12 {name} {driver}")
            rec[driver] = {"train_s": time.perf_counter() - t0,
                           "epoch_s": t.epoch_seconds, "enqueue_s": t.enqueue_seconds,
                           "launches": launches,
                           "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                           "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2 ** 30,
                           "profile": profile_epoch(t)}
        if algorithm == "WT_PSE":
            t0 = time.perf_counter()
            rec["vs_eager_step"] = graph_vs_eager_step(dev, hp, algorithm)
            rec["vs_eager_step"]["seconds"] = time.perf_counter() - t0
        log(f"phase 12 {name} (256x256, batch 9 = 3x3, {GRAPH_EPOCHS} epochs x "
            f"{g.iter_per_epoch} steps a driver): {json.dumps(rec)}")
        steady = {d: statistics.median(rec[d]["epoch_s"][1:]) for d in ("graph", "loop")}
        log(f"phase 12 {name}: steady epoch graph {steady['graph']:.4f} s, loop "
            f"{steady['loop']:.4f} s ({steady['graph'] / steady['loop']:.3f}x); card busy "
            f"{rec['graph']['profile']['busy_share']:.1%} of a graphed epoch, "
            f"{rec['loop']['profile']['busy_share']:.1%} of a loop epoch; capture "
            f"{rec['capture_s']:.2f} s")
        if not all(check["batches_bitwise_equal"]) or check["first_step"]["err_of_bound"] > 1.0:
            raise SystemExit(f"phase 12 {name}: the graph and the loop disagree: {check}")
        if "vs_eager_step" in rec and \
                rec["vs_eager_step"]["graph_vs_eager"]["err_of_bound"] > 1.0:
            raise SystemExit(f"phase 12 {name}: the graphed step disagrees with the eager "
                             f"step: {rec['vs_eager_step']}")
        for t in (g, loop):
            with open(os.path.join(t.out, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f if "loss_seg" in line]
            if len(recs) != GRAPH_EPOCHS or not all(
                    math.isfinite(v) for r in recs for k, v in r.items() if k != "step"):
                raise SystemExit(f"phase 12 {name}: expected {GRAPH_EPOCHS} finite epoch "
                                 f"records, got {recs}")
        out[name] = rec
        del g, loop, res
    return out


def state_digest(state) -> str:
    """A hash of every parameter, buffer and optimizer state tensor of the
    four nets: equal digests are bitwise-equal states."""
    import hashlib

    h = hashlib.sha256()
    for ns in state.net_states():
        for name, t in ns.net.state_dict().items():
            h.update(name.encode() + t.detach().cpu().contiguous().numpy().tobytes())
        for i, st in sorted(ns.opt.state_dict()["state"].items()):
            for k, v in sorted(st.items()):
                h.update(f"{i}{k}".encode() + torch.as_tensor(v).cpu().numpy().tobytes())
    return h.hexdigest()


def _install_probe(spec: dict, extra: dict | None = None) -> None:
    """Phase 13's probe in a process that trains (the CLI's own, or a rank
    its launcher started): ``Trainer.train`` sets the launch counts to 0 just
    before the run and reads them just after, and appends the run's record
    (state digest, steps, epochs and their times, rollbacks, data-parallel
    decision, driver, launches, ``extra``) to ``<probe>/rank<r>.json``. A
    ``spec["fail"]`` run raises in its second epoch (its time is written
    first); a ``spec["flaky_epoch"]`` has its loss made non-finite the first
    time it trains."""
    import torch.distributed as dist

    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.train.trainer import Trainer

    train, train_epoch, runs = Trainer.train, Trainer._train_epoch, []

    def path(what: str) -> str:
        rank = dist.get_rank() if dist.is_initialized() else 0
        return os.path.join(spec["probe"], f"{what}{rank}.json")

    def probed_train(self):
        torch.cuda.synchronize()
        zero_counts(cc)
        best = train(self)
        torch.cuda.synchronize()
        runs.append(dict(extra or {}, digest=state_digest(self.state), step=self.state.step,
                         epoch_s=self.epoch_seconds, rollbacks=self._rollbacks, dp=self.dp,
                         n_dev=self.n_dev, iter_per_epoch=self.iter_per_epoch,
                         batch=self.per_domain_batch * self.domain_num,
                         driver="graph" if self.scan_epochs else "eager",
                         launches=read_counts(cc), card=torch.cuda.current_device()))
        with open(path("rank"), "w") as f:
            json.dump(runs, f)
        return best

    def probed_train_epoch(self, epoch: int) -> dict:
        if spec.get("fail") and epoch == 1:
            with open(path("failed"), "w") as f:
                json.dump({"at": time.time()}, f)
            raise RuntimeError("phase 13: this rank is made to fail")
        metrics = train_epoch(self, epoch)
        if epoch == spec.get("flaky_epoch") and not self._rollbacks:
            metrics = dict(metrics, loss_seg=float("nan"))
        return metrics

    Trainer.train, Trainer._train_epoch = probed_train, probed_train_epoch


def _probed_rank(spec: dict, fn, rank: int, args, left_argv):
    """A rank of the CLI's launcher under phase 13's probe: both kernels held
    against their plain versions on this rank's card, at the rank's share of
    the main path's shape, then the CLI's rank body ``fn``."""
    import contextlib
    import io

    import torch.distributed as dist

    from wt_pse_tpu_torch.ops import covariance_cuda as cc

    dev = torch.device("cuda", torch.cuda.current_device())
    domains = len(args.datasetTrain)
    b = args.batch_size // domains // dist.get_world_size() * domains
    gen = torch.Generator(device=dev).manual_seed(rank)
    z = torch.randn(b, 16, 256, 256, device=dev, generator=gen)
    g = torch.randn(b, 16, 16, device=dev, generator=gen)
    with contextlib.redirect_stdout(io.StringIO()) as said:
        errs = check_pair(cc, z, g, f"rank {rank} on {torch.cuda.get_device_name(dev)} "
                                    f"cuda:{dev.index}, z {tuple(z.shape)}")
    _install_probe(spec, {"kernel_check": said.getvalue().strip(), "kernel_errors": errs})
    return fn(rank, args, left_argv)


def probed_cli(argv: list) -> int:
    """Phase 13's CLI process: ``python -m wt_pse_tpu_torch.cli.train
    argv[1:]`` (``runpy``, as ``-m`` runs it: a launched rank re-imports the
    CLI module as its main, as under ``-m``), with the probe of
    ``argv[0]`` (JSON) in this process and wrapped around the rank body the
    CLI's launcher starts."""
    import functools
    import runpy

    from wt_pse_tpu_torch.parallel import distributed

    spec, launch = json.loads(argv[0]), distributed.launch_ranks

    def probed_launch(fn, world_size, args=(), **kw):
        return launch(functools.partial(_probed_rank, spec, fn), world_size, args, **kw)

    distributed.launch_ranks = probed_launch  # the CLI module imports it from here
    _install_probe(spec)
    sys.argv = ["wt_pse_tpu_torch.cli.train", *argv[1:]]
    runpy.run_module("wt_pse_tpu_torch.cli.train", run_name="__main__", alter_sys=True)
    return 0


def write_cli_tree(root: str, train, val) -> None:
    """Phase 13's synthetic Fundus tree, with PIL: phase 6's three train pools
    as Domain1, 2 and 4 ``train`` (12 images each at 256x256) and phase 7's
    test split as Domain3 ``test``."""
    from PIL import Image

    for dom, pool in zip((1, 2, 4), train):
        d = os.path.join(root, f"Domain{dom}", "train", "ROIs")
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i, (img, lab) in enumerate(zip(pool.images, pool.labels)):
            name = f"{FUNDUS_PREFIX[dom]}_{i}.png"
            Image.fromarray(img).save(os.path.join(d, "image", name))
            Image.fromarray(lab).save(os.path.join(d, "mask", name))
    write_test_split(root, val)


def run_cli(tmp: str, name: str, args: list, visible: str | None = None, **spec) -> dict:
    """The training CLI in a subprocess of its own (``probed_cli``), on the
    tree under ``tmp``, out to ``tmp/name``; ``visible`` sets
    ``CUDA_VISIBLE_DEVICES``. Returns its exit code, wall time, end time,
    output, ``run_meta.json`` and the probe's records by rank."""
    out, probe = os.path.join(tmp, name), os.path.join(tmp, f"probe_{name}")
    os.makedirs(probe)
    argv = ["--data-dir", os.path.join(tmp, "cli_data"), "--out", out, "--label", "OD",
            "--running_times", "1", *args]
    env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": visible} if visible else {}))
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "sys.exit(chip_smoke.probed_cli(sys.argv[1:]))",
                           json.dumps(dict(spec, probe=probe)), *argv],
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S, cwd=here,
                          env=env)
    rec = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0, "ended": time.time(),
           "stdout": proc.stdout, "stderr": proc.stderr, "ranks": {}, "failed": {}}
    for f in sorted(os.listdir(probe)):
        with open(os.path.join(probe, f)) as fh:
            kind, rank = re.match(r"([a-z]+)(\d+)\.json", f).groups()
            rec["ranks" if kind == "rank" else "failed"][int(rank)] = json.load(fh)
    meta = os.path.join(out, "run0", "run_meta.json")
    rec["meta"] = json.load(open(meta)) if os.path.exists(meta) else None
    return rec


def cli_summary(rec: dict) -> str:
    r0 = rec["ranks"].get(0, [{}])[-1]
    meta = rec["meta"] or {}
    return (f"exit {rec['rc']} in {rec['wall_s']:.1f} s; run_meta dp "
            f"{json.dumps(meta.get('dp', {}).get('enabled'))} n_devices "
            f"{meta.get('dp', {}).get('n_devices')} n_processes {meta.get('n_processes')} "
            f"driver {meta.get('driver')}; ranks that trained {sorted(rec['ranks'])}; rank 0: "
            f"{r0.get('epoch_s') and len(r0['epoch_s'])} epochs x {r0.get('iter_per_epoch')} "
            f"steps, epochs " + ", ".join(f"{t:.4f}" for t in r0.get("epoch_s", [])) +
            f" s, launches {r0.get('launches')}")


def expect_cli(rec: dict, what: str, ranks: int, dp: bool, epochs: int) -> None:
    """The CLI exited 0, ``ranks`` ranks trained (one record each, on cards
    0..ranks-1) with the expected decision and ``epochs`` epochs, and each
    launched 8 of each f32 kernel a step."""
    meta = rec["meta"] or {}
    ok = (rec["rc"] == 0 and sorted(rec["ranks"]) == list(range(ranks))
          and meta.get("n_processes") == (ranks if dp else 1)
          and meta.get("dp", {}).get("enabled") == dp
          and meta.get("dp", {}).get("n_devices") == (ranks if dp else 1))
    for rank, runs in rec["ranks"].items():
        r = runs[-1]
        steps = len(r["epoch_s"]) * r["iter_per_epoch"]
        ok = ok and (r["dp"], r["n_dev"], r["card"], len(r["epoch_s"]), r["driver"]) == (
            dp, ranks if dp else 1, rank, epochs, "graph")
        want = {"covariance_gram": 8 * steps, "covariance_dz": 8 * steps,
                "covariance_gram_bf16": 0, "covariance_dz_bf16": 0}
        ok = ok and r["launches"] == want
    if not ok:
        raise SystemExit(f"phase 13 {what}: {cli_summary(rec)}\n{rec['stdout'][-3000:]}\n"
                         f"{rec['stderr'][-5000:]}")


def cli_path(tmp: str, p6: dict | None) -> dict:
    """Phase 13: the training CLI as a user starts it, without torchrun, on
    phase 6's pools written as a Fundus tree (256x256, f32, 3 train domains
    of 12 images). (a) on the first card alone (``CUDA_VISIBLE_DEVICES``):
    ``--dp`` starts one NCCL rank (the DP graph at world 1); auto trains in
    the CLI's own process with data parallelism off; a rank made to fail ends
    the CLI non-zero within ``CLI_FAIL_S``. (b) where more than one card is
    visible: auto at batch 9 starts 3 ranks; at batch 12 on 4 cards, 4 (to
    a validation and its checkpoint), whose states end bitwise equal and
    whose kernels each agree with their plain versions on the rank's card;
    and that checkpoint resumed with ``--nan-recovery``, a non-finite epoch
    rolled back, to its last epoch. Every trained run's launch counts are set
    to 0 just before its ``train()`` and read just after."""
    cards = torch.cuda.device_count()
    train, val = (p6["train"], p6["val"]) if p6 else synthetic_pools()
    write_cli_tree(os.path.join(tmp, "cli_data"), train, val)
    short = ["--max-epoch", str(CLI_EPOCHS), "--interval-validate", "99"]
    first = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]

    dp1 = run_cli(tmp, "a_dp", ["--batch-size", "9", "--dp", *short], visible=first)
    log(f"phase 13 (a) the CLI with --dp on one visible card: {cli_summary(dp1)}; the rank's "
        f"kernel check: {dp1['ranks'].get(0, [{}])[-1].get('kernel_check')}")
    expect_cli(dp1, "(a) --dp", 1, True, CLI_EPOCHS)
    if "[launcher] data-parallel over 1 card(s)" not in dp1["stdout"]:
        raise SystemExit(f"phase 13 (a): --dp did not launch one rank:\n{dp1['stdout'][-3000:]}")

    auto = run_cli(tmp, "a_auto", ["--batch-size", "9", *short], visible=first)
    log(f"phase 13 (a) the CLI under auto on one visible card: {cli_summary(auto)}")
    expect_cli(auto, "(a) auto", 1, False, CLI_EPOCHS)
    if "[launcher]" in auto["stdout"]:
        raise SystemExit("phase 13 (a): auto on one card launched ranks")

    fail = run_cli(tmp, "a_fail", ["--batch-size", "9", "--dp", *short], visible=first,
                   fail=True)
    after = fail["ended"] - fail["failed"][0]["at"] if 0 in fail["failed"] else float("nan")
    said = "rank 0 failed" in fail["stderr"] and "made to fail" in fail["stderr"]
    log(f"phase 13 (a) a rank made to fail in its second epoch: the CLI exited "
        f"{fail['rc']} {after:.2f} s after the failure (limit {CLI_FAIL_S:g} s), "
        f"{fail['wall_s']:.1f} s in all; its error names the rank and the cause: {said}")
    if fail["rc"] == 0 or not after < CLI_FAIL_S or not said:
        raise SystemExit(f"phase 13 (a): the failing rank did not end the run:\n"
                         f"{fail['stderr'][-5000:]}")

    out = {"a": {"dp": dp1, "auto": auto, "fail_after_s": after}}
    if cards < 2:
        log("phase 13 (b) did not run: one card is visible (it needs two or more)")
        return out
    t0 = time.perf_counter()
    b9 = run_cli(tmp, "b_9", ["--batch-size", "9", *short])
    log(f"phase 13 (b) the CLI under auto at batch 9 on {cards} cards: {cli_summary(b9)}")
    expect_cli(b9, "(b) batch 9", min(3, cards) if cards != 2 else 1, cards != 2, CLI_EPOCHS)
    n12 = max(n for n in range(1, cards + 1) if 4 % n == 0)
    b12 = run_cli(tmp, "b_12", ["--batch-size", "12", "--max-epoch", "4",
                                "--interval-validate", "4"])
    log(f"phase 13 (b) the CLI under auto at batch 12 on {cards} cards: {cli_summary(b12)}")
    expect_cli(b12, "(b) batch 12", n12, True, 4)
    digests = {r: runs[-1]["digest"] for r, runs in b12["ranks"].items()}
    for r, runs in sorted(b12["ranks"].items()):
        log(f"phase 13 (b) rank {r}: {runs[-1]['kernel_check']}")
    ckpt = os.path.join(tmp, "b_12", "run0", "checkpoint_4.pth.tar")
    resumed = run_cli(tmp, "b_resumed", ["--batch-size", "12", "--max-epoch", "7",
                                         "--interval-validate", "99", "--nan-recovery",
                                         "--resume", ckpt], flaky_epoch=5)
    rolled = {r: (runs[-1]["rollbacks"], runs[-1]["step"]) for r, runs in resumed["ranks"].items()}
    log(f"phase 13 (b) batch 12 resumed from its checkpoint, epoch 5 made non-finite: "
        f"{cli_summary(resumed)}; (rollbacks, step) by rank {rolled}")
    expect_cli(resumed, "(b) resumed", n12, True, 3)
    same = len(set(digests.values())) == 1
    same_resumed = len({runs[-1]["digest"] for runs in resumed["ranks"].values()}) == 1
    log(f"phase 13 (b) ranks' final states bitwise equal: batch 12 {same}, resumed "
        f"{same_resumed}; (b) took {time.perf_counter() - t0:.1f} s")
    if not (same and same_resumed and os.path.exists(ckpt)
            and set(rolled.values()) == {(1, 6 * b12["ranks"][0][-1]["iter_per_epoch"])}):
        raise SystemExit(f"phase 13 (b): digests {digests}, resumed {rolled}")
    for name, rec in (("batch 9", b9), ("batch 12", b12)):
        r = rec["ranks"][0][-1]
        one = statistics.median(p6["trainer"].epoch_seconds[1:]) if p6 else None
        steady = statistics.median(r["epoch_s"][1:])
        log(f"phase 13 (b) {name} on {card_line()}: {r['n_dev']} ranks, global batch "
            f"{r['batch']}, {r['iter_per_epoch']} steps an epoch, steady epoch "
            f"{steady:.4f} s = {r['batch'] * r['iter_per_epoch'] / steady:.1f} images/s"
            + (f"; phase 6's one-card epoch (batch 9, 4 steps) {one:.4f} s = "
               f"{9 * 4 / one:.1f} images/s" if one else ""))
    out["b"] = {"b9": b9, "b12": b12, "resumed": resumed}
    return out


def time_in_turns(fns, flush, iters: int = 30) -> list[float]:
    """Median ms of one call of each of ``fns``, with ``flush()`` (which evicts
    the L2) before every call, the functions taken in turns in one loop."""
    for fn in fns:
        for _ in range(3):
            fn()
    events = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)] for _ in fns]
    for i in range(iters):
        for fn, ev in zip(fns, events):
            flush()
            ev[i][0].record()
            fn()
            ev[i][1].record()
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in ev) for ev in events]


def host_us(fn, iters: int = 100) -> float:
    """Median host time of one call of ``fn`` in microseconds: the time the
    caller is held, none of the calls waiting for the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bf16_bmm_f32(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(one PyTorch call computing a @ b from bf16 operands with an f32 result,
    its name): ``torch.bmm(..., out_dtype=torch.float32)`` where this torch
    has it, else the bf16 ``torch.bmm`` (a bf16 result)."""
    try:
        torch.bmm(a[:1, :1], b[:1, :, :1], out_dtype=torch.float32)
        return (lambda: torch.bmm(a, b, out_dtype=torch.float32)), \
            "torch.bmm(bf16, bf16, out_dtype=float32)"
    except (TypeError, RuntimeError):
        return (lambda: torch.bmm(a, b)), "torch.bmm(bf16, bf16) (bf16 out: no out_dtype here)"


def time_kernels(cc, dev, errs: dict) -> list[dict]:
    """Phase 5, at the main-path shape, for an f32 and a bf16 z. Cold L2: a
    256 MB write before every call leaves the L2 full of dirty lines, as the
    training step leaves it; the call then also writes those back as it
    reads. That is ``ms``, the yardstick the earlier times were taken with. A
    256 MB read instead leaves clean lines, which is what the bound assumes;
    those times are printed beside it as a second reading."""
    b, c, h, w = MAIN_SHAPE
    hw = h * w
    gen = torch.Generator(device=dev).manual_seed(1)
    z32 = torch.randn(MAIN_SHAPE, device=dev, generator=gen)
    g = torch.randn(b, c, c, device=dev, generator=gen)
    s_sym = (g + g.transpose(1, 2)) / (hw - 1)
    buf = torch.zeros(64 * 1024 * 1024, device=dev)
    ops = 2.0 * b * c * c * hw
    clib, cstream = cc._library(), torch.cuda.current_stream().cuda_stream
    n_chunks = max(cc._gram_chunks(dev.index or 0, size, b, c, hw, True) for size in (4, 2))
    partial = torch.empty(b * n_chunks * c * c, device=dev)
    cov = torch.empty(b, c, c, device=dev)
    rows = []
    for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        z = z32.to(dtype)
        f = z.view(b, c, hw)
        size = z.element_size()
        dz = torch.empty_like(z)
        # the library's C entry points on preallocated outputs: the host time
        # of a wrapper call less these is the wrapper's Python and allocations
        c_gram, c_dz = (getattr(clib, f"wtpse_covariance_{k}_{suffix}") for k in ("gram", "dz"))
        c_calls = {"gram": lambda: c_gram(z.data_ptr(), partial.data_ptr(), cov.data_ptr(),
                                          b, c, hw, cc.EPS, cstream),
                   "dz": lambda: c_dz(z.data_ptr(), g.data_ptr(), dz.data_ptr(), b, c, hw,
                                      cstream)}
        if dtype == torch.float32:
            lib_gram = lambda: torch.bmm(f, f.transpose(1, 2))
            lib_dz = lambda: torch.bmm(s_sym, f)
            lib_names = ("torch.bmm", "torch.bmm")
        else:
            lib_gram, gram_name = bf16_bmm_f32(f, f.transpose(1, 2))
            s_bf16 = s_sym.to(dtype)
            lib_dz = lambda: torch.bmm(s_bf16, f)
            lib_names = (gram_name, "torch.bmm(bf16 S, bf16 z) (S rounded to bf16)")
        tag = "" if dtype == torch.float32 else "_bf16"
        # each with a PyTorch call that moves the same bytes and computes
        # nothing (z.sum reads z once; z.clone reads it and writes a copy): what
        # streaming those bytes costs on this card, beside the bound's 3.35 TB/s
        for name, line, kern, plain, lib, lib_name, stream, nbytes in (
                ("covariance_gram" + tag, "wt_pse_tpu/ops/whitening_pallas.py:68",
                 lambda: cc.covariance_forward(z), lambda: cc.covariance_forward_plain(z),
                 lib_gram, lib_names[0], z.sum, size * b * c * hw + 4.0 * b * c * c),
                ("covariance_dz" + tag, "wt_pse_tpu/ops/whitening_pallas.py:100",
                 lambda: cc.covariance_backward(z, g), lambda: cc.covariance_backward_plain(z, g),
                 lib_dz, lib_names[1], z.clone, 2.0 * size * b * c * hw + 4.0 * b * c * c)):
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
            short = name.split("_")[1]
            ms, lib_ms, plain_ms = time_in_turns((kern, lib, plain), buf.zero_)
            row = {"name": name, "route": "cuda",
                   "source": "wt_pse_tpu_torch/csrc/covariance.cu",
                   "replaces": line, "launches": None,
                   "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms}
            earlier = (f"; earlier (FFMA kernels) {EARLIER_MS[name]:.4f} ms" if name in EARLIER_MS
                       else "")
            log(f"{name}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms by "
                f"{row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of it); plain "
                f"{row['plain_ms']:.4f} ms; {lib_name} yardstick {row['library_ms']:.4f} ms "
                f"(in turns, write flush){earlier}")
            r_ms, r_lib, stream_ms = time_in_turns((kern, lib, stream), buf.sum)
            log(f"{name} after a read flush: {r_ms:.4f} ms ({row['bound_ms'] / r_ms:.1%} of the "
                f"bound); {lib_name} yardstick {r_lib:.4f} ms; z.{stream.__name__} moving "
                f"the same bytes {stream_ms:.4f} ms")
            h_kern, h_c, h_lib = host_us(kern), host_us(c_calls[short]), host_us(lib)
            log(f"{name} host time a call: wrapper {h_kern:.1f} us (its C entry point alone "
                f"{h_c:.1f} us), {lib_name} {h_lib:.1f} us")
            rows.append(row)
    return rows


# (C, H, W) of every training-mode BatchNorm of the default step (N = 9)
BN_SHAPES = [(16, 256, 256), (32, 256, 256), (32, 128, 128), (64, 128, 128), (64, 64, 64),
             (128, 64, 64), (128, 32, 32), (256, 32, 32), (256, 16, 16)]
BN_TIMED_SHAPES = [(9, 16, 256, 256), (9, 32, 128, 128), (9, 256, 16, 16)]


def bn_forward(bn, x, w, b, relu: bool, grad: bool = False):
    """The library's forward (``forward_library``'s dispatch and ReLU), under
    autograd with ``grad`` (then x, w and b are leaves of their own): (y,
    mean, invstd, the leaves)."""
    c = x.shape[1]
    leaves = tuple(t.detach().requires_grad_(grad) for t in (x, w, b))
    with torch.set_grad_enabled(grad):
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            *leaves, torch.zeros(c, device=x.device), torch.ones(c, device=x.device), True,
            0.1, 1e-5, torch.backends.cudnn.enabled)
        y = torch.relu(y) if relu else y
    return y, mean.detach(), invstd.detach(), leaves


def fresh_bn_stats(c: int, dev) -> list:
    """Running statistics that are not the defaults, and a
    ``num_batches_tracked`` of 5."""
    g = torch.Generator(device=dev).manual_seed(c)
    return [torch.randn(c, device=dev, generator=g), torch.rand(c, device=dev, generator=g) + 0.5,
            torch.full((), 5, dtype=torch.long, device=dev)]


def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two f32 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7fffffff), i)
    return int((ordered(a) - ordered(b)).abs().max())


def bn_forward_errors(x, w, b, y, mean, invstd, stats, start, relu: bool) -> list[float]:
    """y, the saved mean and invstd and the running mean and variance (from
    ``start``) against an f64 truth, each as a share of f32_reduce: y of its
    largest magnitude, the means of their channel's |mean| + std."""
    xd = x.double()
    var, mu = torch.var_mean(xd, (0, 2, 3), correction=0)
    std = var.sqrt()
    yt = (xd - mu[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None] \
        * w.double()[:, None, None] + b.double()[:, None, None]
    yt = torch.relu(yt) if relu else yt
    n = x.numel() // x.shape[1]
    rm = 0.9 * start[0].double() + 0.1 * mu
    rv = 0.9 * start[1].double() + 0.1 * var * n / (n - 1)
    return [float(e) / F32_REDUCE_RTOL for e in (
        (y.double() - yt).abs().max() / yt.abs().max(),
        ((mean.double() - mu).abs() / (mu.abs() + std)).max(),
        (invstd.double() * (var + 1e-5).sqrt() - 1).abs().max(),
        ((stats[0].double() - rm).abs() / (rm.abs() + 0.1 * std)).max(),
        ((stats[1].double() - rv) / rv).abs().max())]


def bn_errors(got, want, magnitude) -> list[float]:
    """dx, dweight and dbias of ``got`` against ``want``, each as a share of
    its tolerance: dx at f32_reduce of its largest magnitude, or 1 bf16 ulp +
    f32_reduce; dweight and dbias at f32_reduce of the sum of their terms'
    magnitudes."""
    if got[0].dtype == torch.bfloat16:
        dx = bf16_ulp_error(got[0], want[0])
    else:
        dx = float((got[0].double() - want[0].double()).abs().max()
                   / want[0].double().abs().max()) / F32_REDUCE_RTOL
    return [dx] + [float(((got[i].double() - want[i].double()).abs()
                          / m.clamp_min(1e-30)).max()) / F32_REDUCE_RTOL
                   for i, m in ((1, magnitude[0]), (2, magnitude[1]))]


BN_MAX_FLIP_SHARE = 1e-5  # elements whose ReLU side the kernels may take otherwise
BN_FLIP_ULPS = 8.0        # ... only within this many f32 ulps of the pre-activation's terms


def check_batchnorm(bn, x, dy, w, b, relu: bool) -> dict:
    """The path (``BatchNormReLU``: the forward kernels for an f32 x, the
    library's forward for bf16, then the backward kernels) against the
    library's forward and backward under autograd, from one x, and the
    forward against its plain version and an f64 truth. In f32:
    ``forward_plain_ulps``, y's distance to the plain version (at most 1),
    ``forward_plain_stats``, whether the saved mean and invstd, the running
    statistics and ``num_batches_tracked`` equal the plain version's bit for
    bit, and ``forward_truth``, shares of f32_reduce of y, the saved mean and
    invstd and the running mean and variance against an f64 truth
    (``bn_forward_errors``, each at most 1); in bf16 the forward must be the
    library's, bit for bit. With the ReLU the backward kernels recompute its
    mask (``relu_mask``); ``flips`` counts the elements where it is not the
    path's forward's (y > 0): none in f32, where the two use one
    expression; in bf16 ``flip_ulps`` is the largest pre-activation among
    them in f32 ulps of its terms, a flip allowed only where the forward's
    rounding decides the sign. Shares of the tolerance (``bn_errors``) of dx,
    dweight and dbias: the kernels against an f64 truth with their own mask
    and statistics and against their plain version (each at most 1); against
    the library, dx where the masks agree, at most 1 plus the library's own
    distance from an f64 truth with its mask plus the two truths' distance
    (the flips' and the two forwards' statistics' effect on the sums). ``ok``
    holds all of it."""
    c = x.shape[1]
    f32 = x.dtype == torch.float32
    y, mean, invstd, leaves = bn_forward(bn, x, w, b, relu, grad=True)
    lib = torch.autograd.grad(y, leaves, dy)
    start = fresh_bn_stats(c, x.device)
    stats = [t.clone() for t in start]
    xk, wk, bk = (t.detach().requires_grad_() for t in (x, w, b))
    yk = bn.BatchNormReLU.apply(xk, wk, bk, *stats, 0.1, 1e-5, relu)
    _, mean_k, invstd_k, _, _ = yk.grad_fn.saved_tensors
    got = torch.autograd.grad(yk, (xk, wk, bk), dy)
    yk = yk.detach()
    out = {}
    if f32:
        plain_stats = [t.clone() for t in start]
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        yp, mean_p, invstd_p = bn.batch_norm_forward_plain(x, w, b, *plain_stats, 0.1, 1e-5,
                                                           relu, sms)
        out["forward_plain_ulps"] = f32_ulps(yk, yp)
        out["forward_plain_stats"] = all(torch.equal(a, p) for a, p in zip(
            [mean_k, invstd_k, *stats], [mean_p, invstd_p, *plain_stats]))
        out["forward_truth"] = bn_forward_errors(x, w, b, yk, mean_k, invstd_k, stats, start,
                                                 relu)
        out["y_max_abs_vs_library"] = float((yk - y.detach()).abs().max())
    elif not torch.equal(yk, y):
        raise SystemExit("phase 15: BatchNormReLU's bf16 forward is not the library's")
    keep = torch.ones_like(x, dtype=torch.bool)
    mask_k = mask_lib = keep
    flips, flip_ulps = 0, 0.0
    if relu:
        mask_k = bn.relu_mask(x, mean_k, invstd_k, w, b)
        mask_lib = ~(y.detach() <= 0)
        own = mask_k != (yk > 0)
        flips = int(own.sum())
        if flips:
            xm = (x.float() - mean_k[:, None, None]).double()
            ws = (invstd_k * w).double()[:, None, None]
            terms = (xm * ws).abs() + b.double().abs()[:, None, None]
            pre = xm * ws + b.double()[:, None, None]
            flip_ulps = float((pre.abs() / terms)[own].max()) / 2.0 ** -24
        keep = mask_k == mask_lib
        out["library_flips"] = int((~keep).sum())
    plain = bn.batch_norm_backward_plain(x, dy, mean_k, invstd_k, w, b, relu)

    def truth(mask, m, inv):
        return bn.batch_norm_backward_plain(x.double(), torch.where(mask, dy, 0).double(),
                                            m.double(), inv.double(), w.double(),
                                            b.double(), False)

    truth_k, truth_lib = truth(mask_k, mean_k, invstd_k), truth(mask_lib, mean, invstd)
    g = torch.where(mask_k, dy, 0).double()
    xm = x.double() - mean_k.double()[:, None, None]
    mag = ((g * xm).abs().sum((0, 2, 3)) * invstd_k.double(), g.abs().sum((0, 2, 3)))

    def kept(t):
        return (torch.where(keep, t[0], 0), t[1], t[2])

    out.update({"truth": bn_errors(got, truth_k, mag), "plain": bn_errors(got, plain, mag),
                "library": bn_errors(kept(got), kept(lib), mag),
                "library vs truth": bn_errors(kept(lib), kept(truth_lib), mag),
                "flips' effect": bn_errors(kept(truth_k), kept(truth_lib), mag),
                "flips": flips, "flip_ulps": flip_ulps,
                "dx_max_abs_vs_library": float((kept(got)[0].float() - kept(lib)[0].float())
                                               .abs().max())})
    forward_ok = (out["forward_plain_ulps"] <= 1 and out["forward_plain_stats"]
                  and max(out["forward_truth"]) <= 1.0 and flips == 0) if f32 else (
        flips <= BN_MAX_FLIP_SHARE * x.numel() and flip_ulps <= BN_FLIP_ULPS)
    out["ok"] = (forward_ok and max(out["truth"] + out["plain"]) <= 1.0
                 and all(e <= 1.0 + t + f for e, t, f in zip(
                     out["library"], out["library vs truth"], out["flips' effect"])))
    return out


def time_batchnorm(dev) -> list[dict]:
    """Phase 15: the BatchNorm kernels at every layer shape of the main path,
    with and without the ReLU, through ``BatchNormReLU``, held against their
    plain versions, an f64 truth and the library (``check_batchnorm``); then
    timed at three shapes in turns with the plain version and the library's
    call after a 256 MB write: the backward in f32 and bf16, the forward in
    f32."""
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    keys = ("truth", "plain", "library", "library vs truth", "flips' effect")
    for chw in BN_SHAPES:
        shape = (9,) + chw
        x32 = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        dy32 = torch.randn(shape, device=dev, generator=gen)
        w = torch.rand(chw[0], device=dev, generator=gen) + 0.5
        b = torch.randn(chw[0], device=dev, generator=gen) * 0.5
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (True, False):
                res = check_batchnorm(bn, x32.to(dtype), dy32.to(dtype), w, b, relu)
                torch.cuda.synchronize()
                name = f"bn {shape} {str(dtype)[6:]} {'relu' if relu else 'plain'}"
                forward = (f"forward: y {res['forward_plain_ulps']} f32 ulps from its plain "
                           f"version, statistics bitwise {res['forward_plain_stats']}; (y, "
                           f"mean, invstd, running mean, running var) of f32_reduce against "
                           f"the truth " + ", ".join(f"{e:.3f}" for e in res["forward_truth"])
                           + f"; largest y distance to the library "
                           f"{res['y_max_abs_vs_library']:.3e}; "
                           if dtype == torch.float32 else "forward: the library's; ")
                log(f"{name}: {forward}backward (dx, dweight, dbias) of the tolerance " +
                    "; ".join(f"against the {k} " + ", ".join(f"{e:.3f}" for e in res[k])
                              for k in keys) +
                    f"; ReLU mask flips {res['flips']} (largest {res['flip_ulps']:.2f} f32 "
                    f"ulps from 0), {res.get('library_flips', 0)} against the library's "
                    f"forward; largest dx distance to the library where the masks agree "
                    f"{res['dx_max_abs_vs_library']:.3e}")
                for k in keys:
                    worst[k] = max([worst.get(k, 0.0)] + res[k])
                if dtype == torch.float32:
                    worst["forward_truth"] = max([worst.get("forward_truth", 0.0)] +
                                                 res["forward_truth"])
                    worst["forward_plain_ulps"] = max(worst.get("forward_plain_ulps", 0),
                                                      res["forward_plain_ulps"])
                worst["flips"] = worst.get("flips", 0) + res["flips"]
                worst["flip_ulps"] = max(worst.get("flip_ulps", 0.0), res["flip_ulps"])
                if not res["ok"]:
                    raise SystemExit(f"{name}: the forward is off its plain version or its "
                                     f"truth, or the backward kernels are off their truth or "
                                     f"plain version, off the library's backward by more than "
                                     f"their tolerance and the library's own error, or the "
                                     f"ReLU's mask flips too often or too far from 0: {res}")
    log(f"phase 15: {len(BN_SHAPES) * 4} cases held (check_batchnorm); the largest shares of "
        f"the tolerance, the mask flips in all and the largest flip: {worst}")

    buf = torch.zeros(64 * 1024 * 1024, device=dev)

    def flush():  # the write flush, then about 1 ms more of the card's own work,
        buf.zero_()  # so that the host enqueues the timed call before it starts
        torch.cuda._sleep(2_000_000)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for shape in BN_TIMED_SHAPES:
        c = shape[1]
        x32 = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        dy32 = torch.randn(shape, device=dev, generator=gen)
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        b = torch.randn(c, device=dev, generator=gen) * 0.5
        stats = fresh_bn_stats(c, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            size = x.numel() * x.element_size()
            if dtype == torch.float32:
                ms, plain_ms, lib_ms = time_in_turns(
                    (lambda: bn.batch_norm_forward(x, w, b, *stats, 0.1, 1e-5, True),
                     lambda: bn.batch_norm_forward_plain(x, w, b, *stats, 0.1, 1e-5, True, sms),
                     lambda: bn.forward_library(x, w, b, *stats, 0.1, 1e-5, True)), flush)
                bound_ms, strict_ms = (k * size / HBM_BYTES_PER_S * 1e3 for k in (3, 2))
                rows.append({"name": "bn_forward", "shape": list(shape), "dtype": "float32",
                             "relu": True, "ms": ms, "three_pass_bound_ms": bound_ms,
                             "strict_bound_ms": strict_ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms})
                log(f"bn_forward {tuple(shape)} float32 relu: {ms:.4f} ms (three-pass bound "
                    f"{bound_ms:.4f} ms, {bound_ms / ms:.1%} of it; strict {strict_ms:.4f} ms, "
                    f"{strict_ms / ms:.1%}); plain {plain_ms:.4f} ms; the library's forward "
                    f"(cuDNN's) and the ReLU in place {lib_ms:.4f} ms (in turns, write flush)")
            y, mean, invstd, leaves = bn_forward(bn, x, w, b, True, grad=True)
            ms, plain_ms, lib_ms = time_in_turns(
                (lambda: bn.batch_norm_backward(x, dy, mean, invstd, w, b, True),
                 lambda: bn.batch_norm_backward_plain(x, dy, mean, invstd, w, b, True),
                 lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)), flush)
            bound_ms, strict_ms = (k * size / HBM_BYTES_PER_S * 1e3 for k in (5, 3))
            name = f"bn_backward {tuple(shape)} {str(dtype)[6:]} relu"
            rows.append({"name": "bn_backward", "shape": list(shape), "dtype": str(dtype)[6:],
                         "relu": True, "ms": ms, "two_pass_bound_ms": bound_ms,
                         "strict_bound_ms": strict_ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms})
            log(f"{name}: {ms:.4f} ms (two-pass bound {bound_ms:.4f} ms, "
                f"{bound_ms / ms:.1%} of it; strict {strict_ms:.4f} ms, {strict_ms / ms:.1%}); "
                f"plain {plain_ms:.4f} ms; the library's backward (cuDNN / ATen + the ReLU's) "
                f"{lib_ms:.4f} ms (in turns, write flush)")
    return rows


# (N, C, H, W) of the decoders' four upsamples in the default step
UP_SHAPES = [(9, 256, 16, 16), (9, 128, 32, 32), (9, 64, 64, 64), (9, 32, 128, 128)]


def up_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def time_upsample(dev) -> list[dict]:
    """Phase 16: the upsample kernels at ``UP_SHAPES`` in f32 and bf16, held
    and then timed in turns with ATen's kernels (module docstring). Returns
    one row a shape and type: the kernels' and ATen's milliseconds (in bf16
    ATen's two passes apart too), the bytes and the bound of each way."""
    from wt_pse_tpu_torch.ops import upsample_cuda as up

    aten_bw = torch.ops.aten.upsample_bilinear2d_backward
    gen = torch.Generator(device=dev).manual_seed(16)
    buf = torch.zeros(64 * 1024 * 1024, device=dev)

    def flush():  # the write flush, then about 1 ms more of the card's own work
        buf.zero_()
        torch.cuda._sleep(2_000_000)

    def interp(x, scale):
        return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)

    rows = []
    for shape in UP_SHAPES:
        n, c, h, w = shape
        big = (n, c, 2 * h, 2 * w)
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dtype)
            dy = torch.randn(big, device=dev, generator=gen).to(dtype)
            bf16 = dtype == torch.bfloat16
            mid = interp(x, (2, 1)) if bf16 else None
            want = interp(mid, (1, 2)) if bf16 else interp(x, 2)
            y, dx = up.upsample2x_forward(x), up.upsample2x_backward(dy)
            x64 = torch.zeros(shape, dtype=torch.float64, device=dev, requires_grad=True)
            interp(x64, 2).backward(dy.double())
            err = (bf16_ulp_error(dx, x64.grad) if bf16 else
                   float((dx.double() - x64.grad).abs().max() / x64.grad.abs().max())
                   / F32_REDUCE_RTOL)
            name = f"upsample2x {shape} {str(dtype)[6:]}"
            if not torch.equal(up_bits(y), up_bits(want)):
                raise SystemExit(f"{name}: the forward kernel is not ATen's, bit for bit")
            if not torch.equal(dx, up.upsample2x_backward_plain(dy)) or err > (0.5 if bf16
                                                                                else 1.0):
                raise SystemExit(f"{name}: the backward kernel is off its plain version or "
                                 f"its f64 truth ({err:.3f} of the tolerance)")
            fns = {"forward": lambda: up.upsample2x_forward(x),
                   "backward": lambda: up.upsample2x_backward(dy)}
            if bf16:
                dmid = torch.randn(mid.shape, device=dev, generator=gen).to(dtype)
                fns.update({
                    "aten_forward_pass1": lambda: interp(x, (2, 1)),
                    "aten_forward_pass2": lambda: interp(mid, (1, 2)),
                    "aten_forward": lambda: interp(interp(x, (2, 1)), (1, 2)),
                    "aten_backward_pass2": lambda: aten_bw(dy, [2 * h, 2 * w], list(mid.shape),
                                                           False, 1.0, 2.0),
                    "aten_backward_pass1": lambda: aten_bw(dmid, [2 * h, w], list(shape),
                                                           False, 2.0, 1.0),
                    "aten_backward": lambda: aten_bw(
                        aten_bw(dy, [2 * h, 2 * w], list(mid.shape), False, 1.0, 2.0),
                        [2 * h, w], list(shape), False, 2.0, 1.0)})
            else:
                fns.update({"aten_forward": lambda: interp(x, 2),
                            "aten_backward": lambda: aten_bw(dy, [2 * h, 2 * w], list(shape),
                                                             False, 2.0, 2.0)})
            ms = dict(zip(fns, time_in_turns(list(fns.values()), flush)))
            nbytes = x.element_size() * (x.numel() + dy.numel())  # each way
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"name": "upsample2x", "shape": list(shape), "dtype": str(dtype)[6:],
                   "bytes": nbytes, "bound_ms": bound_ms, "backward_err_of_tolerance": err,
                   **{f"{k}_ms": v for k, v in ms.items()}}
            rows.append(row)
            log(f"{name}: forward {ms['forward']:.4f} ms, backward {ms['backward']:.4f} ms "
                f"(bound {bound_ms:.4f} ms each way: {bound_ms / ms['forward']:.1%}, "
                f"{bound_ms / ms['backward']:.1%}); ATen " + ", ".join(
                    f"{k[5:]} {v:.4f} ms" for k, v in ms.items() if k.startswith("aten")) +
                f" (in turns, write flush); backward {err:.3f} of its tolerance off the f64 "
                f"truth")
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        tot = {k: sum(r[k] for r in mine) for k in ("forward_ms", "backward_ms", "aten_forward_ms",
                                                    "aten_backward_ms", "bound_ms")}
        log(f"phase 16 {dtype}, the four shapes (one U-Net's upsamples): forward "
            f"{tot['forward_ms']:.4f} ms against ATen's {tot['aten_forward_ms']:.4f}, backward "
            f"{tot['backward_ms']:.4f} against {tot['aten_backward_ms']:.4f}; bound "
            f"{tot['bound_ms']:.4f} ms each way ({tot['bound_ms'] / tot['forward_ms']:.1%}, "
            f"{tot['bound_ms'] / tot['backward_ms']:.1%})")
    return rows


# what a phase reads from the phases before it
PHASE_NEEDS = {5: {2}, 7: {6}, 8: {4, 6}, 9: {6}, 12: {6}}


def phases_to_run(argv: list) -> set:
    """Every phase (2-16) with no arguments, as the script is run to hold the
    port; ``--phases N ...`` runs those and the phases they read, for a
    shorter run (the ``kernels`` line needs phases 2, 4, 5, 6 and 8)."""
    if not argv:
        return set(range(2, 17))
    if argv[0] != "--phases" or not all(a.isdigit() and 2 <= int(a) <= 16 for a in argv[1:]):
        raise SystemExit("usage: python3 chip_smoke.py [--phases N ...]   (N in 2..16)")
    want = {int(a) for a in argv[1:]}
    while True:
        more = want.union(*(PHASE_NEEDS.get(n, set()) for n in want))
        if more == want:
            return want
        want = more


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from wt_pse_tpu_torch.ops import covariance_cuda as cc
    from wt_pse_tpu_torch.runtime import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    from concurrent.futures import ThreadPoolExecutor

    from wt_pse_tpu_torch import native
    from wt_pse_tpu_torch.ops import batchnorm_cuda as bn
    from wt_pse_tpu_torch.ops import cuda_lib

    from wt_pse_tpu_torch.ops import upsample_cuda as up

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # nvcc three times and g++ at once
        cuda_build, native_build = pool.submit(cc.build), pool.submit(native.build)
        bn_build = pool.submit(cuda_lib.build, bn.SOURCE, "batchnorm")
        up_build = pool.submit(cuda_lib.build, up.SOURCE, "upsample")
        lib, compiler_out = cuda_build.result()
        bn_lib, bn_out = bn_build.result()
        up_lib, up_out = up_build.result()
        native_lib = native_build.result()
    log(f"built {lib.name}, {bn_lib.name}, {up_lib.name} and {native_lib.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (compiler_out + bn_out + up_out).splitlines():  # each kernel, then its numbers
        if "Function properties for" in line or "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    log(card_line())

    def phase(n: int, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {n} took {time.perf_counter() - t0:.1f} s")
        return out

    want = phases_to_run(sys.argv[1:])
    errs = phase(2, check_kernels, cc, dev) if 2 in want else None
    if 3 in want:
        phase(3, check_against_cpu, dev)
    f32_step_ms = phase(4, main_path, cc, dev) if 4 in want else None
    rows = phase(5, time_kernels, cc, dev, errs) if 5 in want else None
    p6 = p8 = p10 = p11 = p12 = None
    with tempfile.TemporaryDirectory() as tmp:
        if 6 in want:
            p6 = phase(6, trainer_path, cc, dev, tmp)
        if 7 in want:
            phase(7, eval_path, cc, dev, tmp, p6)
        if 8 in want:
            p8 = phase(8, bf16_path, cc, dev, tmp, f32_step_ms, p6)
        if 9 in want:
            phase(9, joint_path, cc, dev, tmp, p6)
        if 10 in want:
            p10 = phase(10, dp_path, tmp)
        if 11 in want:
            p11 = phase(11, spatial_path, cc, dev, tmp)
        if 12 in want:
            p12 = phase(12, graph_path, cc, dev, tmp, p6["train"], p6["val"])
        if 13 in want:
            phase(13, cli_path, tmp, p6)
        if 14 in want:
            phase(14, local_mesh_path, cc, dev, p11)
    bn_rows = phase(15, time_batchnorm, dev) if 15 in want else None
    up_rows = phase(16, time_upsample, dev) if 16 in want else None
    for dtype, name in (("float32", "WT_PSE f32"), ("bfloat16", "WT_PSE bf16")):
        if p10 is None or p12 is None:
            break
        dp_g, one = p10[dtype]["graph"], p12[name]["graph"]
        log(f"the DP graph (phase 10 (a), world 1 over NCCL) against the single-device graph "
            f"(phase 12), {dtype}, this call, {card_line()}: steady epoch "
            f"{steady_epoch(dp_g):.4f} s against {steady_epoch(one):.4f} s "
            f"({steady_epoch(dp_g) / steady_epoch(one):.3f}x); card busy "
            f"{dp_g['profile']['busy_share']:.1%} against {one['profile']['busy_share']:.1%}; "
            f"the graph's pool {dp_g['pool_gib']:.2f} against "
            f"{p12[name]['graph_pool_gib']:.2f} GiB")
    for row in rows or []:  # the counts of the trainers' runs: f32 phase 6, bf16 phase 8
        row["launches"] = (p8 if row["name"].endswith("_bf16") else p6)["launches"][row["name"]]
    for row in bn_rows or []:
        run = p8 if row["dtype"] == "bfloat16" else p6
        if run is not None:
            key = row["name"] + ("_bf16" if row["dtype"] == "bfloat16" else "")
            row.update(launches=run["launches"][key], steps=run["steps"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if up_rows is not None:
        print(json.dumps({"upsample_kernels": up_rows}))
    if bn_rows is not None:
        print(json.dumps({"batchnorm_kernels": bn_rows}))
    if rows is not None:
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
