"""The training orchestrator (counterpart of ``wt_pse_tpu/train/trainer.py``,
after the reference's ``Trainer.py:58-1060``), on one device or data-parallel
over the ranks of a process group.

- The train pools live on the device as uint8 (:func:`stack_domains`); each
  step samples, augments and normalises its batch there
  (``data/augment.py``) and runs the 4-phase step (``train/step.py``). The
  step's metrics stay device tensors; they are stacked and fetched once an
  epoch, so the loop makes no host sync a step.
- Two drivers run an epoch, chosen by ``scan_epochs`` (the JAX Trainer's
  name): the graph (``train/graph.py``), the sample + step captured once as
  a CUDA graph at construction and replayed once a step, the counterpart of
  JAX's one-program ``lax.scan`` epoch; and the eager loop, one Python call
  of each a step. ``None`` (the default) takes the graph on a CUDA card,
  on one device or data-parallel over NCCL (the graph then holds the step's
  collectives: JAX's ``epoch`` over ``make_dp_fused``), and the loop on the
  CPU and over gloo, whose host-staged collectives cannot be captured;
  ``True`` asks for the graph and raises where it cannot run; ``False``
  takes the loop.
  Both consume the run's generator alike, so they draw the same batches.
  The graph's Adams are capturable (f32 bias corrections on the device), so
  its updates differ from the loop's in the last ulps. ``run_meta.json``
  records the driver that ran.
- ``iter_per_epoch = total_samples // batch_size`` (Trainer.py:1011-1015).
- Validation every ``interval_validate`` epochs once ``epoch > 2``
  (Trainer.py:1048): the two-stage predict on the device, the upsample to the
  native label resolution, post-processing and metrics on the host
  (``train/eval.py``, native C++ or scipy scoring), or with
  ``fast_validation`` all of it on the device at network resolution
  (``train/eval_device.py``).
- ``train_visualization``: after step ``g`` with ``g % train_viz_interval ==
  0``, sample 0 of the batch that step trained on goes through the two-stage
  forward in eval mode (:func:`viz_forward`) and ``train/image``,
  ``train/shape_cup``, ``train/target_cup`` and ``train/pre_cup`` are logged
  (Trainer.py:927-951). It draws nothing from the run's generator, so a run
  with and without it trains alike.
- Best-model selection by ``label`` (OD -> disc Dice, OC -> cup Dice),
  ``checkpoint_{epoch+1}.pth.tar``, ``best.json`` and ``score.txt`` on a new
  best; returns ``[best_cup_dice, best_cup_hd, best_cup_asd, best_disc_dice,
  best_disc_hd, best_disc_asd]``.

Randomness: the weights come from a CPU generator seeded with ``seed``. At
the start of each epoch the device generator that draws the batch indices,
the augmentation and the step's N(0, 1) draws is re-seeded from ``(seed,
epoch)``, so a run resumed at an epoch draws what the uninterrupted run drew
(the JAX trainer's ``fold_in(run_key, step)`` property).

``algorithm`` is ``WT_PSE`` or the joint variant
(``Unet_nips2023_joint_shape_regularization``: :class:`JointShapeReg` nets,
no distillation phases, its own predict, and the per-epoch loss-trace files
of the reference's joint epoch). ``hparams['compute_dtype']`` may be
``'bfloat16'`` for either (``models/layers.py``); ``run_meta.json`` records
it.

Data parallelism (``dp``, ``dp_devices``; ``parallel/dp.py``): one process
per card, started by torchrun, the nets built with sync BatchNorm over the
mesh of the first N ranks, each rank sampling its own share of every domain
(its generator seeded from (seed, epoch) and its rank, unchanged at N = 1),
and the DP step's collectives. Rank 0 writes the run directory (the others
log nothing) and the checkpoints, then every rank passes a barrier.
Validation predicts batch-sharded when N divides ``eval_batch_size``, and
rank 0's numbers decide the best model on every rank. The state is
replicated, so checkpoints and resume do not depend on N; every rank loads
the same file to resume.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from wt_pse_tpu_torch import native
from wt_pse_tpu_torch.data.augment import make_device_batch_fn
from wt_pse_tpu_torch.data.fundus import FundusDomain, encode_masks
from wt_pse_tpu_torch.io.checkpoint import restore_ensemble, save_ensemble
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.parallel.collectives import barrier, broadcast_floats, gather_objects
from wt_pse_tpu_torch.parallel.distributed import rank_and_world
from wt_pse_tpu_torch.parallel.dp import choose_ranks, make_dp_fused, rank_seed
from wt_pse_tpu_torch.parallel.mesh import data_mesh
from wt_pse_tpu_torch.parallel.spatial import batch_sharded
from wt_pse_tpu_torch.runtime import resolve_device
from wt_pse_tpu_torch.config.hparams import ALGORITHMS, JOINT
from wt_pse_tpu_torch.train.eval import evaluate_domain, make_predict_fn_for
from wt_pse_tpu_torch.train.eval_device import evaluate_domain_device
from wt_pse_tpu_torch.train.graph import GraphedStep
from wt_pse_tpu_torch.train.lr import epoch_lrs, reference_lr_kwargs, reference_lr_value
from wt_pse_tpu_torch.train.state import WTPSETrainState, copy_state_, init_ensemble, set_lr_
from wt_pse_tpu_torch.train.step import StepConfig, make_train_step
from wt_pse_tpu_torch.utils.logging import RunLogger
from wt_pse_tpu_torch.utils.trace import StampedSteps, Tracer, write_chrome

_LR_KEYS = {"warmup_steps", "warmup_factor", "gamma", "milestones", "clamp_warmup"}


def stack_domains(domains: list[FundusDomain], device: torch.device) -> dict:
    """Pad the per-domain pools to a common N and put them on ``device`` as
    uint8: ``images`` (D, Nmax, H, W, 3), ``labels`` (D, Nmax, H, W) and the
    true ``sizes`` (D,)."""
    nmax = max(len(d) for d in domains)
    imgs, labs = [], []
    for d in domains:
        pad = nmax - len(d)
        im, lb = np.asarray(d.images, np.uint8), np.asarray(d.labels, np.uint8)
        if pad:
            im = np.concatenate([im, np.zeros((pad,) + im.shape[1:], im.dtype)])
            lb = np.concatenate([lb, np.zeros((pad,) + lb.shape[1:], lb.dtype)])
        imgs.append(im)
        labs.append(lb)
    return {"images": torch.from_numpy(np.stack(imgs)).to(device),
            "labels": torch.from_numpy(np.stack(labs)).to(device),
            "sizes": torch.tensor([len(d) for d in domains], dtype=torch.int64,
                                  device=device)}


def _draw_seed(seed: int, epoch: int, salt: int = 0) -> int:
    """A 63-bit generator seed from (seed, epoch, salt)."""
    digest = hashlib.sha256(f"{seed}:{epoch}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def graph_refusal(device: torch.device, mesh) -> str | None:
    """Why the epoch cannot run as a CUDA graph on ``device`` over the data
    mesh ``mesh`` (None when not data-parallel), or None where it can. The
    graph holds the data-parallel step's collectives: NCCL's capture, gloo's
    host-staged ones cannot, and a mesh without a process group has none."""
    backend = dist.get_backend(mesh.group) if mesh is not None and mesh.group is not None \
        else None
    if backend not in (None, "nccl"):
        return f"{backend}'s host-staged collectives cannot be captured"
    if device.type != "cuda":
        return f"a graph cannot be captured on {device}: it needs a CUDA card"
    return None


@torch.no_grad()
def viz_forward(main_od: torch.nn.Module, main_oc: torch.nn.Module, batch: dict):
    """The train-image forward (the JAX Trainer's ``viz_forward``,
    trainer.py:319-356): the two-stage forward of the training nets in eval
    mode with zero shape noise; the OC logits are masked by the OD prediction
    before any threshold (Trainer.py:873,944). Returns sample 0's ROI image,
    OC attention mask (zeros without one), OC target and OC logits, each
    (C, H, W) and f32. The nets are left in eval mode; the step puts them
    back in train mode."""
    image, t_od, t_oc = batch["image"], batch["target_od"], batch["target_oc"]
    main_od.eval()
    main_oc.eval()
    eps = torch.zeros_like(t_od)
    out_od, _, _ = main_od(image, t_od, image, eps=eps)
    od_pred = (torch.sigmoid(out_od) > 0.75).to(image.dtype)
    roi = (image + 1.0) * od_pred - 1.0
    out_oc, att_oc, _ = main_oc(roi, t_oc, roi, eps=eps)
    out_oc = out_oc.float() * od_pred
    if att_oc is None:
        att_oc = torch.zeros_like(out_oc)
    return roi[0], att_oc[0].float(), t_oc[0], out_oc[0]


class Trainer:
    def __init__(
        self,
        hparams: dict,
        train_domains: list[FundusDomain],
        val_domain: FundusDomain,
        out_dir: str,
        label: str | None = "OD",
        batch_size: int = 9,
        max_epoch: int = 200,
        stop_epoch: int | None = None,
        interval_validate: int = 10,
        lr_od: float = 5e-4,
        lr_od_shape: float = 5e-4,
        lr_oc: float = 5e-4,
        lr_oc_shape: float = 5e-4,
        seed: int = 1,
        replicate_ref_quirks: bool = True,
        eval_batch_size: int = 8,
        image_size: int = 256,
        resume: str | None = None,
        algorithm: str = "WT_PSE",
        trace_dir: str | None = None,
        nan_recovery: bool = False,
        fast_validation: bool = False,
        tensorboard: bool = False,
        val_visualization: bool = True,
        per_step_logging: bool = False,
        train_visualization: bool = False,
        train_viz_interval: int = 30,
        lr_schedule: dict | None = None,
        scan_epochs: bool | None = None,
        dp: bool | None = None,
        dp_devices: int | None = None,
        device: str | torch.device = "cuda",
    ):
        """``dp``: data parallelism over the ranks of the process group
        (``parallel/distributed.py::initialize_multihost``; one process a
        card, ``device`` this rank's card). ``None`` turns it on when the
        group has more than one rank; ``dp_devices`` caps N; under auto, N
        falls to the largest divisor of the per-domain batch, and an explicit
        ``dp=True`` with an indivisible batch raises (``parallel/dp.py::
        choose_ranks``). A rank outside the chosen N raises rather than train
        a copy of its own. ``dp=False`` trains on the one ``device``.

        Reproducibility: the same seed takes another, statistically
        equivalent, trajectory under data parallelism on more than one rank
        (each rank samples its own stream; BatchNorm sums in another order);
        ``dp=False`` reproduces a single-device run.

        ``scan_epochs``: the epoch driver (module docstring). ``True`` raises
        ``ValueError`` off CUDA (a CUDA graph needs a card) and under data
        parallelism over gloo (its collectives cannot be captured); under
        NCCL every rank captures the data-parallel step at construction, in
        lockstep, and a capture that fails raises: nothing falls back to the
        loop.

        Tracing (``utils/trace.py``): the host spans of set-up, epochs,
        replays, validations and checkpoints go to :attr:`tracer`, always.
        ``trace_dir`` turns the graph's device spans on from construction
        (:meth:`start_device_spans`) and makes :meth:`train` end by writing
        ``spans.json`` there."""
        self.tracer = Tracer()
        init = self.tracer.begin("trainer.init")
        self.device = resolve_device(device)
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; have {ALGORITHMS}")
        if train_viz_interval <= 0:  # "off" is train_visualization=False
            raise ValueError(f"train_viz_interval must be >= 1, got {train_viz_interval}")
        self.domain_num = len(train_domains)
        self.per_domain_batch = batch_size // self.domain_num
        if self.per_domain_batch < 1:
            raise ValueError(
                f"batch_size={batch_size} gives zero samples per domain for "
                f"{self.domain_num} train domains; need batch_size >= domain count")
        if label not in ("OC", "OD"):
            # the reference's 2-class training crashes at its first loss
            # (train.py:84-92 + Trainer.py:787); only its validation takes it
            raise ValueError(
                f"label must be 'OD' or 'OC' for training (got {label!r}); the "
                "reference's 2-class (label=None) training path does not run")
        if batch_size % self.domain_num:
            print(f"[trainer] batch_size {batch_size} is not divisible by "
                  f"{self.domain_num} domains: effective batch is "
                  f"{self.per_domain_batch * self.domain_num} "
                  f"({self.per_domain_batch}/domain, reference floor-division semantics)")
        self._lr_kwargs = None
        if lr_schedule is not None:
            unknown = set(lr_schedule) - _LR_KEYS
            if unknown:
                raise ValueError(f"unknown lr_schedule key(s) {sorted(unknown)}; "
                                 f"allowed: {sorted(_LR_KEYS)} (see train/lr.py)")
            kw = reference_lr_kwargs(max_epoch)
            kw.update({k: v for k, v in lr_schedule.items() if v is not None})
            self._lr_kwargs = kw

        self.rank, world = rank_and_world()
        auto_dp = dp is None
        self.dp, self.n_dev = choose_ranks(dp, dp_devices, self.per_domain_batch, world)
        self.mesh = data_mesh(self.n_dev) if self.dp else None  # collective: every rank
        if self.rank >= self.n_dev:
            raise ValueError(
                f"rank {self.rank} of {world} is outside the {self.n_dev}-rank "
                f"{'data-parallel group' if self.dp else 'single-device run'} this "
                f"configuration trains on (per-domain batch {self.per_domain_batch}); launch "
                f"{self.n_dev} process(es): torchrun --nproc-per-node {self.n_dev}")
        why = graph_refusal(self.device, self.mesh)
        if scan_epochs and why:
            raise ValueError(f"scan_epochs=True runs the epoch as a CUDA graph"
                             f"{', the data-parallel collectives included' if self.dp else ''}"
                             f": {why} (pass scan_epochs=None or False)")
        self.scan_epochs = why is None if scan_epochs is None else bool(scan_epochs)
        if self.dp:
            print(f"[trainer] data-parallel over {self.n_dev} ranks: "
                  f"{self.per_domain_batch // self.n_dev}/domain/rank, global batch "
                  f"{self.per_domain_batch * self.domain_num}")
        # rank 0 owns the run directory; the other ranks write nothing
        self.is_main_process = self.rank == 0

        self.hparams = dict(hparams)
        self.label = label
        self.out = out_dir
        self.logger = RunLogger(out_dir, tensorboard=tensorboard,
                                null=not self.is_main_process)
        self.max_epoch = max_epoch
        self.stop_epoch = stop_epoch if stop_epoch is not None else max_epoch
        self.interval_validate = interval_validate
        self.eval_batch_size = eval_batch_size
        self.iter_per_epoch = max(sum(len(d) for d in train_domains) // batch_size, 1)
        self.seed = seed
        self.lr_od, self.lr_od_shape = lr_od, lr_od_shape
        self.lr_oc, self.lr_oc_shape = lr_oc, lr_oc_shape

        self.algorithm = algorithm
        self.cfg = ModelConfig.from_hparams(self.hparams, bn_mesh=self.mesh)  # sync BN under DP
        with self.tracer.span("init_ensemble"):
            self.state: WTPSETrainState = init_ensemble(
                self.cfg, device=self.device, generator=torch.Generator().manual_seed(seed),
                lr_od=lr_od, lr_od_shape=lr_od_shape, lr_oc=lr_oc, lr_oc_shape=lr_oc_shape,
                algorithm=algorithm, capturable=self.scan_epochs)
        with self.tracer.span("stack_domains"):
            self.data = stack_domains(train_domains, self.device)
        if self.dp:
            fused = make_dp_fused([ns.net for ns in self.state.net_states()], self.hparams,
                                  self.mesh, self.domain_num, self.per_domain_batch,
                                  replicate_ref_quirks, distill=algorithm != JOINT,
                                  device=self.device)
            self._batch_fn, self._train_step = fused.batch_fn, fused.train_step
        else:
            self._batch_fn = make_device_batch_fn(self.per_domain_batch, device=self.device)
            self._train_step = make_train_step(
                StepConfig(self.hparams, self.domain_num, self.per_domain_batch,
                           replicate_ref_quirks, distill=algorithm != JOINT),
                device=self.device)
        # validation rides the mesh when N divides the eval chunk (the wrapper
        # pads a chunk to a multiple of N; JAX's trainer.py:372-391)
        self._shard_eval = self.dp and eval_batch_size % self.n_dev == 0
        if self.dp and not self._shard_eval:
            print(f"[trainer] eval_batch_size {eval_batch_size} not divisible by "
                  f"{self.n_dev} ranks - validation runs unsharded (single device)")
        self._gen = torch.Generator(device=self.device)
        self._rollbacks = 0
        self._graph: GraphedStep | None = None
        self._last_batch: dict | None = None  # the eager loop's latest batch

        # validation: images on the device, masks at native resolution
        self.val_images = torch.from_numpy(np.asarray(val_domain.images, np.uint8)).to(self.device)
        self.val_od, self.val_oc = [], []
        for lab in val_domain.labels:
            od, oc = encode_masks(np.asarray(lab, np.uint8))
            self.val_od.append(od)
            self.val_oc.append(oc)
        self.val_visualization = val_visualization
        self.fast_validation = fast_validation
        self.train_visualization = train_visualization
        self.train_viz_interval = train_viz_interval
        if fast_validation or val_visualization:  # the masks at network resolution
            from PIL import Image

            masks = [encode_masks(np.asarray(
                Image.fromarray(np.asarray(lab, np.uint8)).resize((image_size, image_size)),
                np.uint8)) for lab in val_domain.labels]
            self._val_od_256 = np.stack([od for od, _ in masks])
            self._val_oc_256 = np.stack([oc for _, oc in masks])
        # what scored the last validation: 'native' or 'scipy' on the host, or
        # 'device' (fast_validation)
        self.scoring_backend: str | None = None

        self.per_step_logging = per_step_logging
        self.best = {"objective": 0.0, "epoch": -1}
        self.best_list = [0.0] * 6
        self.epoch = 0
        self.trace_dir = trace_dir
        self.nan_recovery = nan_recovery
        self._last_good: WTPSETrainState | None = None

        meta_name = "run_meta.json"
        if resume:
            # the full ensemble with its optimizers, and the step count; before
            # the capture, and in place (a capturable Adam keeps its tensors)
            restore_ensemble(resume, self.state)
            self.epoch = self.state.step // self.iter_per_epoch
            best_json = os.path.join(os.path.dirname(os.path.abspath(resume)), "best.json")
            if os.path.exists(best_json):
                with open(best_json) as f:
                    rec = json.load(f)
                self.best = {"objective": float(rec["objective"]), "epoch": int(rec["epoch"])}
                self.best_list = [float(v) for v in rec["best_list"]]
                print(f"restored best: objective {self.best['objective']:.4f} "
                      f"at epoch {self.best['epoch']}")
            print(f"resumed from {resume} at step {self.state.step} (epoch {self.epoch})")
            n = 1  # a resumed run keeps the record of the run it continues
            while os.path.exists(os.path.join(out_dir, meta_name)):
                meta_name = f"run_meta.resume{n}.json"
                n += 1

        if self.scan_epochs:
            # the batch's shapes from a throwaway generator: the run's draws nothing
            probe = self._batch_fn(self.data, torch.Generator(device=self.device).manual_seed(0))
            self._graph = GraphedStep(self.state, self._train_step, probe,
                                      capacity=self.iter_per_epoch, batch_fn=self._batch_fn,
                                      data=self.data, generator=self._gen, tracer=self.tracer,
                                      marks=trace_dir is not None)
            self._graph.capture()
            print(f"[trainer] captured the step as a CUDA graph in "
                  f"{self._graph.capture_seconds:.2f} s; its memory pool "
                  f"{self._graph.pool_bytes / 2 ** 30:.2f} GiB")

        self.logger.run_meta({
            "algorithm": algorithm, "label": label, "seed": seed,
            "batch_size": batch_size, "image_size": image_size,
            "max_epoch": max_epoch, "stop_epoch": self.stop_epoch,
            "replicate_ref_quirks": replicate_ref_quirks,
            "compute_dtype": str(self.hparams.get("compute_dtype", "float32")),
            "driver": "graph" if self.scan_epochs else "eager",
            "dp": {"requested": "auto" if auto_dp else bool(dp), "enabled": self.dp,
                   "n_devices": self.n_dev,
                   "reproduce_single_device": None if not self.dp else
                   "pass dp=False (cli: --no-dp): data parallelism re-decomposes the "
                   "per-seed sampling stream and the BatchNorm summation order"},
            "resumed_from": resume or None,
            "n_processes": world,
            "platform": self.device.type,
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
        }, name=meta_name)
        self.tracer.end(init)

    @property
    def epoch_seconds(self) -> list[float]:
        """Host-clock seconds of each epoch's steps, to the end of the
        epoch's one device-to-host copy (its ``epoch`` span)."""
        return self.tracer.seconds("epoch")

    @property
    def enqueue_seconds(self) -> list[float]:
        """Host-clock seconds the host took to enqueue each epoch's steps, to
        the return of the last step call (its ``epoch.steps`` span)."""
        return self.tracer.seconds("epoch.steps")

    @property
    def validation_seconds(self) -> list[dict[str, float]]:
        """Each validation's seconds, split as its ``validate`` span's
        children: ``predict``, ``upsample`` and ``score`` on the host path,
        ``device`` on the fast one."""
        return [self.tracer.child_seconds(s) for s in self.tracer.closed("validate")]

    def start_device_spans(self) -> None:
        """Turn the graph's device spans on: the step is captured again with
        its marks, after the old graph is freed, and each later epoch keeps
        every step's stamps (:attr:`tracer`'s ``stamped``). Does nothing
        when they are on. Under data parallelism every rank must call it, in
        lockstep. Only the graph driver has device spans; the eager loop's
        ``sample`` is a host span."""
        if self._graph is None:
            raise RuntimeError("device spans need the graph driver (scan_epochs); the "
                               "eager loop records host spans only")
        self._graph.start_marks()

    def _save_val_montage(self, predict):
        """The reference's validation montage (utils.py:330-363,
        Trainer.py:188-199): ``[image | GT overlay | cup pred | disc pred]``
        for up to 4 images, under ``visualization/epoch_<N>.png``."""
        from PIL import Image

        from wt_pse_tpu_torch.utils.visualization import joint_val_image, save_val_img

        k = min(len(self.val_images), self.eval_batch_size, 4)
        norm = self.val_images[:k].to(torch.float32) / 127.5 - 1.0  # NHWC
        out_od, out_oc = predict(norm.permute(0, 3, 1, 2))  # on every rank: a collective
        if not self.is_main_process:
            return
        pred_od = (torch.sigmoid(out_od[:, 0]) > 0.75).cpu().numpy()
        pred_oc = (torch.sigmoid(out_oc[:, 0]) > 0.75).cpu().numpy()
        norm = norm.cpu().numpy()
        montages = [
            joint_val_image(norm[i], np.stack([pred_oc[i], pred_od[i]]).astype(np.float32),
                            np.stack([self._val_oc_256[i], self._val_od_256[i]]))
            for i in range(k)]
        path = save_val_img(self.out, self.epoch, montages)
        self.logger.image("val/montage", np.asarray(Image.open(path)), self.epoch)

    @property
    def last_batch(self) -> dict:
        """The batch the latest step trained on: the graph's static batch, or
        the eager loop's latest."""
        return self._graph.batch if self._graph is not None else self._last_batch

    def _save_train_montage(self, batch: dict, iteration: int):
        """Log sample 0 of ``batch`` through :func:`viz_forward`
        (Trainer.py:927-951): the OC-stage ROI image, the attention mask
        (whitening runs), the OC target and the thresholded OC prediction."""
        from wt_pse_tpu_torch.utils.visualization import untransform

        roi, att, t_oc, out_oc = (t.permute(1, 2, 0).cpu().numpy() for t in
                                  viz_forward(self.state.od.net, self.state.oc.net, batch))

        def gray_u8(a):
            a = np.clip(np.asarray(a, np.float32), 0.0, 1.0)
            return np.repeat((a * 255).astype(np.uint8), 3, axis=-1)

        self.logger.image("train/image", untransform(roi), iteration)
        if self.cfg.whitening:
            self.logger.image("train/shape_cup", gray_u8(att), iteration)
        self.logger.image("train/target_cup", gray_u8(t_oc), iteration)
        pred = (1.0 / (1.0 + np.exp(-out_oc)) > 0.75).astype(np.float32)
        self.logger.image("train/pre_cup", gray_u8(pred), iteration)

    def validate(self) -> dict:
        """Score the current nets on the validation domain, at native
        resolution on the host or, with ``fast_validation``, on the device.
        Its ``validate`` span holds the spans of the work (``predict`` /
        ``upsample`` / ``score`` on the host path, ``device`` on the fast
        one), read by ``validation_seconds``; the engine that scored is
        ``scoring_backend``. Under data parallelism every rank validates
        (batch-sharded when N divides ``eval_batch_size``) and every rank
        returns rank 0's numbers."""
        with self.tracer.span("validate", epoch=self.epoch):
            predict = make_predict_fn_for(self.algorithm,
                                          [ns.net for ns in self.state.net_states()],
                                          device=self.device)
            if self._shard_eval:
                predict = batch_sharded(predict, self.mesh)
            if self.val_visualization:
                self._save_val_montage(predict)
            if self.fast_validation:
                self.scoring_backend = "device"
                out = evaluate_domain_device(predict, self.val_images, self._val_od_256,
                                             self._val_oc_256, self.label,
                                             self.eval_batch_size, tracer=self.tracer)
            else:
                self.scoring_backend = native.scoring_backend("auto")
                out = evaluate_domain(predict, self.val_images, self.val_od, self.val_oc,
                                      self.label, self.eval_batch_size, tracer=self.tracer,
                                      backend=self.scoring_backend)
            if self.dp:
                # host scoring could differ between ranks; a rank that took the
                # other best-model branch would skip the checkpoint's barrier
                keys = sorted(out)
                out = dict(zip(keys, broadcast_floats([float(out[k]) for k in keys],
                                                      self.mesh)))
        return out

    def fused_step(self) -> dict[str, torch.Tensor]:
        """One eager sample + step on the run's state and generator (the JAX
        Trainer's ``fused_step``); returns the step's metrics. Its batch's
        making is a ``sample`` span with the global step."""
        with self.tracer.span("sample", step=self.state.step):
            self._last_batch = self._batch_fn(self.data, self._gen)
        return self._train_step(self.state, self._last_batch, generator=self._gen)

    def epoch_step(self, first_step: int, n_steps: int) -> dict[str, torch.Tensor]:
        """Steps ``first_step .. first_step + n_steps - 1`` of the run, by the
        trainer's driver: ``n_steps`` replays of the graph, or as many eager
        :meth:`fused_step` calls. Returns each metric's (n_steps,) stack on
        the device (the JAX Trainer's ``epoch_step``). What the steps draw is
        decided by the run's generator, which ``train`` re-seeds each epoch;
        ``first_step`` names the steps."""
        if self._graph is not None:
            return self._graph.replay(n_steps)
        ms = [self.fused_step() for _ in range(n_steps)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def _chunks(self, base: int) -> list[int]:
        """The epoch's steps from global step ``base`` cut into runs, each
        ending at a step ``g`` with ``g % train_viz_interval == 0`` (whose
        batch the montage shows), or the whole epoch as one run."""
        if not self.train_visualization:
            return [self.iter_per_epoch]
        ends = [it + 1 for it in range(self.iter_per_epoch)
                if (base + it) % self.train_viz_interval == 0]
        if not ends or ends[-1] != self.iter_per_epoch:
            ends.append(self.iter_per_epoch)
        return [b - a for a, b in zip([0] + ends[:-1], ends)]

    def _train_epoch(self, epoch: int) -> dict[str, float]:
        """One epoch of steps; returns the epoch means of the step metrics.
        Its ``epoch`` span holds ``epoch.set_lr`` (with a schedule),
        ``epoch.reseed``, ``epoch.steps`` (the steps' enqueueing: the graph's
        ``replay`` spans, the loop's ``sample`` spans) and ``epoch.copy``,
        the epoch's one device-to-host copy, where the host waits for the
        card. With device spans, the step's stamps come back in that copy and
        the device clock is read against the host's at the epoch's start and
        end (:class:`~wt_pse_tpu_torch.utils.trace.StampedSteps`)."""
        trace = self.tracer
        marks = self._graph.marks if self._graph is not None else None
        with trace.span("epoch", epoch=epoch):
            if self._lr_kwargs is not None:
                with trace.span("epoch.set_lr", epoch=epoch):
                    lrs = epoch_lrs(epoch, self.lr_od, self.lr_od_shape, self.lr_oc,
                                    self.lr_oc_shape, **self._lr_kwargs)
                    for ns, lr in zip(self.state.net_states(), lrs):
                        set_lr_(ns.opt, lr)
            with trace.span("epoch.reseed", epoch=epoch):
                self._gen.manual_seed(rank_seed(_draw_seed(self.seed, epoch, self._rollbacks),
                                                self.mesh))
            clock = [marks.clock_bracket()] if marks is not None else []
            base = epoch * self.iter_per_epoch
            stacks, stamps, done = [], [], 0
            with trace.span("epoch.steps", epoch=epoch):
                for n in self._chunks(base):
                    stacks.append(self.epoch_step(base + done, n))
                    if marks is not None:
                        stamps.append(self._graph.read_marks(n))
                    done += n
                    g = base + done - 1
                    if (self.train_visualization and self.is_main_process
                            and g % self.train_viz_interval == 0):
                        self._save_train_montage(self.last_batch, g)
            names = sorted(stacks[0])
            with trace.span("epoch.copy", epoch=epoch):
                # the one device-to-host copy of the epoch
                per_step = torch.stack([torch.cat([s[k] for s in stacks]) for k in names])
                if marks is None:
                    per_step = per_step.cpu().numpy()
                else:
                    per_step, stamps = _one_copy(per_step, torch.cat(stamps, dim=1))
            if marks is not None:
                clock.append(marks.clock_bracket())
                trace.stamped.append(StampedSteps(epoch, base, list(marks.names), stamps,
                                                  clock))
        if self.per_step_logging:
            self.logger.step_scalars_many(
                (base + it, {k: per_step[j, it] for j, k in enumerate(names)})
                for it in range(per_step.shape[1]))
        return {k: float(per_step[j].mean()) for j, k in enumerate(names)}

    def _checkpoint(self, epoch: int, best: bool = False) -> None:
        """``checkpoint_{epoch+1}.pth.tar`` and, for a new best, ``best.json``,
        written by rank 0; under data parallelism every rank then waits at a
        barrier, so none runs ahead of a checkpoint being written."""
        with self.tracer.span("checkpoint", epoch=epoch):
            if self.is_main_process:
                save_ensemble(os.path.join(self.out, f"checkpoint_{epoch + 1}.pth.tar"),
                              self.state)
                if best:
                    with open(os.path.join(self.out, "best.json"), "w") as f:
                        json.dump({"objective": self.best["objective"],
                                   "epoch": self.best["epoch"], "best_list": self.best_list}, f)
            if self.dp:
                barrier(self.mesh)

    def train(self) -> list[float]:
        """Train from :attr:`epoch` to ``max_epoch`` (or ``stop_epoch``);
        returns the best scores. With ``trace_dir``, ends by writing
        ``spans.json`` there (:meth:`write_spans`)."""
        best = self._train()
        if self.trace_dir is not None:
            self.write_spans(os.path.join(self.trace_dir, "spans.json"))
        return best

    def write_spans(self, path: str) -> None:
        """Every span of the run as a Chrome trace (``utils/trace.py``): a
        host and a device track per rank, on the host clock. Under data
        parallelism every rank must call it; rank 0 writes the file."""
        payload = (self.tracer.chrome_events(self.rank), self.tracer.clock_record())
        parts = gather_objects(payload, self.mesh) if self.dp else [payload]
        if self.is_main_process:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            write_chrome(path, [e for events, _ in parts for e in events],
                         [dict(c, rank=r) for r, (_, clocks) in enumerate(parts) for c in clocks])

    def _train(self) -> list[float]:
        for epoch in range(self.epoch, self.max_epoch):
            self.epoch = epoch
            t0 = time.perf_counter()
            metrics = self._train_epoch(epoch)
            if self._lr_kwargs is not None:
                # the reference's per-epoch 'lr'/'lr_shape' scalars read the
                # optimizers after lr_update(epoch): f(epoch), the lr of the
                # next epoch, the same for both (Trainer.py:1040-1044)
                lr_now = reference_lr_value(self.lr_od, epoch, applied_after_epoch=False,
                                            **self._lr_kwargs)
                lr_shape_now = lr_now
            else:
                lr_now, lr_shape_now = self.lr_od, self.lr_od_shape
            self.logger.scalars(epoch, dict(metrics, lr=lr_now, lr_shape=lr_shape_now))
            if self.algorithm == JOINT:
                # the loss-trace files of the reference's joint epoch
                # (Trainer.py:706-720): it zeroes these accumulators and never
                # adds to them there, so it appends 0.0; the joint step has
                # no *_shape metrics, so .get gives the same
                self.logger.loss_trace({
                    "ii": metrics.get("loss_ins_wt_shape_ii", 0.0),
                    "ij": metrics.get("loss_ins_wt_shape_ij", 0.0),
                    "all_ins": metrics.get("loss_ins_wt_shape", 0.0),
                    "domain": metrics.get("loss_dom_wt_shape", 0.0),
                })
            self.logger.epoch_summary(
                epoch, lr_now, metrics.get("loss_seg_oc", 0.0),
                metrics.get("loss_kd_oc", 0.0), metrics.get("loss_ins_wt_oc", 0.0),
                metrics.get("loss_dom_wt_oc", 0.0), time.perf_counter() - t0)

            def _csv(val=None):
                self.logger.csv_row(epoch, (epoch + 1) * self.iter_per_epoch,
                                    metrics.get("loss_seg", 0.0), val=val,
                                    train_cup=metrics.get("train_dice_oc"),
                                    train_disc=metrics.get("train_dice"))

            # the reference raises on both halves (Trainer.py:799, 884-885): the
            # OD and OC nets are disjoint, so an OC divergence never shows in loss_seg
            if not (np.isfinite(metrics.get("loss_seg", 0.0))
                    and np.isfinite(metrics.get("loss_seg_oc", 0.0))):
                if self.nan_recovery and self._last_good is not None:
                    print(f"[epoch {epoch}] non-finite loss - rolling back")
                    # in place: a captured graph keeps the state's tensors
                    copy_state_(self.state, self._last_good)
                    self._rollbacks += 1  # the next epochs draw afresh
                    _csv()
                    continue
                raise ValueError("loss is nan while training")  # Trainer.py:799-800
            if self.nan_recovery:
                self._last_good = copy.deepcopy(self.state)  # a copy on the device

            if self.stop_epoch == epoch:
                print(f"Stop epoch at {self.stop_epoch}")
                _csv()
                break

            if (epoch + 1) % self.interval_validate == 0 and epoch > 2:
                print("-" * 10, "start to validate", "-" * 10)
                val = self.validate()
                print(f"validation scored on: {self.scoring_backend}")
                _csv(val)
                self.logger.scalars(epoch, {f"val/{k}": v for k, v in val.items()})
                if val["objective"] > self.best["objective"]:
                    self.best = {"objective": val["objective"], "epoch": epoch + 1}
                    self.best_list = [val["cup_dice"], val["cup_hd"], val["cup_asd"],
                                      val["disc_dice"], val["disc_hd"], val["disc_asd"]]
                    self.logger.best_score(val)
                    self._checkpoint(epoch, best=True)
                elif (epoch + 1) % 300 == 0:
                    # Trainer.py:293-303: a periodic checkpoint every 300 epochs
                    self._checkpoint(epoch)
            else:
                _csv()
        return list(self.best_list)


def _one_copy(per_step: torch.Tensor, stamps: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """The metric stacks and the stamps on the host in one device-to-host
    copy: both as bytes, the int64 stamps first, so each part's offset suits
    its type."""
    blob = torch.cat([stamps.reshape(-1).view(torch.uint8),
                      per_step.reshape(-1).view(torch.uint8)]).cpu()
    k = stamps.numel() * stamps.element_size()
    return (blob[k:].view(per_step.dtype).reshape(per_step.shape).numpy(),
            blob[:k].view(torch.int64).reshape(stamps.shape).numpy())
