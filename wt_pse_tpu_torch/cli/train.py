"""Training CLI of the port, with the flag surface of ``wt_pse_tpu/cli/train.py``
(the reference's ``train.py:182-211``) plus ``--device``:

    python -m wt_pse_tpu_torch.cli.train --datasetTrain 1 2 4 --datasetTest 3 \\
        --label OD --data-dir /path/to/Fundus --batch-size 9 [config.yaml ...]

It runs on the card (``-g`` picks its index) unless ``--device cpu`` is given,
trains ``--running_times`` times and prints the mean±std of the 6 best
metrics (train.py:174-175). ``--algorithm`` is ``WT_PSE`` (the default) or
``Unet_nips2023_joint_shape_regularization``; the hparam leftover
``--compute_dtype bfloat16`` trains in bf16 mixed precision.

Data parallelism: start one process per card with torchrun, which sets the
process group's environment (``parallel/distributed.py``); each process
trains on the card ``LOCAL_RANK`` and rank 0 writes the run directory:

    torchrun --nproc-per-node 4 -m wt_pse_tpu_torch.cli.train --dp \
        --batch-size 12 --datasetTrain 1 2 4 --datasetTest 3 --label OD ...

Under torchrun ``--dp`` is on by default (auto) when the per-domain batch
divides over more than one rank; ``--no-dp`` trains one device.
"""

from __future__ import annotations

import argparse
import os
from datetime import date

import numpy as np
import torch

from wt_pse_tpu_torch.config import default_hparams, load_config
from wt_pse_tpu_torch.data.fundus import load_fundus, load_train_domains
from wt_pse_tpu_torch.parallel.distributed import initialize_multihost, rank_and_world
from wt_pse_tpu_torch.runtime import resolve_device
from wt_pse_tpu_torch.train.trainer import Trainer
from wt_pse_tpu_torch.utils.seed import seed_initialization


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-g", "--gpu", type=int, default=0,
                   help="index of the CUDA card to train on (with --device cuda)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="train on the card, or on the CPU")
    p.add_argument("--resume", default=None, help="checkpoint path")
    p.add_argument("--datasetTrain", nargs="+", type=int, default=[1, 2, 4],
                   help="train domain ids in [1,2,3,4]")
    p.add_argument("--datasetTest", nargs="+", type=int, default=[3],
                   help="test domain id, one of [1,2,3,4]")
    p.add_argument("--batch-size", type=int, default=9)
    p.add_argument("--group-num", type=int, default=1)
    p.add_argument("--max-epoch", type=int, default=200)
    p.add_argument("--stop-epoch", type=int, default=200)
    p.add_argument("--interval-validate", type=int, default=1)
    p.add_argument("--lr_od", type=float, default=5e-4)
    p.add_argument("--lr_od_shape", type=float, default=5e-4)
    p.add_argument("--lr_oc", type=float, default=5e-4)
    p.add_argument("--lr_oc_shape", type=float, default=5e-4)
    p.add_argument("--lr-decrease-rate", type=float, default=0.2)
    p.add_argument("--lam", type=float, default=0.9)
    p.add_argument("--data-dir", default="./dataset/")
    p.add_argument("--out", default=None, help="run output directory")
    p.add_argument("--out-stride", type=int, default=16)
    p.add_argument("--dataset", type=str, default="fundus")
    p.add_argument("--algorithm", type=str, default="WT_PSE")
    p.add_argument("configs", nargs="*")
    p.add_argument("--label", type=str, default="OD")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--running_times", type=int, default=3,
                   help="independent trainings to aggregate (mean±std of the 6 best "
                        "metrics, train.py:174-175). Run r uses seed+r, so the std "
                        "is seed variance; the reference re-seeds identically each "
                        "time (train.py:53-54): pass --identical-reruns for that")
    p.add_argument("--identical-reruns", action="store_true",
                   help="re-seed every repetition with the same --seed, as the "
                        "reference does (see --running_times)")
    p.add_argument("--lr-schedule", action="store_true",
                   help="enable the linear-warmup + milestone-step-decay lr schedule "
                        "(the reference's Trainer.lr_update, Trainer.py:989-1004, "
                        "whose call is commented out at Trainer.py:1040)")
    p.add_argument("--lr-warmup-epochs", type=int, default=None,
                   help="lr_update warmup_steps; default max_epoch * 2 (Trainer.py:1020)")
    p.add_argument("--lr-warmup-factor", type=float, default=None,
                   help="lr_update warmup_factor; default 0.001 (Trainer.py:1017)")
    p.add_argument("--lr-gamma", type=float, default=None,
                   help="lr_update gamma; default 0.5 (Trainer.py:1019)")
    p.add_argument("--lr-milestones", nargs="*", type=int, default=None,
                   help="lr_update Steps (bisect_right); default 100 150 (Trainer.py:1018)")
    p.add_argument("--lr-clamp-warmup", action="store_true",
                   help="clamp the warmup factor at 1 after warmup (see train/lr.py)")
    p.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard event files under out/tensorboard")
    p.add_argument("--per-step-logging", action="store_true",
                   help="write every iteration's scalars to metrics.jsonl "
                        "(kind=step records)")
    p.add_argument("--train-visualization", action="store_true",
                   help="log train image grids (ROI image, attention, OC target and "
                        "prediction of a batch's first sample) under images/")
    p.add_argument("--train-viz-interval", type=int, default=30,
                   help="iterations between train image grids")
    p.add_argument("--fast-validation", action="store_true",
                   help="validate on the device at network resolution instead of "
                        "at native resolution on the host")
    p.add_argument("--nan-recovery", action="store_true",
                   help="roll back to the last finite epoch instead of raising on a "
                        "non-finite loss")
    p.add_argument("--dp", dest="dp", action="store_true", default=None,
                   help="force data parallelism over every rank torchrun started "
                        "(one process per card; sync-BN, gradient mean and MMD "
                        "all-gather over the process group). Default: auto - enabled "
                        "whenever the process group has more than one rank; note "
                        "auto-DP changes the per-seed sampling stream against a "
                        "single-card run (use --no-dp to reproduce single-device "
                        "numerics) [addition over the reference]")
    p.add_argument("--no-dp", dest="dp", action="store_false",
                   help="force single-device training even under torchrun")
    p.add_argument("--dp-devices", type=int, default=None,
                   help="cap the data-parallel mesh at N ranks (default: all of them)")
    p.add_argument("--compile-cache", default="",
                   help="accepted for flag parity and ignored: the port compiles "
                        "nothing ahead of time")
    return p


def _repair_left_argv(left_argv: list[str], configs: list[str]):
    """argparse's ``configs`` positional (nargs='*') steals the value of any
    unknown ``--key value`` pair, leaving a dangling ``--key`` in the
    leftovers. Re-pair each dangling key with the next positional that is not
    a config file, in order; ``--key=value`` never hits this. Refuses an
    ambiguous count (a value-less boolean flag would steal a value)."""

    def looks_like_config(c):
        # a mistyped overlay path should say "not found", not become a value
        return c.endswith((".yaml", ".yml")) or os.path.exists(c)

    orphans = [c for c in configs if not looks_like_config(c)]
    real_configs = [c for c in configs if looks_like_config(c)]
    dangling = [j for j, tok in enumerate(left_argv)
                if tok.startswith("--") and "=" not in tok
                and (j + 1 >= len(left_argv) or left_argv[j + 1].startswith("--"))]
    if orphans and len(dangling) != len(orphans):
        raise SystemExit(
            f"ambiguous hparam arguments: {len(orphans)} positional value(s) "
            f"{orphans} vs {len(dangling)} value-less flag(s) "
            f"{[left_argv[j] for j in dangling]} — cannot re-pair safely; "
            "use --key=value form for hparam overrides")
    out, oi = [], 0
    for j, tok in enumerate(left_argv):
        out.append(tok)
        if j in dangling and oi < len(orphans):
            out.append(orphans[oi])
            oi += 1
    for c in real_configs:
        if not os.path.exists(c):
            print(f"WARNING: config overlay not found: {c}")
    return out, real_configs


def main(args=None, left_argv=None):
    parser = build_parser()
    if args is None:
        args, left_argv = parser.parse_known_args()
    elif isinstance(args, (list, tuple)):
        args, extra = parser.parse_known_args([str(a) for a in args])
        left_argv = list(left_argv or []) + extra
    left_argv, args.configs = _repair_left_argv(list(left_argv or []), list(args.configs))
    # under torchrun: join the process group; this rank trains on the card
    # LOCAL_RANK, which initialize_multihost made current
    multi = initialize_multihost(backend=None if args.device == "cuda" else "gloo")
    gpu = (f"cuda:{torch.cuda.current_device()}" if multi and torch.cuda.is_available()
           else f"cuda:{args.gpu}")
    device = resolve_device(gpu if args.device == "cuda" else "cpu")
    is_main = rank_and_world()[0] == 0
    result = {k: [] for k in ("DSC_OC", "HD_OC", "ASD_OC", "DSC_OD", "HD_OD", "ASD_OD")}
    out_root = args.out or os.path.join(
        "runs", f"Unet2D_{args.label}_{date.today()}_target{args.datasetTest[0]}")

    for run_idx in range(args.running_times):
        print("-" * 10, f"{args.algorithm}", "-" * 10)
        hparams = default_hparams(args.algorithm, args.dataset)
        yamls = [p for p in ["config.yaml"] + list(args.configs) if os.path.exists(p)]
        hparams = load_config(hparams, yamls, left_argv or [])

        run_seed = args.seed if args.identical_reruns else args.seed + run_idx
        seed_initialization(run_seed)
        if run_idx == 0 and is_main:  # one writer of the shared run directory
            from wt_pse_tpu_torch.utils.snapshot import save_code

            save_code(out_root, hparams)

        trainer = Trainer(
            hparams=hparams,
            train_domains=load_train_domains(args.data_dir, args.datasetTrain),
            val_domain=load_fundus(args.data_dir, "test", args.datasetTest,
                                   state="prediction"),
            out_dir=os.path.join(out_root, f"run{run_idx}"),
            label=args.label,
            batch_size=args.batch_size,
            max_epoch=args.max_epoch,
            stop_epoch=args.stop_epoch,
            interval_validate=args.interval_validate,
            lr_od=args.lr_od,
            lr_od_shape=args.lr_od_shape,
            lr_oc=args.lr_oc,
            lr_oc_shape=args.lr_oc_shape,
            seed=run_seed,
            resume=args.resume if run_idx == 0 else None,
            algorithm=args.algorithm,
            tensorboard=args.tensorboard,
            per_step_logging=args.per_step_logging,
            train_visualization=args.train_visualization,
            train_viz_interval=args.train_viz_interval,
            fast_validation=args.fast_validation,
            nan_recovery=args.nan_recovery,
            dp=args.dp,
            dp_devices=args.dp_devices,
            lr_schedule=(dict(warmup_steps=args.lr_warmup_epochs,
                              warmup_factor=args.lr_warmup_factor,
                              gamma=args.lr_gamma,
                              milestones=args.lr_milestones,
                              clamp_warmup=args.lr_clamp_warmup)
                         if args.lr_schedule else None),
            device=device,
        )
        best = trainer.train()
        for key, value in zip(result.keys(), best):
            result[key].append(value)

    for key in result:
        # ddof=1 as the reference (train.py:174-175); one run has no spread
        spread = np.std(result[key], ddof=1) if len(result[key]) > 1 else 0.0
        print(f"Domain:{args.datasetTest[0]}", f"{key}:{np.mean(result[key])}+_{spread}")
    return result


if __name__ == "__main__":
    main()
