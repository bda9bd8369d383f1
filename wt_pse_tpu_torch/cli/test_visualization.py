"""Checkpoint evaluation and visualization CLI of the port (counterpart of
``wt_pse_tpu/cli/test_visualization.py``; the reference's
``test_visulization.py:45-277``):

    python -m wt_pse_tpu_torch.cli.test_visualization --datasetTest 4 --label OD \\
        --data-dir /path/to/Fundus --model-file /path/to/checkpoint.pth.tar \\
        --out ./vis_out [--save-images]

It rebuilds the 4 nets of ``--algorithm`` (``WT_PSE``, or the joint variant,
whose od and oc nets are ``JointShapeReg`` and predict through their own
priors), loads a ``.pth.tar`` (the reference's layout, or one the port's
Trainer wrote), runs the two-stage predict over the test split of the target
domain on the card (``-g`` picks it) unless ``--device cpu`` is given,
upsamples the logits to each label's native resolution, cleans them, prints
the Dice / HD95 / ASD means and the scoring backend, and with
``--save-images`` writes ``original_image/`` and ``overlay/``. Hparam
leftovers such as ``--compute_dtype bfloat16`` set the nets' compute dtype.

An orbax checkpoint directory (the JAX Trainer's format; the port does not
depend on orbax) raises ``ValueError`` naming the converter,
``scripts/orbax_to_pth.py``, which writes it as a ``.pth.tar`` where the JAX
package is installed. ``--packed`` is accepted and ignored: the port runs
unpacked, the same math.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wt_pse_tpu_torch import native
from wt_pse_tpu_torch.config import default_hparams, load_config
from wt_pse_tpu_torch.data.fundus import encode_masks, load_fundus
from wt_pse_tpu_torch.io.checkpoint import NET_KEYS, load_reference_checkpoint
from wt_pse_tpu_torch.models.common import ModelConfig
from wt_pse_tpu_torch.ops.postprocess import postprocess_logits
from wt_pse_tpu_torch.runtime import resolve_device
from wt_pse_tpu_torch.train.eval import evaluate_domain, make_predict_fn_for, resize_device
from wt_pse_tpu_torch.train.state import init_ensemble


def build_networks(model_file: str, hparams: dict, n_classes: int = 1,
                   algorithm: str = "WT_PSE", strict: bool = True,
                   device: str | torch.device = "cuda"):
    """The 4 nets (od, od_shape, oc, oc_shape) of ``algorithm`` on ``device``
    with a ``.pth.tar`` loaded into them (the reference's filtered partial
    load, test_visulization.py:122-197). ``strict`` (the default) raises if a
    checkpoint leaf has no slot in the nets (another algorithm or config);
    ``strict=False`` skips it, as the reference does."""
    if os.path.isdir(model_file):
        raise ValueError(
            f"{model_file} is a directory: an orbax checkpoint of the JAX Trainer. "
            "The port reads .pth.tar files only (orbax is not a dependency of the "
            "port); convert it where the JAX package is installed, with the same "
            "--algorithm and hparams it was trained with: python "
            f"scripts/orbax_to_pth.py --model-file {model_file} --out <file.pth.tar>")
    cfg = ModelConfig.from_hparams(hparams, n_classes=n_classes)
    state = init_ensemble(cfg, device=device, algorithm=algorithm)
    counts = load_reference_checkpoint(model_file, state, strict=strict)
    print(f"checkpoint leaves matched: model={counts.get('model', 0)} "
          f"shape={counts.get('model_shape', 0)} oc={counts.get('model_oc', 0)} "
          f"oc_shape={counts.get('model_oc_shape', 0)}")
    missing = [k for k in NET_KEYS if k not in counts]
    if missing:
        raise ValueError(f"{model_file} lacks the checkpoint keys {missing}")
    return tuple(ns.net for ns in state.net_states())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-g", "--gpu", type=int, default=0,
                   help="index of the CUDA card to run on (with --device cuda)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card, or on the CPU")
    p.add_argument("--datasetTrain", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--datasetTest", nargs="+", type=int, default=[4])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--data-dir", default="./dataset/")
    p.add_argument("--model-file", required=True)
    p.add_argument("--out", default="./vis_out")
    p.add_argument("--dataset", type=str, default="fundus")
    p.add_argument("--algorithm", type=str, default="WT_PSE")
    p.add_argument("--label", type=str, default="OD")
    p.add_argument("--save-images", action="store_true",
                   help="write contour overlays (original_image/ + overlay/)")
    p.add_argument("--partial-load", action="store_true",
                   help="skip checkpoint leaves with no slot in the nets (the "
                        "reference's filtered partial load) instead of raising")
    p.add_argument("--packed", action="store_true",
                   help="accepted and ignored: the port runs unpacked")
    p.add_argument("configs", nargs="*")
    return p


def main(argv=None):
    from wt_pse_tpu_torch.cli.train import _repair_left_argv  # the same argparse trap
    from wt_pse_tpu_torch.utils.visualization import save_per_img

    args, left = build_parser().parse_known_args(argv)
    left, args.configs = _repair_left_argv(list(left), list(args.configs))
    device = resolve_device(f"cuda:{args.gpu}" if args.device == "cuda" else "cpu")
    hparams = default_hparams(args.algorithm, args.dataset)
    yamls = [c for c in ["config.yaml"] + list(args.configs) if os.path.exists(c)]
    hparams = load_config(hparams, yamls, left)
    if args.packed:
        print("--packed is ignored: the port runs the unpacked layout (the same math)")

    n_classes = 1 if args.label in ("OC", "OD") else 2
    nets = build_networks(args.model_file, hparams, n_classes, args.algorithm,
                          strict=not args.partial_load, device=device)
    predict_fn = make_predict_fn_for(args.algorithm, nets, device=device)

    domain = load_fundus(args.data_dir, "test", args.datasetTest, state="prediction")
    od_masks, oc_masks = [], []
    for lab in domain.labels:
        od, oc = encode_masks(np.asarray(lab, np.uint8))
        od_masks.append(od)
        oc_masks.append(oc)

    backend = native.scoring_backend("auto")
    why = native.unavailable_reason() if backend == "scipy" else None
    print(f"scoring backend: {backend}" + (f" (native unavailable: {why})" if why else ""))
    images = torch.from_numpy(np.asarray(domain.images, np.uint8)).to(device)
    res = evaluate_domain(predict_fn, images, od_masks, oc_masks, args.label,
                          args.batch_size, backend=backend)
    print({k: round(v, 4) for k, v in res.items()})

    if args.save_images:
        for i in range(len(images)):
            img = images[i:i + 1].permute(0, 3, 1, 2).to(torch.float32)
            out_od, out_oc = predict_fn(img / 127.5 - 1.0)
            hw = od_masks[i].shape[-2:]
            od_l = resize_device(out_od, hw)[0, 0].cpu().numpy()
            oc_l = resize_device(out_oc, hw)[0, 0].cpu().numpy()
            p_oc = postprocess_logits(oc_l[None], label=args.label, backend=backend)[0]
            p_od = postprocess_logits(od_l[None], label=args.label, backend=backend)[0]
            # the reference's channels (test_visulization.py:243-249): the disc
            # channel is the union od|oc, the cup channel oc alone
            pred = np.stack([p_oc, np.maximum(p_od, p_oc)])
            gt = np.stack([oc_masks[i], od_masks[i]])
            native_img = resize_device(img, hw)[0].permute(1, 2, 0).cpu().numpy()
            save_per_img(native_img.astype(np.uint8), args.out, str(i + 1), pred, gt)
    return res


if __name__ == "__main__":
    main()
