#!/usr/bin/env python3
"""Convert an orbax checkpoint directory, written by the JAX package's Trainer,
into a ``.pth.tar`` in the reference's 4-key layout, which the PyTorch port
(``wt_pse_tpu_torch``), the JAX package's torch importer and the reference's
own code all load:

    python scripts/orbax_to_pth.py --model-file runs/<run>/checkpoint_8 \\
        --out checkpoint_8.pth.tar [--algorithm ALG] [--label OD] \\
        [config.yaml ...] [--key value ...]

Run it where the JAX package and orbax are installed; the port needs
neither. The template flags are the JAX eval CLI's
(``python -m wt_pse_tpu.cli.test_visualization``): ``--algorithm``,
``--dataset``, ``--label`` (1 class for OD or OC, else 2), YAML overlays and
``--key value`` hparam leftovers, which must describe the nets the run
trained (``--compute_dtype bfloat16`` among them changes nothing: the
checkpoint keeps f32 weights). The nets are fully convolutional, so the
template's 256x256 does not constrain the image size the run trained at.

It restores the ensemble (``build_networks_from_orbax``), turns each of the
4 nets into a state_dict (``export_torch_state_dict``, then
``rename_for_reference``: conv kernels OIHW, BatchNorm scale, shift and
running statistics, the reference's ``double_conv`` indices) and writes
``model``, ``model_shape``, ``model_oc`` and ``model_oc_shape`` with
``torch.save``, beside ``--out`` and then moved onto it. The joint variant's
students are written too, although the port's joint predict reads only
``model`` and ``model_oc``. Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NET_KEYS = ("model", "model_shape", "model_oc", "model_oc_shape")


def convert(model_file: str, out: str, hparams: dict, n_classes: int = 1,
            algorithm: str = "WT_PSE") -> dict[str, int]:
    """Write the orbax ensemble at ``model_file`` to ``out``; returns the
    number of tensors written under each key."""
    import torch

    from wt_pse_tpu.cli.test_visualization import build_networks_from_orbax
    from wt_pse_tpu.io.checkpoint import export_torch_state_dict, rename_for_reference

    _, variables = build_networks_from_orbax(model_file, hparams, n_classes, algorithm)
    payload = {}
    for key, v in zip(NET_KEYS, variables):
        sd = rename_for_reference(export_torch_state_dict(v))
        payload[key] = {name: torch.from_numpy(np.array(a)) for name, a in sd.items()}
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    return {k: len(sd) for k, sd in payload.items()}


def main(argv=None) -> dict[str, int]:
    from wt_pse_tpu.cli.train import _repair_left_argv
    from wt_pse_tpu.config import default_hparams, load_config

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-file", required=True,
                   help="the orbax checkpoint directory (e.g. runs/<run>/checkpoint_8)")
    p.add_argument("--out", required=True, help="the .pth.tar to write")
    p.add_argument("--algorithm", type=str, default="WT_PSE")
    p.add_argument("--dataset", type=str, default="fundus")
    p.add_argument("--label", type=str, default="OD",
                   help="OD or OC: 1 output class; anything else: 2 (as the eval CLI)")
    p.add_argument("configs", nargs="*", help="YAML overlays, then --key value hparams")
    args, left = p.parse_known_args(argv)
    left, args.configs = _repair_left_argv(list(left), list(args.configs))
    if not os.path.isdir(args.model_file):
        raise SystemExit(f"{args.model_file} is not an orbax checkpoint directory")
    hparams = default_hparams(args.algorithm, args.dataset)
    yamls = [c for c in ["config.yaml"] + list(args.configs) if os.path.exists(c)]
    hparams = load_config(hparams, yamls, left)
    n_classes = 1 if args.label in ("OC", "OD") else 2
    counts = convert(args.model_file, args.out, hparams, n_classes, args.algorithm)
    print(f"wrote {args.out}: " + " ".join(f"{k}={n}" for k, n in counts.items()))
    return counts


if __name__ == "__main__":
    main()
