"""Fundus dataset: directory scan + decode into numpy pools (the port's own
copy of ``wt_pse_tpu/data/fundus.py:39-187``).

Reference loader semantics (``fundus_dataloader.py``):

- layout ``{base_dir}/Domain{id}/{phase}/ROIs/image/*.png`` with masks at
  ``.../ROIs/mask/`` (the path's ``image`` becomes ``mask``);
- pools keyed by the dataset-origin flag of the filename prefix (DGS:
  ``gd``/``nd``; REF: ``g``/``n``; RIM: ``G``/``N``/``S``; REF_val: ``V``),
  flattened in that order;
- images -> RGB, resized to 256x256 LANCZOS; labels -> L, resized to 256 (PIL's
  default filter) unless ``state == 'prediction'``, which keeps them native;
- the Domain4 pre-crop ``(144, 144) + 512x512`` fires only when the caller
  passes the *string* ``'4'`` first, the reference's string-compare quirk
  (both CLIs pass ints, so it never fires there).

Decoded pools are cached as ``.npz`` under ``{base_dir}/.wt_pse_cache/`` with
the JAX package's key and layout, so a cache either package wrote loads in the
other. PIL is imported only to decode, after the cache is checked.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from glob import glob

import numpy as np

FLAG_PREFIXES = {
    "DGS": ("gd", "nd"),
    "REF": ("g", "n"),
    "RIM": ("G", "N", "S"),
    "REF_val": ("V",),
}
POOL_ORDER = ("DGS", "REF", "RIM", "REF_val")


def classify_flag(basename: str) -> str | None:
    if basename[:2] in FLAG_PREFIXES["DGS"]:
        return "DGS"
    if basename[:1] in FLAG_PREFIXES["REF"]:
        return "REF"
    if basename[:1] in FLAG_PREFIXES["RIM"]:
        return "RIM"
    if basename[:1] in FLAG_PREFIXES["REF_val"]:
        return "REF_val"
    return None


def encode_masks(gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threshold-encode a grayscale label (255 bg / 128 disc / 0 cup) into
    binary (od, oc) masks: OD = gray <= 200, OC = gray <= 50."""
    od = (gray <= 200).astype(np.float32)
    oc = (gray <= 50).astype(np.float32)
    return od, oc


@dataclass
class FundusDomain:
    """One decoded (domain, phase) slice."""

    images: np.ndarray  # (N, 256, 256, 3) uint8
    labels: np.ndarray | list  # (N, 256, 256) uint8, or a list at native resolution
    names: list[str] = field(default_factory=list)

    def __len__(self):
        return len(self.images)


def _cache_path(base_dir: str, phase: str, splitid, state: str, size: int) -> str:
    # the crop is keyed explicitly: str(4) == str('4') but only the string crops
    crop_tag = "crop" if (len(splitid) > 0 and splitid[0] == "4") else "nocrop"
    key = f"{phase}-{'_'.join(map(str, splitid))}-{state}-{size}-{crop_tag}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:10]
    return os.path.join(base_dir, ".wt_pse_cache", f"fundus_{key}_{digest}.npz")


def load_fundus(
    base_dir: str,
    phase: str = "train",
    splitid=(1, 2, 4),
    state: str = "train",
    size: int = 256,
    cache: bool = True,
) -> FundusDomain:
    """Decode one FundusSegmentation-equivalent dataset; ``state='prediction'``
    keeps the labels at native resolution (a list)."""
    cache_path = _cache_path(base_dir, phase, splitid, state, size) if cache else None
    if cache_path is not None and os.path.exists(cache_path):
        try:
            z = np.load(cache_path, allow_pickle=True)
            labels = z["labels"] if state != "prediction" else list(z["labels_ragged"])
            return FundusDomain(images=z["images"], labels=labels, names=list(z["names"]))
        except (OSError, KeyError, ValueError):
            pass  # a stale or corrupt cache: decode again

    entries = []
    for sid in splitid:
        img_dir = os.path.join(base_dir, f"Domain{sid}", phase, "ROIs", "image", "")
        for image_path in sorted(glob(img_dir + "*.png")):
            entries.append((image_path, image_path.replace("image", "mask")))
    if not entries:
        raise FileNotFoundError(
            f"no images under {base_dir}/Domain{{{','.join(map(str, splitid))}}}/{phase}/ROIs/image/")

    from PIL import Image

    do_crop = len(splitid) > 0 and splitid[0] == "4"  # the string-compare quirk
    pools: dict[str, list] = {k: [] for k in POOL_ORDER}
    for image_path, mask_path in entries:
        flag = classify_flag(os.path.basename(image_path))
        if flag is None:
            raise ValueError(f"unknown dataset prefix: {image_path}")
        img = Image.open(image_path).convert("RGB")
        lab = Image.open(mask_path)
        if lab.mode != "L":
            lab = lab.convert("L")
        if do_crop:
            img = img.crop((144, 144, 144 + 512, 144 + 512))
            lab = Image.fromarray(np.asarray(lab)[144:144 + 512, 144:144 + 512])
        img = img.resize((size, size), Image.LANCZOS)
        if state != "prediction":
            lab = lab.resize((size, size))  # PIL's default filter, as the reference
        pools[flag].append((np.asarray(img, np.uint8), np.asarray(lab, np.uint8),
                            os.path.basename(image_path)))

    ordered = [item for key in POOL_ORDER for item in pools[key]]
    images_arr = np.stack([img for img, _, _ in ordered])
    labels = [lab for _, lab, _ in ordered]
    names = [name for _, _, name in ordered]
    labels_out: np.ndarray | list = np.stack(labels) if state != "prediction" else labels

    if cache_path is not None:
        payload = {"images": images_arr, "names": np.array(names)}
        if state != "prediction":
            payload["labels"] = labels_out
        else:
            payload["labels_ragged"] = np.array(labels_out, dtype=object)
        try:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.savez_compressed(cache_path, **payload)
        except OSError:
            pass  # a read-only dataset directory: the cache is best-effort
    return FundusDomain(images=images_arr, labels=labels_out, names=names)


def load_train_domains(base_dir: str, splitids, size: int = 256) -> list[FundusDomain]:
    """One FundusDomain per training domain id (train.py:71-75)."""
    return [load_fundus(base_dir, "train", [sid], "train", size) for sid in splitids]
