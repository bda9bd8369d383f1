"""Run-directory observability: CSV scalars, best-score file, stdout summaries
(the port's own copy of ``wt_pse_tpu/utils/logging.py``).

The files and their formats are the JAX package's: ``log.csv`` (the
reference's header, one row an epoch), ``score.txt`` on each new best,
``metrics.jsonl`` (one JSON line an epoch, plus ``{"kind": "step"}`` lines
with per-step logging), ``run_meta.json`` and the per-epoch loss-trace
``<name>.txt`` files. For the same calls the two write the same bytes, apart
from timestamps and elapsed times.
"""

from __future__ import annotations

import json
import os
import time

LOG_HEADERS = [
    "epoch", "iteration", "train/loss_seg", "train/cup_dice", "train/disc_dice",
    "valid/loss_CE", "valid/cup_dice", "valid/disc_dice", "elapsed_time",
]


class RunLogger:
    def __init__(self, out_dir: str, tensorboard: bool = False, null: bool = False):
        """``null=True``: a logger that writes nothing (every method is a
        no-op and no directory is made). The ranks of a data-parallel run
        other than 0 take it: they run the same loop on the same state, and
        rank 0 owns the run directory."""
        self.out = out_dir
        self.null = null
        self.t0 = time.time()
        self.tb = None
        self.csv_path = os.path.join(out_dir, "log.csv")
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        if null:
            return
        os.makedirs(out_dir, exist_ok=True)
        if not os.path.exists(self.csv_path):
            with open(self.csv_path, "w") as f:
                f.write(",".join(LOG_HEADERS) + "\n")
        if tensorboard:  # event files under out/tensorboard/, as the reference
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=os.path.join(out_dir, "tensorboard"))

    def run_meta(self, meta: dict, name: str = "run_meta.json"):
        """One machine-readable record of how the run was configured."""
        if self.null:
            return
        with open(os.path.join(self.out, name), "w") as f:
            json.dump(meta, f, indent=2, default=str)
            f.write("\n")

    def scalars(self, step: int, payload: dict):
        if self.null:
            return
        rec = {"step": step, "t": round(time.time() - self.t0, 3)}
        rec.update({k: float(v) for k, v in payload.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t"):
                    self.tb.add_scalar(k, v, step)

    def step_scalars(self, iteration: int, payload: dict):
        """One iteration's train scalars (``Trainer.py:957-969`` logs every loss
        every iteration): the line :meth:`step_scalars_many` writes for one
        record."""
        self.step_scalars_many([(iteration, payload)])

    def step_scalars_many(self, records):
        """Per-iteration train scalars, one ``{"kind": "step"}`` JSON line each,
        written in one burst an epoch; ``records`` is an iterable of
        ``(iteration, payload)`` pairs. ``t`` is the time of the burst."""
        if self.null:
            return
        t = round(time.time() - self.t0, 3)
        lines = []
        for iteration, payload in records:
            rec = {"kind": "step", "step": iteration, "t": t}
            rec.update({k: float(v) for k, v in payload.items()})
            lines.append(json.dumps(rec))
            if self.tb is not None:
                for k, v in rec.items():
                    if k not in ("step", "t", "kind"):
                        self.tb.add_scalar(f"train_step/{k}", v, iteration)
        if lines:
            with open(self.jsonl_path, "a") as f:
                f.write("\n".join(lines) + "\n")

    def csv_row(self, epoch: int, iteration: int, loss_seg: float,
                val: dict | None = None, train_cup: float | None = None,
                train_disc: float | None = None):
        """One log.csv row an epoch: the train fields are epoch means; ``val``
        fills the valid/* columns on validation epochs."""
        if self.null:
            return
        fmt = lambda v: "" if v is None else round(v, 6)
        row = [epoch, iteration, round(loss_seg, 6), fmt(train_cup),
               fmt(train_disc),
               "", "" if val is None else round(val.get("cup_dice", 0), 6),
               "" if val is None else round(val.get("disc_dice", 0), 6),
               round(time.time() - self.t0, 1)]
        with open(self.csv_path, "a") as f:
            f.write(",".join(str(x) for x in row) + "\n")

    def image(self, tag: str, img, step: int):
        """An (H, W, 3) uint8 image: a PNG under ``images/`` and, when the
        writer is live, a TensorBoard image."""
        if self.null:
            return
        import numpy as np
        from PIL import Image

        arr = np.asarray(img)
        d = os.path.join(self.out, "images")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"))
        if self.tb is not None:
            self.tb.add_image(tag, arr, step, dataformats="HWC")

    def loss_trace(self, values: dict):
        """Per-epoch loss-trace files: one ``<name>.txt`` a key, one line an
        epoch, spelt ``'{}\\n'.format(value)``."""
        if self.null:
            return
        for name, v in values.items():
            with open(os.path.join(self.out, f"{name}.txt"), "a") as f:
                f.write("{}\n".format(v))

    def best_score(self, val: dict):
        """score.txt, appended on each new best (Trainer.py:279-281 format)."""
        if self.null:
            return
        with open(os.path.join(self.out, "score.txt"), "a") as f:
            f.write(
                "cd:{} dd:{} c_hd:{} d_hd:{} c_asd:{} d_asd:{}\n".format(
                    val["cup_dice"], val["disc_dice"], val["cup_hd"],
                    val["disc_hd"], val["cup_asd"], val["disc_asd"]))

    def epoch_summary(self, epoch: int, lr: float, seg_oc: float, kd_oc: float,
                      ins_oc: float, dom_oc: float, seconds: float):
        print(
            f"\n[Epoch: {epoch}] lr:{lr:.6f},  Average segLoss: {seg_oc:.6f}, "
            f"Average kl: {kd_oc:.6f},Average ins wt: {ins_oc:.6f},"
            f"Average dom wt: {dom_oc:.6f}, Execution time: {seconds:.5f}")
