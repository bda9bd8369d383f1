"""Finding a cell's parts by name. ``BENCHMARK.json`` at the checkout's root
names the cells, configurations and metrics; each part lives in a file of
its own under ``benchmark/``, found by its name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the code
  that drives the program with it, ``drivers/<driver>.py``;
- a per-layer metric: its reader, ``metrics/<name>.py``, with
  ``read(ctx) -> float | None``, in the cells its ``workloads`` lists.

A later change adds a cell, a configuration, a mix or a metric as new files
and entries, with no edit to a file that exists.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the BENCHMARK.json workload
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    end_to_end: list      # BENCHMARK.json's metrics this cell reports with --trace 0
    per_layer: list       # and with --trace 1
    bench_dir: Path


def load_module(path: Path, kind: str) -> ModuleType:
    name = f"wtbench_{kind}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError`` for
    a name it does not have."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    bench_dir = root / "benchmark"
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())

    # an end-to-end metric without ``workloads`` is every cell's; a per-layer
    # metric always lists its cells
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, entry, config, traffic, e2e, per_layer, bench_dir)


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py", "driver")


def readers(cell: Cell) -> dict[str, ModuleType]:
    """Each per-layer metric of the cell with its reader module."""
    return {m["name"]: load_module(cell.bench_dir / "metrics" / f"{m['name']}.py", "metric")
            for m in cell.per_layer}
