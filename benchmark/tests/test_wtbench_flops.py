"""The FLOP count and parameter count each configuration stores are the
benchmark's own, recounted here from the frozen reference."""

import json
from pathlib import Path

import pytest

from harness import spec
from harness.flops import count_params, count_step_flops

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_stored_flops_and_params_are_recounted(name):
    cell = spec.load_cell(ROOT, name)
    assert count_step_flops(cell.config, cell.traffic) == cell.config["flops_per_step"]
    assert count_params(cell.config) == cell.config["params"]
