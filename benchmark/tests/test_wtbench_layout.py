"""The benchmark's layout: parts found by name from new files alone, the
character rules of BENCHMARK.json, and what its modules may import."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from harness import spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_config_traffic_and_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "wt_pse_f32.json").read_text())
    (tmp_path / "benchmark" / "configs" / "wide.json").write_text(json.dumps(
        dict(cfg, name="wide", batch_size=12)))
    (tmp_path / "benchmark" / "traffic" / "short_epochs.json").write_text(json.dumps(
        {"driver": "train", "pools": [12, 12, 12, 12], "label": "OC", "check_steps": 2}))
    (tmp_path / "benchmark" / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["configs"].append({"name": "wide", "source": "https://example.org/wide",
                             "file": "benchmark/configs/wide.json", "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "wide.short", "config": "wide",
                               "traffic": "short_epochs", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "l",
                               "moves": "train_img_per_s", "workloads": ["wide.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(tmp_path, "wide.short")
    assert cell.config["batch_size"] == 12 and cell.traffic["pools"] == [12, 12, 12, 12]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert {m["name"] for m in cell.end_to_end} == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert spec.driver(cell).run.__name__ == "run"
    reader = spec.readers(cell)["steps_seen"]
    assert reader.read(type("Ctx", (), {"steps": 52})) == 52.0
    old = spec.load_cell(tmp_path, "wt_pse_f32.train")
    assert "steps_seen" not in {m["name"] for m in old.per_layer}
    with pytest.raises(KeyError):
        spec.load_cell(tmp_path, "no.such.cell")


def test_every_cell_and_metric_in_benchmark_json_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.per_layer and cell.end_to_end
        assert set(spec.readers(cell)) == {m["name"] for m in cell.per_layer}
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]


def test_names_units_and_lines_keep_to_the_benchmark_format():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + metrics]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for text in [x["why"] for x in bench["configs"] + bench["workloads"]] + \
            [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def imports(path: Path) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = imports(BENCH / path)
    assert not names & {"jax", "jaxlib", "flax", "wt_pse_tpu"}, names
    if path.startswith("reference/"):
        assert "wt_pse_tpu_torch" not in names, names
