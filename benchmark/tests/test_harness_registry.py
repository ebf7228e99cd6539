"""The harness finds every cell's configuration, traffic, entry point,
reference and metric readers by the names in BENCHMARK.json, and a cell
added as files alone runs."""

import json
import shutil

import pytest

from helpers import CELLS, HERE, ROOT, bench, run_tiny, tiny_cell

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def test_benchmark_names_and_files():
    doc = bench()
    assert [w["name"] for w in doc["workloads"]] == list(CELLS)
    for c in doc["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert set(m["name"]) <= NAME_CHARS
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}
    assert {m["name"] for m in doc["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = tiny_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["batch"] == 2
    assert callable(cell.entry.build) and callable(cell.reference.run)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} == {
        "frames_per_s", "call_p95_ms", "setup_s"}


def test_cell_added_as_files_runs(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files and entries only, run through the harness unchanged."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "photos"))
    shutil.copytree(HERE / "traffic" / "photos", here / "traffic" / "photos")
    cfg = json.loads((here / "configs" / "back_f32.json").read_text())
    cfg["name"] = "back_f32_copy"
    (here / "configs" / "back_f32_copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "batch540.json").read_text())
    traffic.update(width=480, height=320)
    (here / "traffic" / "small320.json").write_text(json.dumps(traffic))
    (here / "metrics" / "window.calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx['latencies_s']))\n")
    doc = bench()
    doc["configs"].append({"name": "back_f32_copy", "source": "x",
                           "file": "benchmark/configs/back_f32_copy.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "back_f32_copy.small320",
                             "config": "back_f32_copy",
                             "traffic": "small320", "chips": 1,
                             "why": "test"})
    doc["per_layer"].append({"name": "window.calls", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "Entry", "moves": "frames_per_s",
                             "workloads": ["back_f32_copy.small320"]})
    cell = tiny_cell("back_f32_copy.small320", here=here, bench_doc=doc)
    assert [m["name"] for m in cell.per_layer] == ["window.calls"]
    result, checks = run_tiny(cell, traced=False)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"frames_per_s", "call_p95_ms",
                                      "setup_s"}
    ctx_metric = cell.reader("window.calls")({"latencies_s": [1, 2]})
    assert ctx_metric == 2.0
