"""``BENCHMARK.json`` against its format's limits, every name resolved to
its file, and a new cell's and metric's files found without editing any."""

import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["benchmark"] and B["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells, 14 runs each at run_seconds + 60 s, fits 12 hours
    assert 2 + 14 * 24 * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(B)) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, cells // 4)


def test_names_units_and_keys():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for entry in B["configs"] + B["workloads"] + B["end_to_end"] + B["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line_ok(w["why"])
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        assert _line_ok(c["source"]) and _line_ok(c["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and _line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    assert spec.kind(cell.config["kind"]).KIND is not None
    for key in ("batch", "fixations", "canvas", "pool", "checked_steps", "trace_steps"):
        assert key in cell.traffic
    rehearsal = spec.Cell(workload, rehearse=True)
    assert rehearsal.traffic["batch"] < cell.traffic["batch"]


def test_a_new_cell_and_metric_are_found_by_their_files(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    b = json.loads(json.dumps(B))
    b["workloads"].append({"name": "detr-r50-b128-f4", "config": "detr-resnet50",
                           "traffic": "b128-f4", "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "input.wait_ms", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "host input",
                           "moves": "train_images_per_s", "workloads": ["detr-r50-b128-f4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    here = tmp_path / "benchmark"
    (here / "traffic" / "b128-f4.json").write_text(json.dumps(
        {"batch": 128, "fixations": 4, "canvas": 640, "pool": 4, "checked_steps": 3,
         "trace_steps": 10}))
    (here / "limits" / "detr-r50-b128-f4.json").write_text(json.dumps(
        {"limits": {"loss": 0.1}, "rehearsal": {"loss": 0.1}}))
    (here / "metrics" / "input.wait_ms.py").write_text("def read(run):\n    return 1.5\n")
    cell = spec.Cell("detr-r50-b128-f4", root=tmp_path)
    assert cell.traffic["fixations"] == 4 and cell.limits == {"loss": 0.1}
    assert [m["name"] for m in cell.per_layer][-1] == "input.wait_ms"
    assert spec.reader("input.wait_ms", root=tmp_path)(None) == 1.5
    assert "input.wait_ms" not in {m["name"] for m in spec.Cell("detr-r50-b256-f2").per_layer}


def test_config_files_state_the_run():
    for c in B["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["assumed"] and cfg["weights"]
