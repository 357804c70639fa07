"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

* a configuration: the ``file`` its entry names (JSON);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's limits of the comparison: ``benchmark/limits/<workload>.json``;
* a configuration's kind of program: ``benchmark/kinds/<kind>.py``;
* a metric: ``benchmark/metrics/<metric name>.py``, whose ``read(run)``
  returns the value or None when it finds nothing to read.

A later cell, traffic mix, kind or metric is a new file beside these; no
existing file names it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _merged(d: dict, rehearse: bool) -> dict:
    out = {k: v for k, v in d.items() if k != "rehearsal"}
    if rehearse:
        for k, v in d.get("rehearsal", {}).items():
            out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One workload with its configuration, traffic, limits and metrics;
    ``rehearse`` takes each file's ``rehearsal`` block over its top level
    (the CPU tests' small sizes)."""

    def __init__(self, workload: str, rehearse: bool = False, root: Path = ROOT):
        spec = benchmark(root)
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        entry = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = _merged(json.loads((root / entry["file"]).read_text()), rehearse)
        here = root / "benchmark"
        self.traffic = _merged(json.loads(
            (here / "traffic" / f"{self.workload['traffic']}.json").read_text()), rehearse)
        limits = json.loads((here / "limits" / f"{workload}.json").read_text())
        self.limits = limits["rehearsal"] if rehearse else limits["limits"]
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if self._in(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._in(m)]

    def _in(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str, root: Path = ROOT):
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    return load_file(path, f"benchmark_metric_{metric}").read
