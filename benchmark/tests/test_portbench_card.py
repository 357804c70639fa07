"""On the card: each one-card cell runs end to end through ``run.py`` at its
published sizes, with a short window, and comes out correct; the traced
run reads every per-layer metric it lists. Skipped without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["simclr-r50-b256-f10", "detr-r50-b256-f2"])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "4000000007",
           "--seconds", "3", "--trace", "1"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m["name"] for m in spec.Cell(workload).per_layer}
