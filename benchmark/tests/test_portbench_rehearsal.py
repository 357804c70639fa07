"""Each cell rehearsed through ``run.py`` on the CPU at its files' small
``rehearsal`` sizes: the result line in its format, ``correct``
true for the program, and false for the control (the reference in fp8 in
the program's place) and for each fault the cell can have."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
PORT = "multimodal_active_ai_tpu_torch"
ONE_CHIP = ["simclr-r50-b256-f10", "detr-r50-b256-f2"]
SEED = 2**31 + 12345


def run(workload, *extra, cwd=ROOT, rehearse=True, seconds="1", trace="0"):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(SEED),
           "--seconds", seconds, "--trace", trace, *(["--rehearse"] if rehearse else []), *extra]
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900, env=env)
    lines = p.stdout.strip().splitlines()
    return p, (json.loads(lines[-1]) if p.returncode == 0 and lines else None)


def check_line(out, stderr, traced):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] >= 1
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert ("breakdown" in out) == traced
    tail = stderr.strip().splitlines()[-len(out["checks"]):]
    for (name, c), line in zip(out["checks"].items(), tail):
        assert set(c) == {"value", "limit"} and line.startswith(f"check {name}: ")


@pytest.mark.parametrize("workload", ONE_CHIP)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_program_is_correct(workload, trace):
    p, out = run(workload, trace=trace)
    assert p.returncode == 0, p.stderr[-3000:]
    check_line(out, p.stderr, trace == "1")
    assert out["correct"] is True, out["checks"]
    if trace == "0":
        assert {"train_images_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("workload", ONE_CHIP)
def test_control_fails(workload):
    p, out = run(workload, "--control", "fp8_e4m3")
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ONE_CHIP)
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch", "half_loss"])
def test_faults_fail(workload, fault):
    p, out = run(workload, "--fault", fault)
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False, out["checks"]


def four_rank_tree(tmp_path: Path) -> Path:
    """A checkout with one more cell, SimCLR on 4 ranks (a later cell's
    files: a traffic mix, limits and its ``BENCHMARK.json`` entry), the
    port linked in."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (tmp_path / PORT).symlink_to(ROOT / PORT)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "simclr-x4", "config": "simclr-resnet50",
                           "traffic": "b256x4-f10", "chips": 4, "why": "4 ranks"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    here = tmp_path / "benchmark"
    shutil.copy(here / "traffic" / "b256-f10.json", here / "traffic" / "b256x4-f10.json")
    shutil.copy(here / "limits" / "simclr-r50-b256-f10.json", here / "limits" / "simclr-x4.json")
    return tmp_path


@pytest.mark.parametrize("extra,correct", [((), True), (("--fault", "no_exchange"), False)],
                         ids=["program", "no_exchange"])
def test_four_ranks(tmp_path, extra, correct):
    """Four rank processes over gloo: the program's global-batch step
    against the reference's one-process step, and the gradient exchange
    left out."""
    p, out = run("simclr-x4", *extra, cwd=four_rank_tree(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["device"]["count"] == 4
    assert out["correct"] is correct, out["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p, out = run(ONE_CHIP[0], rehearse=False)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p, _ = run(ONE_CHIP[0], cwd=tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
