#!/usr/bin/env python3
"""Data-parallel scaling of the port's SimCLR driver on one host's GPUs.

Runs ``contrastive_learning`` through torchrun, as a user launches it, at
the main path's width (ResNet-50, ``-b 128`` a rank, F=10, canvas 640,
bf16, synthetic data, ``-t``) with 1 rank and with N ranks (default: every
card), and prints for each the median host time of a step (the driver's
``-p 1`` lines of rank 0, its first step left out), the global img/s and
the scaling efficiency ``img/s(N) / (N · img/s(1))``. Then a job of N ranks
times the all-reduce of the SimCLR gradient (one flat float32 buffer, the
size of the model's parameters) and of one BatchNorm sum (2·2048 + 1
floats), the two collectives a step makes F and ~1,100 times. Beside the
numbers: the backend and ``nvidia-smi``'s card name and power limit::

    python3 tools/torch_multi_gpu_scaling.py [--ranks N] [--examples 384]

``--device cpu --arch ResNet10 -b 4 --canvas-size 64 -f 2`` rehearses it on
the CPU over gloo (times there are the CPU's, not a card's).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torchrun(nproc: int, args: list[str], timeout: float) -> str:
    """``python -m torch.distributed.run --standalone`` of ``nproc`` ranks;
    its output. Raises on a non-zero exit; kills the job's process group
    on the way out."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}"] + args
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        out = ""
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"{nproc}-rank job exited {p.returncode}:\n{out[-4000:]}")
    return out


def step_ms(log: str) -> list[float]:
    return [float(t) * 1e3 for t in re.findall(
        r"^Epoch: \[\d+\]\[\d+/\d+\]\tTime ([\d.]+)", log, re.M)]


def collectives(arch: str, device: str) -> None:
    """One rank of the collective-timing job: median host times of 5
    gradient and 51 BatchNorm-sum all-reduces, synchronised, printed by
    rank 0."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from multimodal_active_ai_tpu_torch import parallel
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule

    dev = parallel.initialize_distributed(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        with torch.device("meta"):
            numel = sum(p.numel() for p in SimCLRModule(arch).parameters())
        for name, n, reps in (("gradient", numel, 5), ("BatchNorm sum", 2 * 2048 + 1, 51)):
            x = torch.ones(n, device=dev)
            times = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                dist.all_reduce(x)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            parallel.print0(f"all-reduce of the {name} ({n:,} floats, {4 * n / 1e6:.1f} MB) "
                            f"over {parallel.world_size()} ranks ({dist.get_backend()}): "
                            f"median {sorted(times)[reps // 2]:.3f} ms of {reps}")
    finally:
        parallel.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=0, help="N (default: every card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="ResNet50")
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-f", "--num-fixations", type=int, default=10)
    ap.add_argument("--canvas-size", type=int, default=640)
    ap.add_argument("--examples", type=int, default=384, help="--num-examples a rank")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--collectives", action="store_true",
                    help="(a rank of the collective-timing job; set by this script)")
    a = ap.parse_args()
    if a.collectives:
        collectives(a.arch, a.device)
        return 0
    import torch
    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available (--device cpu rehearses on the CPU)")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        cards = torch.cuda.device_count()
    else:
        card, cards = "cpu rehearsal", 0
    n = a.ranks or cards
    print(f"cards: {cards} x {card}; ranks: 1 and {n}")
    driver = ["-m", "multimodal_active_ai_tpu_torch.contrastive_learning", "--dataset",
              "synthetic", "--arch", a.arch, "-b", str(a.batch_size), "-f",
              str(a.num_fixations), "--canvas-size", str(a.canvas_size), "--epochs", "1", "-t",
              "--num-examples", str(a.examples), "-p", "1", "--device", a.device]
    if a.device == "cpu":
        driver.append("--no-bf16")
    rate = {}
    for nproc in (1, n):
        ckdir = tempfile.mkdtemp(prefix="scaling_ckpt_")
        try:
            log = torchrun(nproc, driver + ["--checkpoint-dir", ckdir], a.timeout)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        backend = re.search(r"backend (\w+ \([^)]*\))", log)
        times = step_ms(log)
        med = sorted(times[1:])[len(times[1:]) // 2]
        rate[nproc] = nproc * a.batch_size / med * 1e3
        print(f"{nproc} rank(s), backend {backend.group(1) if backend else 'none'}: "
              f"{a.arch} b={a.batch_size} a rank, F={a.num_fixations}, canvas "
              f"{a.canvas_size}: step {med:.1f} ms a rank (median of "
              f"{[round(t) for t in times[1:]]}), {rate[nproc]:.1f} img/s global [{card}]")
    if n > 1:
        print(f"scaling efficiency at {n} ranks: {rate[n] / (n * rate[1]):.3f} "
              f"({rate[n]:.1f} / ({n} x {rate[1]:.1f}) img/s) [{card}]")
        print(torchrun(n, [os.path.abspath(__file__), "--collectives", "--arch", a.arch,
                           "--device", a.device], a.timeout).strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
