#!/usr/bin/env python3
"""Where the time of one PyTorch-port SimCLR train step goes, on one GPU.

Builds the port's model, optimizer and train step as the training entry
point (``multimodal_active_ai_tpu_torch.contrastive_learning``) does, runs
warm-up steps, then times ``--steps`` steps with the host clock around
synchronised steps and traces one more with ``torch.profiler``. Prints the
step time, the traced step's device busy time as a share of the untraced
median step, device time by kernel group and the top kernels by device
time, then one JSON line with the same numbers.

    python3 tools/profile_torch_step.py --arch ResNet50 -b 128 -f 10
    python3 tools/profile_torch_step.py --stat-fusion pallas --norm-kind bn_fused

``--stat-fusion`` and ``--norm-kind`` select the fused BatchNorm
statistics (the ``conv1x1_stats`` and ``stat_sums`` kernels), as the JAX
package's bench takes ``BENCH_STATS`` and ``BENCH_NORM``.

Needs CUDA; it raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import retina  # noqa: E402
from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train  # noqa: E402

# kernel-name fragments → group, first match wins
GROUPS = [
    ("glimpse_sample", "retina sampler (B1)"),
    ("stat_sums", "BN statistics kernel (B2)"),
    ("conv1x1_stats", "1x1 conv + statistics kernel (B3)"),
    ("conv", "convolution"), ("gemm", "matmul/conv gemm"), ("sm90_", "matmul/conv gemm"),
    ("cutlass", "matmul/conv gemm"), ("cudnn", "convolution"), ("nchw", "convolution"),
    ("nhwc", "convolution"), ("wgrad", "convolution"), ("dgrad", "convolution"),
    ("reduce", "reductions (BN statistics, losses)"),
    ("multi_tensor_apply", "optimizer"), ("foreach", "optimizer"),
    ("elementwise", "elementwise (BN, ReLU, casts)"), ("copy", "copies / casts"),
    ("index", "gather / index"), ("randn", "random"), ("normal", "random"),
    ("uniform", "random"),
]


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="ResNet50")
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("-f", "--num-fixations", type=int, default=10)
    ap.add_argument("--canvas-size", type=int, default=640)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--stat-fusion", default="", choices=["", "gram", "pallas"])
    ap.add_argument("--norm-kind", default="bn", choices=["bn", "bn_fused"])
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    b, s = args.batch_size, args.canvas_size
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = SimCLRModule(arch=args.arch, dtype=dtype, norm_kind=args.norm_kind,
                         stat_fusion=args.stat_fusion or None,
                         generator=torch.Generator().manual_seed(15))
    model = model.to(device).to(memory_format=torch.channels_last)
    opt = optimizers.get_optimizer("adam", model.parameters())
    sched = schedule.simclr_learning_rate(0.01, b, 64 * b, b, 10, 190)
    state = simclr_train.TrainState(model, opt, sched)
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=s),
                                        args.num_fixations, 0.05)
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randint(0, 256, (b, s, s, 3), generator=gen, dtype=torch.uint8,
                           device=device)

    for _ in range(2):                       # warm-up (cuDNN plans, allocator)
        step(state, images, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(state, images, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, images, gen)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

    # device-side events, without the GPU ranges of user annotations
    # (e.g. "Optimizer.step#Adam.step"), which would count time twice
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    # memsets and copies are device events too, but no kernel launches; their
    # number moves with the allocator's state from run to run
    memory_ops = sum(e.name.startswith(("Memset", "Memcpy")) for e in kernels)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 if kernels else 0.0
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        ms = e.device_time_total / 1e3
        by_group[group_of(e.name)] = by_group.get(group_of(e.name), 0.0) + ms
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    times.sort()
    median = times[len(times) // 2]
    print(f"[{gpu}] {args.arch} b={b} F={args.num_fixations} canvas {s} "
          f"{'bf16' if args.bf16 else 'f32'} norm {args.norm_kind} stat-fusion "
          f"{args.stat_fusion or 'none'}: step {median:.1f} ms (median of "
          f"{[round(t, 1) for t in times]}); traced step {traced_ms:.1f} ms "
          f"(host-side profiler overhead included); device busy {busy_ms:.1f} ms "
          f"= {100 * busy_ms / median:.1f}% of the untraced median step; "
          f"{len(kernels) - memory_ops} kernel launches (+{memory_ops} memsets/copies)")
    print("device time by group:")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  {g}")
    print(f"top {args.top} kernels by device time:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms  {n:5d}x  {name[:110]}")
    print(json.dumps({
        "gpu": gpu, "arch": args.arch, "batch": b, "fixations": args.num_fixations,
        "norm_kind": args.norm_kind, "stat_fusion": args.stat_fusion,
        "step_ms": median, "step_ms_all": times, "traced_step_ms": traced_ms,
        "device_busy_ms": busy_ms, "busy_share_of_step": busy_ms / median,
        "launches": len(kernels) - memory_ops, "memory_ops": memory_ops,
        "groups_ms": by_group,
        "top": [{"name": n[:200], "ms": ms, "count": c} for n, (ms, c) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
