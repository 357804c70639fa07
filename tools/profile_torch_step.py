#!/usr/bin/env python3
"""Where the time of one PyTorch-port train step goes, on one GPU.

Builds the port's model, optimizer and train step as a training entry point
does (``--path simclr``: ``contrastive_learning``; ``probe``:
``representation_evaluation``, encoder frozen in eval mode; ``detr``:
``detr_image_classification`` with its default model, random weights;
``rls``: ``detr_image_classification_rls``, that DETR with a ResNet18 DQN,
A = 100: the rollout with the policy picking every fixation after the first,
the DETR update, the replay push and a DQN update on 256 replay samples,
which the driver takes with probability 0.7 a step; ``caption``:
``coco_captions_probe``, the float32 encoder frozen in eval mode, the image
head and the text tower at their defaults, Adam), runs warm-up steps, then
times ``--steps`` steps with the host clock around
synchronised steps and traces one more with ``torch.profiler``. Prints the
step time, the traced step's device busy time as a share of the untraced
median step, device time by kernel group and the top kernels by device
time, then one JSON line with the same numbers.

    python3 tools/profile_torch_step.py --arch ResNet50 -b 128 -f 10
    python3 tools/profile_torch_step.py --stat-fusion pallas --norm-kind bn_fused
    python3 tools/profile_torch_step.py --path detr -f 2
    python3 tools/profile_torch_step.py --path rls -f 2
    python3 tools/profile_torch_step.py --path caption -f 2

``--stat-fusion`` and ``--norm-kind`` select the fused BatchNorm
statistics (the ``conv1x1_stats`` and ``stat_sums`` kernels), as the JAX
package's bench takes ``BENCH_STATS`` and ``BENCH_NORM``.

``--dataset imagenet --data DIR`` (``--path simclr`` or ``probe``) feeds
every step from the drivers' file reader over ``DIR``'s ImageNet layout
(``HostLoader``, ``-j`` decode threads, ``--canvas-cache``; on the SimCLR
path copied ``--device-prefetch`` batches ahead, on the probe's when used,
as the drivers do) instead of one synthetic batch on the card. Each step's
time then includes the wait for its batch, which is reported beside the
device busy time, so the host input's share of a step is measured:

    python3 tools/profile_torch_step.py --dataset imagenet --data /path/to/imagenet
    python3 tools/profile_torch_step.py --path probe --dataset imagenet --data DIR \
        --canvas-cache /tmp/canvas

Needs CUDA; it raises without it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from contextlib import closing

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from multimodal_active_ai_tpu_torch.coco_captions_probe import caption_tokens  # noqa: E402
from multimodal_active_ai_tpu_torch.config import ContrastiveConfig, parse_into  # noqa: E402
from multimodal_active_ai_tpu_torch.contrastive_learning import build_reader  # noqa: E402
from multimodal_active_ai_tpu_torch.data.prefetch import device_batches  # noqa: E402
from multimodal_active_ai_tpu_torch.detr_image_classification_rls import push_rollout  # noqa: E402
from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.models.detr import DETR  # noqa: E402
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression  # noqa: E402
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn  # noqa: E402
from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim  # noqa: E402
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule  # noqa: E402
from multimodal_active_ai_tpu_torch.models.text import TextEncoder  # noqa: E402
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import retina  # noqa: E402
from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory  # noqa: E402
from multimodal_active_ai_tpu_torch.train import (  # noqa: E402
    caption_probe, detr_train, eval_probe, optimizers, rls_train, schedule, simclr_train)
from multimodal_active_ai_tpu_torch.utils import profiling  # noqa: E402

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
    ("softmax", "softmax / layer norm"), ("layer_norm", "softmax / layer norm"),
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


def timed(fn, steps: int) -> list[float]:
    """Host ms of ``steps`` synchronised calls of ``fn``."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def trace(fn):
    """One traced, synchronised call of ``fn``: its device events as
    ``(name, µs)`` (``utils/profiling.device_leaf_ops``: kernels, memsets
    and copies, without the GPU ranges of user annotations, which would
    count time twice), the number of memsets and copies among them (device
    events but no kernel launches; their number moves with the allocator's
    state from run to run), the device busy ms and the traced host ms."""
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = profiling.device_leaf_ops(prof)
    memory_ops = sum(name.startswith(("Memset", "Memcpy")) for name, _ in kernels)
    busy_ms = sum(us for _, us in kernels) / 1e3
    return kernels, memory_ops, busy_ms, traced_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="ResNet50")
    ap.add_argument("-b", "--batch-size", type=int, default=128)
    ap.add_argument("--path", default="simclr", choices=["simclr", "probe", "detr", "rls", "caption"])
    ap.add_argument("-f", "--num-fixations", type=int, default=None,
                    help="default 10 for simclr, 2 for probe, detr, rls and caption")
    ap.add_argument("--canvas-size", type=int, default=640)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--stat-fusion", default="", choices=["", "gram", "pallas"])
    ap.add_argument("--norm-kind", default="bn", choices=["bn", "bn_fused"])
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic", "imagenet"],
                    help="'imagenet': feed the steps from the file reader over --data")
    ap.add_argument("--data", default="", help="ImageNet-layout folder")
    ap.add_argument("--canvas-cache", default="", help="the reader's canvas cache directory")
    ap.add_argument("-j", "--workers", type=int, default=4, help="the reader's decode threads")
    ap.add_argument("--device-prefetch", type=int, default=2,
                    help="batches copied ahead on the simclr path")
    args = ap.parse_args(argv)
    if args.dataset != "synthetic" and args.path not in ("simclr", "probe"):
        ap.error("--dataset imagenet feeds the simclr and probe paths only")

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    b, s = args.batch_size, args.canvas_size
    f = args.num_fixations or (10 if args.path == "simclr" else 2)
    # the caption probe's encoder is float32, as in the JAX driver
    bf16 = args.bf16 and args.path != "caption"
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfg = retina.RetinaConfig(canvas_size=s)
    seeded = torch.Generator().manual_seed(15)
    gen = torch.Generator(device=device).manual_seed(0)
    drop = torch.Generator(device=device).manual_seed(1)   # DETR/RLS/caption dropout
    images = torch.randint(0, 256, (b, s, s, 3), generator=gen, dtype=torch.uint8,
                           device=device)
    labels = torch.randint(0, 1000, (b,), generator=gen, device=device)
    if args.path == "simclr":
        model = SimCLRModule(arch=args.arch, dtype=dtype, norm_kind=args.norm_kind,
                             stat_fusion=args.stat_fusion or None, generator=seeded)
        model = model.to(device).to(memory_format=torch.channels_last)
        state = simclr_train.TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                                        schedule.simclr_learning_rate(0.01, b, 64 * b, b, 10, 190))
        simclr_step = simclr_train.make_train_step(cfg, f, 0.05)

        def step(state, images, labels, gen):
            return simclr_step(state, images, gen)
    elif args.path == "probe":
        encoder = SimCLRModule(arch=args.arch, dtype=dtype, generator=seeded)
        encoder = encoder.to(device).to(memory_format=torch.channels_last).eval()
        probe = LogisticRegression(encoder_feature_dim(args.arch) * 16 * f, 1000,
                                   generator=seeded).to(device)
        state = simclr_train.TrainState(probe, optimizers.get_optimizer("adam", probe.parameters()),
                                        schedule.simclr_learning_rate(1e-7, b, 64 * b, b, 10, 90))
        probe_step = eval_probe.make_probe_train_step(cfg, f)

        def step(state, images, labels, gen):
            return probe_step(state, encoder, images, labels, gen)
    elif args.path == "caption":
        encoder = SimCLRModule(arch=args.arch, generator=seeded)
        encoder = encoder.to(device).to(memory_format=torch.channels_last).eval()
        towers = caption_probe.CaptionTowers(encoder_feature_dim(args.arch) * 16 * f,
                                             TextEncoder(generator=seeded), generator=seeded)
        towers = towers.to(device)
        state = simclr_train.TrainState(
            towers, optimizers.get_optimizer("adam", towers.parameters()), lambda _: 1e-4)
        cap_step = caption_probe.make_caption_probe_train_step(cfg, f, 0.05)
        tokens = caption_tokens(labels, 32768, 32)

        def step(state, images, labels, gen):
            return cap_step(state, encoder, images, tokens, gen, dropout_generator=drop)
    else:
        model = DETR(args.arch, dtype=dtype, generator=seeded)
        model = model.to(device).to(memory_format=torch.channels_last)
        state = simclr_train.TrainState(
            model, detr_train.make_detr_optimizer(model, 1e-4, 1e-5, 1e-4),
            detr_train.step_lr(64, 200))
        if args.path == "detr":
            detr_step = detr_train.make_detr_train_step(SetCriterion(10, 1000), cfg, f, 0.1)

            def step(state, images, labels, gen):
                return detr_step(state, images, labels, gen, dropout_generator=drop)
        else:
            policy = build_dqn("ResNet18", 100, dtype=dtype, generator=seeded)
            policy = policy.to(device).to(memory_format=torch.channels_last)
            target = copy.deepcopy(policy)
            pstate = simclr_train.TrainState(
                policy, optimizers.get_optimizer("rmsprop", policy.parameters()),
                lambda _: 1e-4)
            memory = ReplayMemory(10_000, (30, 30, 12), seed=15, device=device)
            rls_step = rls_train.make_rls_train_step(SetCriterion(10, 1000), cfg, f, 100, 0.9,
                                                     0.05, 10.0, 0.1)
            dqn_update = rls_train.make_dqn_update_step(100, 0.999)
            host_gen = torch.Generator().manual_seed(0)

            def step(state, images, labels, gen):
                draws = rls_train.draw_rollout(gen, host_gen, b, f, drop)._replace(
                    coins=(1.0,) * f)
                _, ro, reward = rls_step(state, policy, images, labels, 1, draws)
                push_rollout(memory, ro, draws.num_fixs, reward, False)
                if len(memory) >= 256:
                    dqn_update(pstate, target, memory.sample(256))

    waits: list[float] = []
    if args.dataset == "synthetic":
        def feed():
            return images, labels
    else:
        reader = build_reader(parse_into(ContrastiveConfig, [
            args.data, "--dataset", args.dataset, "-b", str(b), "--canvas-size", str(s),
            "-j", str(args.workers), "--canvas-cache", args.canvas_cache]), "train", device)
        depth = args.device_prefetch if args.path == "simclr" else 0

        def epochs():
            while True:
                with closing(device_batches(reader, device, depth)) as batches:
                    yield from batches
                reader.reset()

        source = epochs()

        def feed():
            """The next batch on the card, and the host time waited for it."""
            t0 = time.perf_counter()
            batch = next(source)
            waits.append((time.perf_counter() - t0) * 1e3)
            return batch

    def fed_step():
        step(state, *feed(), gen)

    for _ in range(2):                       # warm-up (cuDNN plans, allocator)
        fed_step()
    torch.cuda.synchronize()
    waits.clear()
    times = timed(fed_step, args.steps)
    kernels, memory_ops, busy_ms, traced_ms = trace(fed_step)
    if args.dataset != "synthetic":
        source.close()
        wait_ms = sorted(waits[:-1])[len(waits[:-1]) // 2]
        print(f"input: {reader.stats_line()} (the loader's epoch so far); the step's wait "
              f"for its batch: median {wait_ms:.1f} ms of the timed steps "
              f"{[round(w, 1) for w in waits[:-1]]}, {waits[-1]:.1f} ms in the traced step")
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for name, us in kernels:
        ms = us / 1e3
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + ms
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    median = times[len(times) // 2]
    print(f"[{gpu}] {args.path} {args.arch} b={b} F={f} canvas {s} "
          f"{'bf16' if bf16 else 'f32'} norm {args.norm_kind} stat-fusion "
          f"{args.stat_fusion or 'none'}, {args.dataset} input: step {median:.1f} ms (median of "
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
    extra = {}
    if args.dataset != "synthetic":
        extra["input"] = {"dataset": args.dataset, "decoder": reader.decoder,
                          "wait_ms": wait_ms, "wait_ms_all": waits[:-1],
                          "traced_wait_ms": waits[-1], "loader": reader.stats_line()}
    if args.path == "rls":
        # the DQN update alone, on the same replay memory
        def update():
            return dqn_update(pstate, target, memory.sample(256))
        upd_times = timed(update, args.steps)
        upd_kernels, upd_memory_ops, upd_busy, _ = trace(update)
        extra["dqn_update"] = {"step_ms": upd_times[len(upd_times) // 2],
                               "step_ms_all": upd_times, "device_busy_ms": upd_busy,
                               "launches": len(upd_kernels) - upd_memory_ops,
                               "memory_ops": upd_memory_ops}
        print(f"of which the DQN update alone (ResNet18, b=256): step "
              f"{extra['dqn_update']['step_ms']:.1f} ms (median of "
              f"{[round(t, 1) for t in upd_times]}); device busy {upd_busy:.1f} ms; "
              f"{len(upd_kernels) - upd_memory_ops} kernel launches (+{upd_memory_ops} "
              f"memsets/copies)")
    print(json.dumps({**extra,
        "gpu": gpu, "path": args.path, "arch": args.arch, "batch": b, "fixations": f,
        "norm_kind": args.norm_kind, "stat_fusion": args.stat_fusion,
        "step_ms": median, "step_ms_all": times, "traced_step_ms": traced_ms,
        "device_busy_ms": busy_ms, "busy_share_of_step": busy_ms / median,
        "launches": len(kernels) - memory_ops, "memory_ops": memory_ops,
        "groups_ms": by_group,
        "top": [{"name": n[:200], "ms": ms, "count": c} for n, (ms, c) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
