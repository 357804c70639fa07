#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port trains on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Build every CUDA kernel of the main path from ``csrc/`` with ``nvcc``
   (one process per source, all started together) and print what
   ``-Xptxas -v`` reports, plus the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, plus edge cases, and time kernel, plain version,
   the nearest library call and the bound (bytes or operations over the
   card's peak rate). Then hold one small float32 train step on the card
   against the same step on the CPU.
3. Drive the main path through its user entry point,
   ``multimodal_active_ai_tpu_torch.contrastive_learning.main``: SimCLR
   with saccades, ResNet-50, b=128, F=10, canvas 640, 3 train steps and
   validation, with the launch counters set to 0 just before and read just
   after; then resume from the checkpoint it wrote, and time further steps.
4. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It imports nothing of JAX. It exits non-zero without CUDA, and when the
port package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "multimodal_active_ai_tpu_torch"

# NVIDIA H100 SXM data-sheet peaks (dense): HBM3 bandwidth and the
# non-tensor-core float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

ARCH, BATCH, FIXATIONS, CANVAS, EXAMPLES = "ResNet50", 128, 10, 640, 384
RTOL, ATOL = 1e-2, 1e-1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls with a cold L2: each
    call follows an L2 flush, and the flushes' own time is subtracted."""
    def run(with_fn: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            flush()
            if with_fn:
                fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)
    fn()
    run(True)  # warm-up
    return max(run(True) - run(False), 0.0) / iters


def glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins):
    """Least bytes the sampler must move for these inputs and the flops it
    does: outputs written once, rel/scale/start read once, and each mip
    pixel that some nonzero-weight tap touches read once (6 bytes, bf16
    RGB). Returns ``(bytes, flops)``."""
    b, levels, p = rel_y.shape
    src_b = mips[0].shape[0]
    nbytes = b * 3 * levels * p * 4 + 3 * b * levels * p * 4 + start.numel() * 4
    rows = (torch.arange(b, device=rel_y.device) % src_b)[:, None]
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        s = start[:, li].long().clamp(0, m - win)
        ry = rel_y[:, li].clamp(0, win - 1)
        rxa = (rel_x[:, li] + s[:, 1:2]).clamp(s[:, 1:2].float(), (s[:, 1:2] + win - 1).float())
        y0 = ry.floor()
        x0 = rxa.floor()
        taps = []
        for dy in (0, 1):
            for dx in (0, 1):
                keep = torch.ones_like(ry, dtype=torch.bool)
                if dy:
                    keep &= (ry - y0) > 0
                if dx:
                    keep &= (rxa - x0) > 0
                y = s[:, 0:1] + y0.long() + dy
                x = x0.long() + dx
                taps.append(((rows * m + y) * m + x)[keep])
        nbytes += torch.unique(torch.cat(taps)).numel() * 6
    flops = b * levels * p * (4 * 3 * 2 + 16)  # 4 taps x 3 ch mul-add + weights/clamps
    return nbytes, flops


def check_glimpse_sample(torch, gs, retina):
    """Phase 2: kernel vs plain on the main path's plan, edge cases, times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    cfg = retina.RetinaConfig(canvas_size=CANVAS, grid_mask_prob=1.0)
    pyramid = retina.build_pyramid(images, cfg)
    params = retina.sample_unlabeled_params(gen, BATCH, CANVAS, cfg)
    if not (bool(params.flip.any()) and bool((params.gm_ratio > 0).all())
            and bool((params.angle != 0).any())):
        fail("the plan does not exercise flip, rotation and the grid mask")
    args = retina.sampler_args(pyramid, params, cfg)
    mips, rel_y, rel_x, start, scale, wins, msizes = args

    def compare(label, a):
        got = gs.glimpse_sample(*a)
        ref = gs.glimpse_sample_plain(*a)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
        print(f"glimpse_sample {label}: shape {tuple(got.shape)} max_abs_err "
              f"{max_abs:.4g} max_rel_err {max_rel:.4g} "
              f"(rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"glimpse_sample {label} disagrees with glimpse_sample_plain")
        return max_abs

    errs = [compare("main-path plan (B=128, L=4, P=900)", args)]

    # tail clamp: windows flush with the mip's end, taps on the last row/col
    tail_start = start.clone()
    tail_y, tail_x = rel_y.clone(), rel_x.clone()
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        tail_start[:, li] = m - win
        tail_y[:, li, :64] = win - 1.0
        tail_x[:, li, :64] = win - 1.0
        tail_y[:, li, 64:128] = win - 1.0
    errs.append(compare("tail clamp (start = M - win, ry = win - 1)",
                        (mips, tail_y, tail_x, tail_start, scale, wins, msizes)))

    # multi-view plan: V·B rows against the B-image pyramid
    views = 3
    pv = retina.sample_unlabeled_params(gen, views * BATCH, CANVAS, cfg)
    errs.append(compare(f"multi-view plan (V={views}, V*B={views * BATCH})",
                        retina.sampler_args(pyramid, pv, cfg)))

    # times at the main-path shapes, L2 flushed before each call
    flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    kernel_ms = time_ms(lambda: gs.glimpse_sample(*args), torch, 50, flush)
    plain_ms = time_ms(lambda: gs.glimpse_sample_plain(*args), torch, 5, flush)

    # nearest library call (yardstick only; the port never calls it):
    # one bilinear F.grid_sample per level on float32 NCHW mips, edge
    # handling 'border' rather than the window clamp, no scale multiply
    import torch.nn.functional as F
    lib_in, lib_grid = [], []
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        img = mip.view(BATCH, m, m, 3).permute(0, 3, 1, 2).float().contiguous()
        s = start[:, li].float()
        ay = rel_y[:, li] + s[:, 0:1]
        ax = rel_x[:, li] + s[:, 1:2]
        grid = torch.stack([ax, ay], -1)[:, None] * (2.0 / (m - 1)) - 1.0
        lib_in.append(img)
        lib_grid.append(grid.contiguous())

    def library():
        for img, grid in zip(lib_in, lib_grid):
            F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
    library_ms = time_ms(library, torch, 20, flush)

    nbytes, flops = glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"glimpse_sample times (B=128, L=4, P=900): kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (4x F.grid_sample, approximate "
          f"yardstick) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.2f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP)")
    return {
        "name": "glimpse_sample",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/glimpse_sample.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_retina.py:269",
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def check_small_step(torch, retina):
    """Phase 2b: one small float32 train step on the card (CUDA kernel)
    against the same step on the CPU (plain sampler; the path the CPU tests
    hold against the JAX package), from equal weights, images and draws.

    Tolerance 1e-2 relative on the per-fixation losses: the kernel keeps
    the y weights f32 where the plain version rounds them to bf16 (glimpse
    elements differ by up to 2^-9 relative), cuDNN and the CPU sum in other
    orders, and NT-Xent at T=0.05 amplifies projection differences ~20x."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    cfg = retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30))
    b, f = 8, 2
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (b, 64, 64, 3), dtype=torch.uint8, generator=gen)
    params = [retina.sample_unlabeled_params(gen, b, 64, cfg) for _ in range(f + 1)]
    noise = [torch.randn(b, 30, 30, 12, generator=gen) for _ in range(f + 1)]
    losses = {}
    for dev in ("cpu", "cuda"):
        model = SimCLRModule("ResNet10", generator=torch.Generator().manual_seed(0)).to(dev)
        state = simclr_train.TrainState(
            model, optimizers.get_optimizer("adam", model.parameters()),
            schedule.simclr_learning_rate(0.01, b, 64, b, 0, 5))
        step = simclr_train.make_train_step(cfg, f, 0.05)
        losses[dev] = step(state, images.to(dev),
                           params=[retina.AugParams(*[x.to(dev) for x in p]) for p in params],
                           noise=[n.to(dev) for n in noise]).cpu()
    ok = bool(torch.allclose(losses["cuda"], losses["cpu"], rtol=1e-2, atol=0.0))
    print(f"small f32 train step (ResNet10, b={b}, F={f}, canvas 64): cuda losses "
          f"{losses['cuda'].tolist()} vs cpu {losses['cpu'].tolist()} (rtol=1e-2) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok or not bool(torch.isfinite(losses["cuda"]).all()):
        fail("the train step on the card disagrees with the CPU step")


def run_main_path(torch, gs, driver, ckpt_mod, device_name):
    """Phase 3: the SimCLR driver at full ResNet-50 width, then a resume."""
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
                "-f", str(FIXATIONS), "--canvas-size", str(CANVAS),
                "--epochs", "1", "-t", "--num-examples", str(EXAMPLES),
                "--checkpoint-dir", ckdir, "-p", "1"]
        train_steps = min(math.ceil(EXAMPLES / BATCH), 12)
        eval_steps = min(math.ceil(max(EXAMPLES // 10, BATCH) / BATCH), 12)
        expected = train_steps * (1 + FIXATIONS) + 2 * eval_steps

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gs.glimpse_sample.launches = 0
        t0 = time.perf_counter()
        state = driver.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gs.glimpse_sample.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"main path: {train_steps} train steps x (1+{FIXATIONS}) views + "
              f"{eval_steps} eval step(s); glimpse_sample launches {launches} "
              f"(expected {expected}); wall {wall:.2f} s incl. first-call set-up")
        if launches != expected:
            fail(f"glimpse_sample launched {launches} times, expected {expected}")

        ck = os.path.join(ckdir, "checkpoint.pth.tar")
        if not os.path.isfile(ck):
            fail("contrastive_learning wrote no checkpoint")
        payload = ckpt_mod.load_checkpoint(ck)
        hist = payload["loss_history"]
        if not hist or not all(math.isfinite(x) for x in hist):
            fail(f"non-finite loss history {hist}")
        if payload["step"] != train_steps * FIXATIONS or state.step != payload["step"]:
            fail(f"optimizer updates {state.step}/{payload['step']}, "
                 f"expected {train_steps * FIXATIONS}")
        print(f"checkpoint {os.path.basename(ck)}: epoch {payload['epoch']}, "
              f"step {payload['step']}, loss_history {hist}")

        resumed = driver.main(argv + ["--resume", ck])
        want = payload["state_dict"]
        got = resumed.model.state_dict()
        same = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
        if resumed.step != payload["step"] or not same:
            fail("resume did not restore the checkpoint")
        print(f"resume: restored step {resumed.step} and all "
              f"{len(want)} state_dict tensors")

        # steady-state step time on the trained state (host clock around a
        # synchronised step; the launch count above is already read)
        from multimodal_active_ai_tpu_torch.ops import retina
        from multimodal_active_ai_tpu_torch.train import simclr_train
        cfg = retina.RetinaConfig(canvas_size=CANVAS)
        step = simclr_train.make_train_step(cfg, FIXATIONS, 0.05)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(1)
        images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                               dtype=torch.uint8, device=dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = step(state, images, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(losses).all()):
                fail(f"non-finite losses {losses.tolist()}")
        times.sort()
        print(f"train step ({ARCH}, b={BATCH}, F={FIXATIONS}, canvas {CANVAS}, "
              f"bf16): median {times[1]:.1f} ms over 3 steps {[round(t, 1) for t in times]}, "
              f"{BATCH / times[1] * 1e3:.1f} img/s; peak memory {peak_gib:.2f} GiB "
              f"[{device_name}]")
        return launches
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py; run it from the repository root")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from multimodal_active_ai_tpu_torch import contrastive_learning as driver
    from multimodal_active_ai_tpu_torch.ops import cuda_build, retina
    from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs
    from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt_mod

    # phase 1: build
    t0 = time.perf_counter()
    built = cuda_build.build(["glimpse_sample"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for b in built.values():
        print(f"--- nvcc -Xptxas -v: {b.name} ---\n{b.log.strip()}")
    device_name = gpu_name_and_power()
    print(f"gpu (name, power limit): {device_name}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: kernels against their plain versions
    rows = [check_glimpse_sample(torch, gs, retina)]
    check_small_step(torch, retina)

    # phase 3: the main path
    launches = run_main_path(torch, gs, driver, ckpt_mod, device_name)
    rows[0]["launches"] = launches

    # phase 4: results
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
