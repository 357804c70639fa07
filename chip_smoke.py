#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port trains on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Build every CUDA kernel of the port from ``csrc/`` with ``nvcc`` (one
   process per source, all started together: B1 and B4 in
   ``glimpse_sample.cu``, B2 ``stat_sums.cu``, B3 ``conv1x1_stats.cu``) and
   print what ``-Xptxas -v`` reports, plus the card's name and power limit;
   fail if B3's wgmma kernels spill.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, plus edge cases (B2 and B3 forward and
   backward; B1 and B4 on each of their routes), and time kernel, plain
   version, the nearest library call and the bound (bytes or operations
   over the card's peak rate), printing each shape's share of its bound
   and B1's, B3's and B4's routes (fatal if a main-path shape leaves its
   route). Then hold
   small float32 train steps on the card against the same steps on the
   CPU: ResNet10, and ResNet-50 with ``norm_kind='bn_fused'`` and
   ``stat_fusion='pallas'``; and that fused ResNet-50 at b=1, whose 1x1
   convs have row counts that are not multiples of 8, against the unfused
   one on the card, counting its B2 and B3 launches.
3. Drive the main path through its user entry point,
   ``multimodal_active_ai_tpu_torch.contrastive_learning.main``: SimCLR
   with saccades, ResNet-50, b=128, F=10, canvas 640, 3 train steps and
   validation, with the launch counters set to 0 just before and read just
   after; then resume from the checkpoint it wrote, and time further steps.
3b. The same driver run with ``--stat-fusion pallas`` (B3 launched
   3·11·36 = 1188 times, B1 35), its resume, and train steps of the
   ``norm_kind='bn_fused'`` + ``stat_fusion='pallas'`` model (B2 187 and B3
   396 launches a step), each with its counters set to 0 just before and
   read just after; median step times of all three configurations.
4. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It imports nothing of JAX. It exits non-zero without CUDA, and when the
port package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
from collections import Counter
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "multimodal_active_ai_tpu_torch"

# NVIDIA H100 SXM data-sheet peaks (dense): HBM3 bandwidth, the
# non-tensor-core float32 rate and the bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12

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
    call follows an L2 flush, and the flushes' own time is subtracted. The
    stream first sleeps ~25 ms, so the host queues every call before the
    timed ones start and host launch gaps do not count as device time."""
    def run(with_fn: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
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


def touched_pixels(torch, mip, rows, rel_y, rel_x, start, win) -> int:
    """Distinct mip pixels that some nonzero-weight tap of one level reads;
    ``rel_y``/``rel_x`` ``(B, P)``, ``start`` ``(B, 2)``, plan row ``b``
    reads mip image ``rows[b]``."""
    m = mip.shape[1]
    s = start.long().clamp(0, m - win)
    ry = rel_y.clamp(0, win - 1)
    rxa = (rel_x + s[:, 1:2]).clamp(s[:, 1:2].float(), (s[:, 1:2] + win - 1).float())
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
            taps.append(((rows[:, None] * m + y) * m + x)[keep])
    return torch.unique(torch.cat(taps)).numel()


def glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins):
    """Least bytes the sampler must move for these inputs and the flops it
    does: outputs written once, rel/scale/start read once, and each mip
    pixel that some nonzero-weight tap touches read once (6 bytes, bf16
    RGB). Returns ``(bytes, flops)``."""
    b, levels, p = rel_y.shape
    nbytes = b * 3 * levels * p * 4 + 3 * b * levels * p * 4 + start.numel() * 4
    rows = torch.arange(b, device=rel_y.device) % mips[0].shape[0]
    for li, (mip, win) in enumerate(zip(mips, wins)):
        nbytes += 6 * touched_pixels(torch, mip, rows, rel_y[:, li], rel_x[:, li],
                                     start[:, li], win)
    flops = b * levels * p * (4 * 3 * 2 + 16)  # 4 taps x 3 ch mul-add + weights/clamps
    return nbytes, flops


def bound(nbytes: float, t_ops_s: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the operations' time at their peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops_s) * 1e3, "bytes" if t_bytes >= t_ops_s else "operations"


def bound_by(totals: Counter) -> str:
    """What bounds a sum of calls: the larger of its bytes-bound and
    operations-bound parts."""
    return "bytes" if totals["bound_bytes"] >= totals["bound_operations"] else "operations"


def normwise_err(got, ref) -> tuple[float, float]:
    """``(max |got - ref|, that over max |ref|)`` in float32."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def resnet50_fused_shapes(batch: int) -> tuple[Counter, Counter]:
    """One train-mode forward of ResNet-50 (30x30 glimpses) with
    ``norm_kind='bn_fused'`` and ``stat_fusion='pallas'``: the ``(N, C)``
    of each B2 call (stem BN and the 3x3 convs' BNs) and the ``(M, K, N)``
    of each B3 call (the Bottleneck 1x1 convs and projections), counted."""
    b2, b3 = Counter(), Counter()
    side, inplanes = 30, 64
    b2[(batch * side * side, 64)] += 1
    for planes, blocks, stride in zip((64, 128, 256, 512), (3, 4, 6, 3), (1, 2, 2, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out = (side - 1) // s + 1
            m_in, m_out = batch * side * side, batch * out * out
            b3[(m_in, inplanes, planes)] += 1                 # conv1
            b2[(m_out, planes)] += 1                          # bn2 after the 3x3
            b3[(m_out, planes, 4 * planes)] += 1              # conv3
            if s != 1 or inplanes != 4 * planes:
                b3[(m_out, inplanes, 4 * planes)] += 1        # downsample
            inplanes, side = 4 * planes, out
    return b2, b3


def odd_mip_plan(torch, gen, b: int, p: int, m: int = 45, win: int = 40):
    """One level on a mip of odd side, which sends B1 and B4 to their
    2-byte gathers: random bf16 pixels, window origins past both ends of the
    mip, coordinates past both window edges, a 0/1 scale. Returns B1's
    arguments."""
    dev = torch.device("cuda")
    mip = (torch.rand(b, m, 3 * m, generator=gen, device=dev) * 255).to(torch.bfloat16)
    start = torch.randint(-3, m - win + 4, (b, 1, 2), generator=gen, device=dev,
                          dtype=torch.int32)
    rel = torch.rand(b, 1, p, 2, generator=gen, device=dev) * (win + 4) - 2
    scale = (torch.rand(b, 1, p, generator=gen, device=dev) > 0.2).float()
    return ([mip], rel[..., 0].contiguous(), rel[..., 1].contiguous(), start, scale,
            [win], [m])


def check_glimpse_sample(torch, gs, retina):
    """Phase 2: kernel vs plain on the main path's plan, edge cases and
    both routes of each kind (16-byte and scalar coordinates and output,
    32-bit-word and 2-byte gathers), the same bits on a second call; times.
    A case that leaves the route its shape calls for is fatal."""
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

    def compare(label, a, want):
        got = gs.glimpse_sample(*a)
        plan = gs.glimpse_sample.plan
        again = gs.glimpse_sample(*a)
        ref = gs.glimpse_sample_plain(*a)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        same = torch.equal(got, again)
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)) and same
        route = (plan.route, plan.gather)
        print(f"glimpse_sample {label} [{', '.join(route)}]: shape {tuple(got.shape)} "
              f"max_abs_err {max_abs:.4g} max_rel_err {max_rel:.4g} (rtol={RTOL}, "
              f"atol={ATOL}), same bits on a second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"glimpse_sample {label} disagrees with glimpse_sample_plain")
        if route != want:
            fail(f"glimpse_sample {label} takes the {route} route, expected {want}")
        return max_abs

    main = ("vec16", "pairs")
    errs = [compare("main-path plan (B=128, L=4, P=900)", args, main)]

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
                        (mips, tail_y, tail_x, tail_start, scale, wins, msizes), main))

    # multi-view plan: V·B rows against the B-image pyramid
    views = 3
    pv = retina.sample_unlabeled_params(gen, views * BATCH, CANVAS, cfg)
    errs.append(compare(f"multi-view plan (V={views}, V*B={views * BATCH})",
                        retina.sampler_args(pyramid, pv, cfg), main))

    # P not a multiple of 4: the scalar route, at the main path's size and tiny
    for p in (899, 13):
        cut = [t[..., :p].contiguous() for t in (rel_y, rel_x, scale)]
        errs.append(compare(f"main-path plan cut to P={p}",
                            (mips, cut[0], cut[1], start, cut[2], wins, msizes),
                            ("scalar", "pairs")))
    # a mip of odd side: 2-byte gathers, on both routes
    for p, route in ((900, "vec16"), (13, "scalar")):
        errs.append(compare(f"odd mip side (M=45, win=40, B={BATCH}, P={p})",
                            odd_mip_plan(torch, gen, BATCH, p), (route, "taps")))

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
    bound_ms, by = bound(nbytes, flops / PEAK_F32_FLOPS)
    print(f"glimpse_sample times (B=128, L=4, P=900) [{', '.join(main)}]: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library (4x F.grid_sample, "
          f"approximate yardstick) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.2f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP); "
          f"{100 * bound_ms / kernel_ms:.1f}% of the bound (target 50%)")
    return {
        "name": "glimpse_sample",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/glimpse_sample.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_retina.py:269",
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }, args


def check_hat_sample(torch, gs, args):
    """Phase 2, B4: the one-level sampler at each level of the main path's
    plan (B=128, P=900), the edge clamp (window flush with the mip's end,
    coordinates past both window edges), P=13 (the scalar route) and a mip
    of odd side (2-byte gathers, both routes), against its plain version,
    the same bits on a second call; times summed over the four levels, and
    each level's time beside a launch's floor (a one-element ``zero_``)
    plus its bytes at 3.35 TB/s.

    Tolerance as B1's (rtol=1e-2, atol=1e-1): both sides round the y
    weights to bf16, but from 1 - fy computed in two ways, which can land
    one bf16 step apart (up to 255 x 2^-8 ~ 1 in a pixel)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    mips, rel_y, rel_x, start, _, wins, _ = args
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    floor_ms = time_ms(torch.zeros(1, device=dev).zero_, torch, 50, flush)
    errs, totals = [], Counter()

    def compare(label, a, want):
        got = gs.hat_sample(*a)
        plan = gs.hat_sample.plan
        again = gs.hat_sample(*a)
        ref = gs.hat_sample_plain(*a)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)) and same
        err, rel = normwise_err(got, ref)
        route = (plan.route, plan.gather)
        print(f"hat_sample {label} [{', '.join(route)}]: shape {tuple(got.shape)} max_abs_err "
              f"{err:.4g} (normwise {rel:.3g}; rtol={RTOL}, atol={ATOL}), same bits on a "
              f"second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"hat_sample {label} disagrees with hat_sample_plain")
        if route != want:
            fail(f"hat_sample {label} takes the {route} route, expected {want}")
        errs.append(err)

    b = rel_y.shape[0]
    rows = torch.arange(b, device=dev)
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        rel = torch.stack([rel_y[:, li], rel_x[:, li]], -1).contiguous()
        st = start[:, li].contiguous()
        a = (mip, rel, st, win)
        compare(f"level {li} (M={m}, win={win}, B={b}, P={rel.shape[1]})", a,
                ("vec16", "pairs"))
        edge = rel.clone()
        edge[:, :64] = win - 1.0
        edge[:, 64:96, 0] = -5.0
        edge[:, 96:128, 1] = win + 9.0
        compare(f"level {li} edge clamp", (mip, edge, torch.full_like(st, m - win), win),
                ("vec16", "pairs"))
        compare(f"level {li} P=13", (mip, rel[:, :13].contiguous(), st, win),
                ("scalar", "pairs"))

        kernel = time_ms(lambda: gs.hat_sample(*a), torch, 50, flush)
        plain = time_ms(lambda: gs.hat_sample_plain(*a), torch, 5, flush)
        img = mip.view(b, m, m, 3).permute(0, 3, 1, 2).float().contiguous()
        grid = (torch.stack([rel[..., 1] + st[:, 1:2], rel[..., 0] + st[:, 0:1]], -1)[:, None]
                * (2.0 / (m - 1)) - 1.0).contiguous()
        library = time_ms(lambda: F.grid_sample(img, grid, mode="bilinear",
                                                padding_mode="border", align_corners=True),
                          torch, 20, flush)
        p = rel.shape[1]
        nbytes = b * p * (3 + 2) * 4 + st.numel() * 4 + 6 * touched_pixels(
            torch, mip, rows, rel[..., 0], rel[..., 1], st, win)
        bms, by = bound(nbytes, b * p * (4 * 3 * 2 + 16) / PEAK_F32_FLOPS)
        print(f"hat_sample times level {li}: kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
              f"library (F.grid_sample, approximate yardstick) {library:.4f} ms, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB), launch floor + bytes "
              f"{floor_ms + bms:.4f} ms ({100 * (floor_ms + bms) / kernel:.1f}% of the kernel)")
        totals.update(kernel=kernel, plain=plain, library=library, bound=bms,
                      **{f"bound_{by}": bms})
    for p, route in ((900, "vec16"), (13, "scalar")):
        mip_, ry, rx, st, _, (win,), (m,) = odd_mip_plan(torch, torch.Generator(
            device=dev).manual_seed(p), b, p)
        compare(f"odd mip side (M={m}, win={win}, B={b}, P={p})",
                (mip_[0], torch.stack([ry[:, 0], rx[:, 0]], -1).contiguous(),
                 st[:, 0].contiguous(), win), (route, "taps"))
    print(f"hat_sample times, the four levels: kernel {totals['kernel']:.4f} ms, plain "
          f"{totals['plain']:.4f} ms, library {totals['library']:.4f} ms, bound "
          f"{totals['bound']:.4f} ms, four launch floors + bytes "
          f"{4 * floor_ms + totals['bound']:.4f} ms (floor {floor_ms:.4f} ms a launch)")
    return {
        "name": "hat_sample",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/glimpse_sample.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_retina.py:89",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


def spills(log: str, kernel_fragment: str) -> list[str]:
    """The ``-Xptxas -v`` property lines of the kernels whose mangled name
    holds ``kernel_fragment`` and that spill registers."""
    bad, current = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line
        elif "spill" in line and kernel_fragment in current:
            stores, loads = (int(line.split(" bytes spill " + kind)[0].split()[-1])
                             for kind in ("stores", "loads"))
            if stores or loads:
                bad.append(f"{current.split()[-1]}: {line.strip()}")
    return bad


def check_stat_sums(torch, ss):
    """Phase 2, B2: ``stat_sums`` at every ``(N, C)`` of the ResNet-50 b=128
    ``bn_fused`` + ``stat_fusion='pallas'`` forward, in bf16 and float32,
    plus tails, against ``stat_sums_plain``, with the gradient; times at the
    main-path shapes (bf16), each and summed over one forward's 17 calls.

    Tolerance: both sides sum the same float32 values in other orders:
    normwise 1e-5 on the statistics and on the gradient."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    shapes, _ = resnet50_fused_shapes(BATCH)
    errs, totals = [], Counter()
    cases = [(n, c, dt) for (n, c) in shapes for dt in (torch.bfloat16, torch.float32)]
    cases += [(40, 24, torch.float32), (40, 24, torch.bfloat16), (1001, 64, torch.bfloat16),
              (333, 3, torch.float32)]
    for n, c, dt in cases:
        x = (torch.randn(n, c, device=dev, generator=gen) * 2 + 1).to(dt)
        got = ss.stat_sums(x)
        again = ss.stat_sums(x)
        ref = ss.stat_sums_plain(x)
        xg = x.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        cot = torch.randn(2, c, device=dev, generator=gen)
        s, sq = ss.stat_sums(xg)
        ((s * cot[0]).sum() + (sq * cot[1]).sum()).backward()
        rs, rsq = ss.stat_sums_plain(xr)
        ((rs * cot[0]).sum() + (rsq * cot[1]).sum()).backward()
        torch.cuda.synchronize()
        stats = [normwise_err(g, r) for g, r in zip(got, ref)]
        gerr = normwise_err(xg.grad, xr.grad)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = max(e[1] for e in stats) <= 1e-5 and gerr[1] <= 1e-5 and same
        print(f"stat_sums ({n}, {c}) {str(dt)[6:]}: normwise err sum {stats[0][1]:.3g} "
              f"sumsq {stats[1][1]:.3g} grad {gerr[1]:.3g} (tol 1e-5), same bits on a "
              f"second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"stat_sums ({n}, {c}) {dt} disagrees with stat_sums_plain")
        errs += [e[0] for e in stats]
        if dt != torch.bfloat16 or (n, c) not in shapes:
            continue
        count = shapes[(n, c)]

        def library():
            xf = x.float()
            torch.sum(xf, 0)
            torch.sum(xf ** 2, 0)

        kernel = time_ms(lambda: ss.stat_sums(x), torch, 20, flush)
        plain = time_ms(lambda: ss.stat_sums_plain(x), torch, 10, flush)
        lib = time_ms(library, torch, 10, flush)
        bms, by = bound(n * c * 2 + 2 * c * 4, 3 * n * c / PEAK_F32_FLOPS)
        print(f"stat_sums times ({n}, {c}) bf16 x{count}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, library (torch.sum of x and x^2) {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({by}; {100 * bms / kernel:.1f}% of it)")
        totals.update(kernel=count * kernel, plain=count * plain, library=count * lib,
                      bound=count * bms, **{f"bound_{by}": count * bms})
    print(f"stat_sums times, one forward ({sum(shapes.values())} calls): kernel "
          f"{totals['kernel']:.4f} ms, plain {totals['plain']:.4f} ms, library "
          f"{totals['library']:.4f} ms, bound {totals['bound']:.4f} ms "
          f"({100 * totals['bound'] / totals['kernel']:.1f}% of it)")
    return {
        "name": "stat_sums",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/stat_sums.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_bn.py:52",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


def check_conv1x1_stats(torch, cs, sms):
    """Phase 2, B3: ``conv1x1_stats`` at the 15 distinct ``(M, K, N)`` of
    ResNet-50's 36 fused 1x1 convs per forward at b=128 (bf16), float32 at
    two of them, and the tails (96, 24, 40), (64, 16, 64), (100, 12, 7) and,
    in bf16, (1000, 64, 200) (M and N not multiples of the tile), against
    ``conv1x1_stats_plain``; gradients with nonzero cotangents on y, Σy and
    Σy² against autograd through the plain version; times (bf16) per shape
    and summed over one forward. Each case prints its route
    (``conv1x1_plan`` on this card's ``sms``); a main-path shape off the
    wgmma route is fatal.

    Tolerances, normwise (max error over the largest reference value): y
    in bf16 2^-7 (the two float32 products may round to neighbouring bf16
    values: one step is 2^-8 of the value), float32 1e-5; Σy and Σy² 1e-4
    (float32 sums in other orders); gradients 2e-2 in bf16 (the shared
    backward rounds dy + dΣ + 2y·dΣ² to bf16 and uses the rounded y, the
    autograd reference does neither), 1e-4 in float32."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    _, shapes = resnet50_fused_shapes(BATCH)
    assert len(shapes) == 15 and sum(shapes.values()) == 36, shapes
    cases = [(mkn, torch.bfloat16) for mkn in shapes]
    cases += [((28800, 512, 128), torch.float32), ((2048, 1024, 2048), torch.float32)]
    cases += [(mkn, dt) for mkn in ((96, 24, 40), (64, 16, 64), (100, 12, 7))
              for dt in (torch.bfloat16, torch.float32)]
    cases += [((1000, 64, 200), torch.bfloat16)]
    errs, totals = [], Counter()
    for (m, k, n), dt in cases:
        bf16 = dt == torch.bfloat16
        route = cs.conv1x1_plan(m, k, n, sms, bf16).route
        if bf16 and (m, k, n) in shapes and route != "wgmma":
            fail(f"conv1x1_stats main-path shape {(m, k, n)} takes the {route} route")
        x = torch.relu(torch.randn(m, k, device=dev, generator=gen)).to(dt)
        w = (torch.randn(n, k, device=dev, generator=gen) * (2.0 / k) ** 0.5).to(dt)
        got = cs.conv1x1_stats(x, w)
        again = cs.conv1x1_stats(x, w)
        ref = cs.conv1x1_stats_plain(x, w)
        cot = [torch.randn(m, n, device=dev, generator=gen).to(dt),
               torch.randn(n, device=dev, generator=gen),
               torch.randn(n, device=dev, generator=gen) / m ** 0.5]
        grads = []
        for fn in (cs.conv1x1_stats, cs.conv1x1_stats_plain):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            outs = fn(xg, wg)
            sum((o.float() * c.float()).sum() for o, c in zip(outs, cot)).backward()
            grads.append((xg.grad, wg.grad))
        torch.cuda.synchronize()
        yerr = normwise_err(got[0], ref[0])
        serr = [normwise_err(g, r) for g, r in zip(got[1:], ref[1:])]
        gerr = [normwise_err(g, r) for g, r in zip(*grads)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ytol, gtol = (2**-7, 2e-2) if bf16 else (1e-5, 1e-4)
        ok = (yerr[1] <= ytol and max(e[1] for e in serr) <= 1e-4
              and max(e[1] for e in gerr) <= gtol and same
              and all(bool(torch.isfinite(t).all()) for t in got))
        print(f"conv1x1_stats ({m}, {k}, {n}) {str(dt)[6:]} [{route}]: normwise err y {yerr[1]:.3g} "
              f"(tol {ytol:.3g}), sum {serr[0][1]:.3g} sumsq {serr[1][1]:.3g} (tol 1e-4), "
              f"grad x {gerr[0][1]:.3g} w {gerr[1][1]:.3g} (tol {gtol:.3g}), same bits on "
              f"a second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"conv1x1_stats ({m}, {k}, {n}) {dt} disagrees with conv1x1_stats_plain")
        errs += [yerr[0]] + [e[0] for e in serr]
        if not bf16 or (m, k, n) not in shapes:
            continue
        count = shapes[(m, k, n)]
        kernel = time_ms(lambda: cs.conv1x1_stats(x, w), torch, 20, flush)
        plain = time_ms(lambda: cs.conv1x1_stats_plain(x, w), torch, 5, flush)
        lib = time_ms(lambda: torch.matmul(x, w.t()), torch, 20, flush)
        bms, by = bound((m * k + n * k + m * n) * 2 + 2 * n * 4,
                        2 * m * n * k / PEAK_BF16_TENSOR_FLOPS + 3 * m * n / PEAK_F32_FLOPS)
        print(f"conv1x1_stats times ({m}, {k}, {n}) bf16 x{count} [{route}]: kernel "
              f"{kernel:.4f} ms, plain {plain:.4f} ms, library (torch.matmul bf16, no "
              f"statistics) {lib:.4f} ms, bound {bms:.4f} ms ({by}; {100 * bms / kernel:.1f}% "
              f"of it)")
        totals.update(kernel=count * kernel, plain=count * plain, library=count * lib,
                      bound=count * bms, **{f"bound_{by}": count * bms})
    print(f"conv1x1_stats times, one forward (36 calls): kernel {totals['kernel']:.4f} ms, "
          f"plain {totals['plain']:.4f} ms, library {totals['library']:.4f} ms, bound "
          f"{totals['bound']:.4f} ms ({totals['bound_bytes']:.4f} of it bound by bytes, "
          f"{totals['bound_operations']:.4f} by operations; "
          f"{100 * totals['bound'] / totals['kernel']:.1f}% of the kernel time)")
    return {
        "name": "conv1x1_stats",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/conv1x1_stats.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_conv_bn.py:65",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


def _card_sampler(torch, gs):
    """B1 on the card for a step on the CPU: the sampler's arguments go to
    the card and its glimpses come back, so that a CPU step samples as the
    card step does (the plain sampler rounds the y weights to bf16, the
    kernel keeps them float32)."""
    def sample(mips, rel_y, rel_x, start, scale, wins, msizes=None):
        def card(t):
            return t.cuda().contiguous()
        return gs.glimpse_sample([card(m) for m in mips], card(rel_y), card(rel_x),
                                 card(start), card(scale), wins, msizes).cpu()
    return sample


def _small_step_losses(torch, retina, dev, arch, f=2, sampler=None, **kinds):
    """Per-fixation losses of one small float32 train step (b=8, F=f,
    canvas 64) on ``dev``, from seeded weights, images and draws that do not
    depend on the device or the model's kinds; ``sampler``, if given,
    stands in for the retina's glimpse sampler during the step."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    cfg = retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30))
    b = 8
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (b, 64, 64, 3), dtype=torch.uint8, generator=gen)
    params = [retina.sample_unlabeled_params(gen, b, 64, cfg) for _ in range(f + 1)]
    noise = [torch.randn(b, 30, 30, 12, generator=gen) for _ in range(f + 1)]
    model = SimCLRModule(arch, generator=torch.Generator().manual_seed(0), **kinds).to(dev)
    state = simclr_train.TrainState(
        model, optimizers.get_optimizer("adam", model.parameters()),
        schedule.simclr_learning_rate(0.01, b, 64, b, 0, 5))
    step = simclr_train.make_train_step(cfg, f, 0.05)
    kept = retina.glimpse_sample
    retina.glimpse_sample = sampler or kept
    try:
        return step(state, images.to(dev),
                    params=[retina.AugParams(*[x.to(dev) for x in p]) for p in params],
                    noise=[n.to(dev) for n in noise]).cpu()
    finally:
        retina.glimpse_sample = kept


def check_small_step(torch, retina, gs):
    """Phase 2b: small float32 train steps on the card (CUDA kernels)
    against the same steps on the CPU (plain versions; the path the CPU
    tests hold against the JAX package), from equal weights, images and
    draws (b=8, F=2, canvas 64); tolerance 1e-2 relative on the
    per-fixation losses.

    ResNet10: the CPU step samples with the plain version, whose y weights
    are rounded to bf16 where the B1 kernel keeps them float32 (glimpse
    elements differ by up to 2^-9 relative; NT-Xent at T=0.05 amplifies
    projection differences ~20x). ResNet-50 with ``norm_kind='bn_fused'``
    and ``stat_fusion='pallas'`` (B2, B3): that difference moves its loss by
    a few percent, so its CPU step takes its glimpses from the B1 kernel
    (:func:`_card_sampler`) and both sides see the same glimpses up to the
    pyramids' bf16 rounding, leaving B2 and B3 against their plain versions.

    Then the same ResNet-50 step on the card without fusion (norm 'bn',
    cuDNN 1x1 convs, ``.mean()`` statistics) must match the fused one to
    5e-3 (on the CPU the two agree to 2e-6 on the first loss and 7e-4 on
    the second, after one Adam step)."""
    fused = dict(norm_kind="bn_fused", stat_fusion="pallas")
    for arch, kinds, sampler in [("ResNet10", {}, None),
                                 ("ResNet50", fused, _card_sampler(torch, gs))]:
        losses = {"cpu": _small_step_losses(torch, retina, "cpu", arch, 2, sampler, **kinds),
                  "cuda": _small_step_losses(torch, retina, "cuda", arch, 2, **kinds)}
        ok = bool(torch.allclose(losses["cuda"], losses["cpu"], rtol=1e-2, atol=0.0))
        glimpses = "the card's glimpses on both sides" if sampler else "plain sampler on the cpu"
        print(f"small f32 train step ({arch} {kinds or ''}, b=8, F=2, canvas 64; {glimpses}): "
              f"cuda losses {losses['cuda'].tolist()} vs cpu {losses['cpu'].tolist()} "
              f"(rtol=1e-2) {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(losses["cuda"]).all()):
            fail(f"the {arch} train step on the card disagrees with the CPU step")
    on_card = [_small_step_losses(torch, retina, "cuda", "ResNet50", 2, **k) for k in (fused, {})]
    ok = bool(torch.allclose(on_card[0], on_card[1], rtol=5e-3, atol=0.0))
    print(f"small f32 train step (ResNet50, b=8, F=2, canvas 64) on the card: bn_fused + "
          f"pallas {on_card[0].tolist()} vs unfused bn {on_card[1].tolist()} (rtol=5e-3) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the fused ResNet50 step disagrees with the unfused one on the card")


def check_odd_rows(torch, counters):
    """Phase 2c: ResNet-50 encoder features in train mode at b=1, where the
    1x1 convs have N·H·W = 900, 225, 64 and 16 rows (the first two not
    multiples of 8). With ``norm_kind='bn_fused'`` and
    ``stat_fusion='pallas'`` each of the 36 fused convs launches B3 and
    each of the 17 other norms B2, with the counters set to 0 just before
    and read just after; the float32 features match those of the unfused
    model with the same weights (cuDNN convs, ``.mean()`` statistics) to
    normwise 1e-3 (BatchNorm over layer4's 16 pixels amplifies roundings:
    on the CPU the two models' plain paths differ by 2.7e-5)."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule

    b2, b3 = resnet50_fused_shapes(1)
    rows = sorted({m for m, _, _ in b3}, reverse=True)
    want = {"glimpse_sample": 0, "hat_sample": 0, "stat_sums": sum(b2.values()),
            "conv1x1_stats": sum(b3.values())}
    dev = torch.device("cuda")
    x = torch.rand(1, 30, 30, 12, generator=torch.Generator().manual_seed(4)).to(dev)
    models = [SimCLRModule(ARCH, norm_kind=n, stat_fusion=f,
                           generator=torch.Generator().manual_seed(0))
              for n, f in (("bn_fused", "pallas"), ("bn", None))]
    models[1].load_state_dict(models[0].state_dict())
    feats = []
    for model in models:
        model = model.to(dev).to(memory_format=torch.channels_last)
        reset_counts(counters.values())
        with torch.no_grad():
            feats.append(model.features(x))
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        if got != (want if len(feats) == 1 else dict.fromkeys(want, 0)):
            fail(f"b=1 forward {len(feats)} of (bn_fused + pallas, bn) launches {got}")
    _, rel = normwise_err(feats[0], feats[1])
    ok = rel <= 1e-3 and bool(torch.isfinite(feats[0]).all())
    print(f"b=1 bn_fused + pallas forward (1x1 conv rows {rows}): launches {want}; features "
          f"vs unfused bn normwise err {rel:.3g} (tol 1e-3) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the b=1 fused ResNet50 features disagree with the unfused ones")


TRAIN_STEPS = min(math.ceil(EXAMPLES / BATCH), 12)
EVAL_STEPS = min(math.ceil(max(EXAMPLES // 10, BATCH) / BATCH), 12)


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def step_times(torch, state, label, device_name, peak_gib=None) -> float:
    """Median host time of 3 synchronised train steps on ``state`` (bf16,
    ResNet-50 b=128 F=10 canvas 640); fails on non-finite losses."""
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
    mem = "" if peak_gib is None else f"; peak memory {peak_gib:.2f} GiB"
    print(f"train step {label} ({ARCH}, b={BATCH}, F={FIXATIONS}, canvas {CANVAS}, "
          f"bf16): median {times[1]:.1f} ms over 3 steps {[round(t, 1) for t in times]}, "
          f"{BATCH / times[1] * 1e3:.1f} img/s{mem} [{device_name}]")
    return times[1]


def drive_and_check(torch, driver, ckpt_mod, argv, ckdir, label):
    """One driver run (3 train steps + validation) and its resume, checked;
    returns the trained state and the wall time of the first run."""
    t0 = time.perf_counter()
    state = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ck = os.path.join(ckdir, "checkpoint.pth.tar")
    if not os.path.isfile(ck):
        fail(f"contrastive_learning {label} wrote no checkpoint")
    payload = ckpt_mod.load_checkpoint(ck)
    hist = payload["loss_history"]
    if not hist or not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss history {hist}")
    if payload["step"] != TRAIN_STEPS * FIXATIONS or state.step != payload["step"]:
        fail(f"optimizer updates {state.step}/{payload['step']}, "
             f"expected {TRAIN_STEPS * FIXATIONS}")
    print(f"checkpoint {label} {os.path.basename(ck)}: epoch {payload['epoch']}, "
          f"step {payload['step']}, loss_history {hist}")
    return state, payload, ck, wall


def run_main_path(torch, counters, driver, ckpt_mod, device_name):
    """Phase 3: the SimCLR driver at full ResNet-50 width, then a resume."""
    gs = counters["glimpse_sample"]
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
                "-f", str(FIXATIONS), "--canvas-size", str(CANVAS),
                "--epochs", "1", "-t", "--num-examples", str(EXAMPLES),
                "--checkpoint-dir", ckdir, "-p", "1"]
        train_steps, eval_steps = TRAIN_STEPS, EVAL_STEPS
        expected = train_steps * (1 + FIXATIONS) + 2 * eval_steps

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        state, payload, ck, wall = drive_and_check(torch, driver, ckpt_mod, argv, ckdir, "")
        launches = gs.launches
        others = {k: c.launches for k, c in counters.items() if k != "glimpse_sample"}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"main path: {train_steps} train steps x (1+{FIXATIONS}) views + "
              f"{eval_steps} eval step(s); glimpse_sample launches {launches} "
              f"(expected {expected}); other kernels {others} (off this path); "
              f"wall {wall:.2f} s incl. first-call set-up")
        if launches != expected:
            fail(f"glimpse_sample launched {launches} times, expected {expected}")
        if any(others.values()):
            fail(f"kernels off the bn path launched: {others}")

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
        step_ms = step_times(torch, state, "bn", device_name, peak_gib)
        return launches, step_ms
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def run_stat_fusion_paths(torch, counters, driver, ckpt_mod, device_name):
    """Phase 3b: the driver with ``--stat-fusion pallas`` (3 train steps +
    validation, then a resume), and train steps of the ``bn_fused`` +
    ``pallas`` model through ``make_train_step``; each path's counters set
    to 0 just before it and read just after. Returns the launch counts and
    the median step times."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    fused_b2, fused_b3 = resnet50_fused_shapes(BATCH)
    per_forward_b2, per_forward_b3 = sum(fused_b2.values()), sum(fused_b3.values())
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_fused_")
    try:
        argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
                "-f", str(FIXATIONS), "--canvas-size", str(CANVAS),
                "--epochs", "1", "-t", "--num-examples", str(EXAMPLES),
                "--checkpoint-dir", ckdir, "-p", "1", "--stat-fusion", "pallas"]
        # eval mode runs the plain product with the running statistics: no B3
        want = {"glimpse_sample": TRAIN_STEPS * (1 + FIXATIONS) + 2 * EVAL_STEPS,
                "conv1x1_stats": TRAIN_STEPS * (1 + FIXATIONS) * per_forward_b3,
                "stat_sums": 0, "hat_sample": 0}
        torch.cuda.synchronize()
        reset_counts(counters.values())
        state, payload, ck, wall = drive_and_check(
            torch, driver, ckpt_mod, argv, ckdir, "--stat-fusion pallas")
        got = {k: c.launches for k, c in counters.items()}
        print(f"--stat-fusion pallas path: launches {got} (expected {want}); wall "
              f"{wall:.2f} s incl. first-call set-up")
        if got != want:
            fail(f"--stat-fusion pallas launches {got}, expected {want}")
        pallas_launches = got["conv1x1_stats"]
        resumed = driver.main(argv + ["--resume", ck])
        sd = payload["state_dict"]
        now = resumed.model.state_dict()
        if resumed.step != payload["step"] or not all(
                torch.equal(now[k].cpu(), sd[k].cpu()) for k in sd):
            fail("--stat-fusion pallas resume did not restore the checkpoint")
        print(f"resume --stat-fusion pallas: restored step {resumed.step} and all "
              f"{len(sd)} state_dict tensors")
        pallas_ms = step_times(torch, state, "--stat-fusion pallas", device_name)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    dev = torch.device("cuda")
    model = SimCLRModule(ARCH, norm_kind="bn_fused", stat_fusion="pallas",
                         dtype=torch.bfloat16, generator=torch.Generator().manual_seed(15))
    model = model.to(dev).to(memory_format=torch.channels_last)
    fstate = simclr_train.TrainState(
        model, optimizers.get_optimizer("adam", model.parameters()),
        schedule.simclr_learning_rate(0.01, BATCH, EXAMPLES, BATCH, 10, 190))
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS),
                                        FIXATIONS, 0.05)
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    want = {"glimpse_sample": 1 + FIXATIONS, "hat_sample": 0,
            "stat_sums": (1 + FIXATIONS) * per_forward_b2,
            "conv1x1_stats": (1 + FIXATIONS) * per_forward_b3}
    torch.cuda.synchronize()
    reset_counts(counters.values())
    losses = step(fstate, images, gen)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    print(f"bn_fused + pallas train step: launches {got} (expected {want}); losses "
          f"{[round(x, 4) for x in losses.tolist()]}")
    if got != want:
        fail(f"bn_fused + pallas launches {got}, expected {want}")
    if not bool(torch.isfinite(losses).all()):
        fail(f"non-finite losses {losses.tolist()}")
    fused_ms = step_times(torch, fstate, "bn_fused + pallas", device_name)
    return {"conv1x1_stats": pallas_launches, "stat_sums": got["stat_sums"],
            "hat_sample": got["hat_sample"], "pallas_ms": pallas_ms, "bn_fused_ms": fused_ms}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py; run it from the repository root")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from multimodal_active_ai_tpu_torch import contrastive_learning as driver
    from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs
    from multimodal_active_ai_tpu_torch.ops import cuda_build, retina
    from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs
    from multimodal_active_ai_tpu_torch.ops import stat_sums as ss
    from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt_mod

    # phase 1: build
    t0 = time.perf_counter()
    built = cuda_build.build(["glimpse_sample", "stat_sums", "conv1x1_stats"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for b in built.values():
        print(f"--- nvcc -Xptxas -v: {b.name} ---\n{b.log.strip()}")
    spilled = spills(built["conv1x1_stats"].log, "wgmma_kernel")
    if spilled:
        fail("B3's wgmma kernels spill registers:\n" + "\n".join(spilled))
    device_name = gpu_name_and_power()
    print(f"gpu (name, power limit): {device_name}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: kernels against their plain versions
    b1, args = check_glimpse_sample(torch, gs, retina)
    rows = {"glimpse_sample": b1,
            "stat_sums": check_stat_sums(torch, ss),
            "conv1x1_stats": check_conv1x1_stats(torch, cs, ss.sm_count(0)),
            "hat_sample": check_hat_sample(torch, gs, args)}
    check_small_step(torch, retina, gs)
    counters = {"glimpse_sample": gs.glimpse_sample, "stat_sums": ss.stat_sums,
                "conv1x1_stats": cs.conv1x1_stats, "hat_sample": gs.hat_sample}
    check_odd_rows(torch, counters)

    # phase 3: the main path (norm 'bn'); 3b: the fused-statistics paths
    rows["glimpse_sample"]["launches"], bn_ms = run_main_path(
        torch, counters, driver, ckpt_mod, device_name)
    fused = run_stat_fusion_paths(torch, counters, driver, ckpt_mod, device_name)
    rows["conv1x1_stats"]["launches"] = fused["conv1x1_stats"]
    rows["stat_sums"]["launches"] = fused["stat_sums"]
    rows["hat_sample"]["launches"] = fused["hat_sample"]   # no production caller
    print(f"median train step ({ARCH}, b={BATCH}, F={FIXATIONS}, canvas {CANVAS}, bf16): "
          f"bn {bn_ms:.1f} ms, --stat-fusion pallas {fused['pallas_ms']:.1f} ms, "
          f"bn_fused + pallas {fused['bn_fused_ms']:.1f} ms [{device_name}]")

    # phase 4: results
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
