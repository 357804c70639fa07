#!/usr/bin/env python3
"""What the parts of the statistic kernels B2 and B3 cost, on one GPU.

Builds, beside each shipped kernel, variants that leave one part out, and
times all of them at the ResNet-50 b=128 main-path shapes the way
``chip_smoke.py`` times kernels (L2 flushed before every call, host launch
gaps hidden):

* B2 ``stat_sums``: as shipped; ``ticket only`` (the blocks write their
  partial rows and draw their tickets, the last block writes zeros instead
  of adding the rows); ``no finish`` (the blocks write their partial rows
  and stop: no ticket, no sum of the rows).
* B3 ``conv1x1_stats`` (wgmma route): as shipped; ``no finish`` (no
  ticket, no sum of the partial rows); ``no y store`` (the TMA stores of y
  left out); and cuBLAS's bf16 ``torch.matmul`` without statistics.
* a one-element ``zero_``: the floor of any launch in this harness.

The variants compute wrong statistics (or no y) on purpose and are never
used by the port; each is the shipped source with one exact edit, and the
tool stops if the source no longer holds the text it edits. Prints each
shape's times in microseconds and the sums over one forward's calls (17
B2, 36 B3), with the card's name and power limit.

    python3 tools/stat_kernel_costs.py

Needs CUDA and nvcc; it raises without them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import cuda_build  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import stat_sums as ss  # noqa: E402

# variant name -> (source, [(text in the shipped source, its replacement)])
VARIANTS = {
    "b2 ticket only": ("stat_sums", [(
        """  if ((2 * w) % 4 == 0)
    add_partial_rows<4, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, SS_THREADS);
  else
    add_partial_rows<1, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, SS_THREADS);
""",
        "  if (tid < 2 * w) store(tid, 0.0f);\n")]),
    "b2 no finish": ("stat_sums", [(
        "  // the last block of this channel tile adds the tile's partial rows\n",
        "  return;\n")]),
    "b3 no finish": ("conv1x1_stats", [(
        "if (last_block_of_tile(tickets + tn, visitors, flag, 1, CONSUMERS)) {",
        "if (false) {")]),
    "b3 no y store": ("conv1x1_stats", [(
        "tma_store(&y_map, stage_y", "if (false) tma_store(&y_map, stage_y")]),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc process each, all at once) into
    ``csrc/build/variants/``; the shared headers are copied beside them."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (cuda_build.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {source}.cu no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        src = out_dir / (name.replace(" ", "_") + ".cu")
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / (name.replace(" ", "_") + ".so")))
    return libs


def main() -> int:
    dev = resolve_device("cuda")
    libs = build_variants()
    libs["b2"] = ss._library()
    libs["b3"] = cs._library()
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        if name.startswith("b2"):
            lib.stat_sums_launch.argtypes = [vp, ll, ci, ci, ci, ci, ci, ci, ll, vp, vp, ci,
                                             vp, vp]
        else:
            lib.conv1x1_stats_wgmma_launch.argtypes = [vp, vp, vp] + [ci] * 8 + [vp, vp, ci,
                                                                                 vp, vp]
    print(f"gpu (name, power limit): {chip_smoke.gpu_name_and_power()}", flush=True)
    sms = ss.sm_count(dev.index or 0)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    tickets = torch.zeros(ss.TICKETS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def us(fn) -> float:
        return chip_smoke.time_ms(fn, torch, 20, flush) * 1e3

    tiny = torch.zeros(1, device=dev)
    floor = us(tiny.zero_)
    print(f"floor (one-element zero_): {floor:.2f} us", flush=True)

    def b2(lib, x):
        n, c = x.shape
        plan = ss.stat_sums_plan(n, c, 2, True, sms)
        partial = torch.empty((plan.blocks, 2, plan.cols * plan.v), dtype=torch.float32,
                              device=dev)
        out = torch.empty((2, c), dtype=torch.float32, device=dev)
        err = lib.stat_sums_launch(x.data_ptr(), n, c, 1, 1, plan.cols, plan.row_blocks,
                                   plan.tiles_c, plan.rows_per_block, partial.data_ptr(),
                                   tickets.data_ptr(), tickets.numel(), out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"stat_sums variant: CUDA error {err}")

    def b3(lib, x, w):
        (m, k), n = x.shape, w.shape[0]
        plan = cs.conv1x1_plan(m, k, n, sms)
        y = torch.empty((m, n), dtype=x.dtype, device=dev)
        out = torch.empty((2, n), dtype=torch.float32, device=dev)
        partial = torch.empty((plan.grid, 2, plan.bn), dtype=torch.float32, device=dev)
        err = lib.conv1x1_stats_wgmma_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, plan.bm, plan.bn, plan.stages,
            plan.grid, plan.smem, partial.data_ptr(), tickets.data_ptr(), tickets.numel(),
            out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"conv1x1_stats variant: CUDA error {err}")

    gen = torch.Generator(device=dev).manual_seed(0)
    b2_shapes, b3_shapes = chip_smoke.resnet50_fused_shapes(chip_smoke.BATCH)
    for kernel, shapes, names in (
            ("B2", b2_shapes, ["b2", "b2 ticket only", "b2 no finish"]),
            ("B3", b3_shapes, ["b3", "b3 no finish", "b3 no y store", "cuBLAS"])):
        totals = dict.fromkeys(names + ["floor"], 0.0)
        for shape, count in shapes.items():
            if kernel == "B2":
                x = (torch.randn(*shape, device=dev, generator=gen) * 2 + 1).bfloat16()
                fns = {name: (lambda lib=libs[name]: b2(lib, x)) for name in names}
            else:
                m, k, n = shape
                x = torch.relu(torch.randn(m, k, device=dev, generator=gen)).bfloat16()
                w = (torch.randn(n, k, device=dev, generator=gen) * (2.0 / k) ** 0.5).bfloat16()
                fns = {name: (lambda lib=libs.get(name): b3(lib, x, w)) for name in names[:-1]}
                fns["cuBLAS"] = lambda: torch.matmul(x, w.t())
            times = {name: us(fn) for name, fn in fns.items()}
            times["floor"] = floor
            for name, t in times.items():
                totals[name] += count * t
            print(f"{kernel} {shape} x{count}: " + ", ".join(
                f"{name} {t:.2f}" for name, t in times.items()) + " us", flush=True)
        print(f"{kernel} one forward ({sum(shapes.values())} calls): " + ", ".join(
            f"{name} {t:.1f}" for name, t in totals.items()) + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
