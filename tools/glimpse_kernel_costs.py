#!/usr/bin/env python3
"""What the parts of the glimpse samplers B1 and B4 cost, on one GPU.

Builds, beside the shipped ``csrc/glimpse_sample.cu``, variants that leave
one part out, and times all of them at the main path's plan (B=128, L=4,
P=900; B4 at each of its four levels) the way ``chip_smoke.py`` times
kernels (L2 flushed before every call, host launch gaps hidden):

* as shipped;
* ``no mip reads``: every tap reads the constant 1 instead of the mip;
* ``no store``: the outputs are computed but never written (a store
  guarded by a test no finite value passes keeps the work alive);
* ``32-bit index``: the per-point index arithmetic in 32-bit integers
  (only for a source that still has 64-bit arithmetic there);
* ``no evict-last``: the mip pixels loaded under L2's normal eviction
  policy (only for a source that sets one);
* ``no register cap``: ``__launch_bounds__`` without its minimum of blocks
  an SM, so the compiler picks the registers (same);
* ``scalar route``: the shipped library with the coordinates placed 4 bytes
  off a 16-byte boundary, which sends the wrapper to its scalar route;
* ``2-byte gathers``: the shipped library with the mips placed 2 bytes off
  a 4-byte boundary, which sends the wrapper to its 2-byte tap loads;
* ``floor``: a one-element ``zero_``, the least a launch costs here;
* ``bytes floor``: one elementwise kernel (``torch.neg``) that reads and
  writes as many bytes as the kernel's coordinates and output together (no
  gathers, no arithmetic to speak of; a ``copy_`` would be a DMA memcpy).

Each variant is the shipped source with exact edits, built into
``csrc/build/variants/``; the tool stops if the source no longer holds the
text it edits. It knows the text of two versions of the source, the
earlier per-point kernels and the per-window kernels, and says which one
it found, so that the same file measures a tree that still has the
earlier kernels (copy it into that tree's ``tools/``). The variants
compute wrong values on purpose and are never used by the port. Prints
times in microseconds with the card's name and power limit.

    python3 tools/glimpse_kernel_costs.py

Needs CUDA and nvcc; it raises without them.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import cuda_build, retina  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs  # noqa: E402

NEVER = "0xffffffffu"   # a NaN bit pattern no output takes: a store that never runs

# source version -> (text that identifies it, {variant: [(old, new), ...]})
SOURCES = {
    "per-window (one block a window chunk, four points a thread)": (
        "template <bool VEC, bool PAIRS>", {
            "no mip reads": [
                ("  const uint32_t w0 = load_word(w, pol), w1 = load_word(w + 1, pol);\n"
                 "  const uint32_t w2 = load_word(w + 2, pol), w3 = load_word(w + 2 + odd, pol);",
                 "  const uint32_t w0 = 0x3f803f80u, w1 = w0, w2 = w0, w3 = w0;"),
                ("      v[c] = load_tap(r0 + c, pol);\n"
                 "      v[3 + c] = load_tap(r0 + t.dx + c, pol);\n"
                 "      v[6 + c] = load_tap(r1 + c, pol);\n"
                 "      v[9 + c] = load_tap(r1 + t.dx + c, pol);",
                 "      v[c] = v[3 + c] = v[6 + c] = v[9 + c] = 0x3f80u;")],
            "no store": [
                ("  float* op = out + 3 * bl * points + first;  // out[b, 3l + c, p]\n"
                 "  if (VEC) {",
                 "  float* op = out + 3 * bl * points + first;  // out[b, 3l + c, p]\n"
                 f"  if (__float_as_uint(o[0][0] + o[1][1] + o[2][2] + o[0][3]) == {NEVER})\n"
                 "    op[0] = 0.0f;\n  if (false) {"),
                ("        for (int c = 0; c < 3; ++c) op[c * points + k * step] = o[c][k];",
                 "        for (int c = 0; c < 3; ++c) (void)op;"),
                ("  float* op = out + 3 * bp;  // out[b, p, c]\n  if (VEC) {",
                 "  float* op = out + 3 * bp;  // out[b, p, c]\n"
                 f"  if (__float_as_uint(o[0][0] + o[1][1] + o[2][2] + o[3][0]) == {NEVER})\n"
                 "    op[0] = 0.0f;\n  if (false) {"),
                ("        for (int c = 0; c < 3; ++c) op[3 * k * step + c] = o[k][c];",
                 "        for (int c = 0; c < 3; ++c) (void)op;")],
            "no evict-last": [("createpolicy.fractional.L2::evict_last.b64",
                               "createpolicy.fractional.L2::evict_normal.b64")],
            "no register cap": [("#define GS_MIN_BLOCKS 16 ", "#define GS_MIN_BLOCKS 1 ")],
        }),
    "per-point (one thread a point, 64-bit index)": (
        "const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;", {
            "no mip reads": [
                ("  a0 += w * __bfloat162float(px[0]);\n"
                 "  a1 += w * __bfloat162float(px[1]);\n"
                 "  a2 += w * __bfloat162float(px[2]);\n",
                 "  a0 += w;\n  a1 += w;\n  a2 += w;\n"),
                ("wy0 * __bfloat162float(r0[c])", "wy0"),
                ("wy0 * __bfloat162float(r0[3 + c])", "wy0"),
                ("wy1 * __bfloat162float(r1[c])", "wy1"),
                ("wy1 * __bfloat162float(r1[3 + c])", "wy1")],
            "no store": [
                ("  o[0] = a0 * s;\n  o[points] = a1 * s;\n  o[2 * points] = a2 * s;\n",
                 f"  if (__float_as_uint((a0 + a1 + a2) * s) == {NEVER}) o[0] = 0.0f;\n"),
                ("#pragma unroll\n"
                 "  for (int c = 0; c < 3; ++c) o[c] = (1.0f - fx) * t0[c] + fx * t1[c];\n",
                 "  if (__float_as_uint((1.0f - fx) * (t0[0] + t0[1] + t0[2]) + fx * (t1[0] + "
                 f"t1[1] + t1[2])) == {NEVER}) o[0] = 0.0f;\n")],
            "32-bit index": [
                ("  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
                 "  if (idx >= total) return;\n  // idx enumerates",
                 "  const int idx = blockIdx.x * blockDim.x + threadIdx.x;\n"
                 "  if (idx >= total) return;\n  // idx enumerates"),
                ("  const long long bl = idx / points;", "  const int bl = idx / points;"),
                ("  const long long b = bl / levels;", "  const int b = bl / levels;"),
                ("  const long long row = 3LL * m;\n  const __nv_bfloat16* r0 =\n"
                 "      lv.mip[l] + (b % src_batch) * (long long)m * row + (long long)y0 * row"
                 " + 3LL * x0;",
                 "  const int row = 3 * m;\n  const __nv_bfloat16* r0 =\n"
                 "      lv.mip[l] + (b % src_batch) * m * row + y0 * row + 3 * x0;"),
                ("  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
                 "  if (idx >= total) return;\n  const long long b = idx / points;",
                 "  const int idx = blockIdx.x * blockDim.x + threadIdx.x;\n"
                 "  if (idx >= total) return;\n  const int b = idx / points;"),
                ("  const long long row = 3LL * m;\n  const __nv_bfloat16* r0 =\n"
                 "      mip + b * (long long)m * row + (long long)(sy + (int)y0f) * row"
                 " + 3LL * (int)x0f;",
                 "  const int row = 3 * m;\n  const __nv_bfloat16* r0 =\n"
                 "      mip + b * m * row + (sy + (int)y0f) * row + 3 * (int)x0f;")],
        }),
}


def source_version(text: str) -> str:
    found = [name for name, (marker, _) in SOURCES.items() if marker in text]
    if len(found) != 1:
        raise RuntimeError(f"glimpse_sample.cu matches {len(found)} known versions")
    return found[0]


def build_variants(text: str, variants: dict) -> dict[str, ctypes.CDLL]:
    """Compile every variant (one nvcc process each, all at once) into
    ``csrc/build/variants/``."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, edits in variants.items():
        src_text = text
        for old, new in edits:
            if src_text.count(old) != 1:
                raise RuntimeError(f"{name}: glimpse_sample.cu no longer holds "
                                   f"{old.strip()[:60]!r}")
            src_text = src_text.replace(old, new)
        src = out_dir / ("glimpse_" + name.replace(" ", "_").replace("-", "_") + ".cu")
        src.write_text(src_text)
        procs[name] = (src.with_suffix(".so"), subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def installed(lib: ctypes.CDLL):
    """Let the wrappers launch ``lib``'s kernels for the duration."""
    kept = cuda_build._loaded["glimpse_sample"]
    cuda_build._loaded["glimpse_sample"] = lib
    try:
        yield
    finally:
        cuda_build._loaded["glimpse_sample"] = kept


def off_boundary(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data start one element past a
    16-byte boundary (4 bytes for float32, 2 for bf16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def main() -> int:
    dev = resolve_device("cuda")
    text = (cuda_build.CSRC / "glimpse_sample.cu").read_text()
    version = source_version(text)
    libs = build_variants(text, SOURCES[version][1])
    libs = {"shipped": gs._library(), **libs}
    print(f"gpu (name, power limit): {chip_smoke.gpu_name_and_power()}", flush=True)
    print(f"glimpse_sample.cu: the {version} kernels", flush=True)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_

    def us(fn, lib=None) -> float:
        with installed(lib or libs["shipped"]):
            return chip_smoke.time_ms(fn, torch, 50, flush) * 1e3

    floor = us(torch.zeros(1, device=dev).zero_)
    print(f"floor (one-element zero_): {floor:.2f} us", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    b, canvas = chip_smoke.BATCH, chip_smoke.CANVAS
    images = torch.randint(0, 256, (b, canvas, canvas, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    cfg = retina.RetinaConfig(canvas_size=canvas, grid_mask_prob=1.0)
    params = retina.sample_unlabeled_params(gen, b, canvas, cfg)
    args = retina.sampler_args(retina.build_pyramid(images, cfg), params, cfg)
    mips, rel_y, rel_x, start, scale, wins, msizes = args

    def bytes_floor(nbytes: int):
        src = torch.zeros(nbytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        return lambda: torch.neg(src, out=dst)

    def row(label, fns, bound_us, moved):
        times = {name: us(fn, lib) for name, (fn, lib) in fns.items()}
        times["floor"] = floor
        times["bytes floor"] = us(bytes_floor(moved))
        print(f"{label}: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
              + f" us; bound {bound_us:.2f} us, floor + bytes at 3.35 TB/s "
              f"{floor + bound_us:.2f} us", flush=True)
        return times

    # B1: the variants must agree with each other where they compute the same
    ref = gs.glimpse_sample(*args)
    if "32-bit index" in libs:
        with installed(libs["32-bit index"]):
            same = torch.equal(gs.glimpse_sample(*args), ref)
        print(f"B1 32-bit index: the shipped kernel's bits {same}", flush=True)
    nbytes, _ = chip_smoke.glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins)
    odd = (mips, off_boundary(rel_y), off_boundary(rel_x), start, off_boundary(scale),
           wins, msizes)
    fns = {name: ((lambda: gs.glimpse_sample(*args)), lib) for name, lib in libs.items()}
    fns["scalar route"] = ((lambda: gs.glimpse_sample(*odd)), libs["shipped"])
    taps = ([off_boundary(m) for m in mips], rel_y, rel_x, start, scale, wins, msizes)
    fns["2-byte gathers"] = ((lambda: gs.glimpse_sample(*taps)), libs["shipped"])
    moved = 4 * (rel_y.numel() * 3 + ref.numel())          # coordinates + output
    row(f"B1 (B={b}, L={len(mips)}, P={rel_y.shape[2]})", fns,
        nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e6, moved)

    # B4: one launch per level, summed
    total = {}
    rows_idx = torch.arange(b, device=dev)
    for li, (mip, win) in enumerate(zip(mips, wins)):
        rel = torch.stack([rel_y[:, li], rel_x[:, li]], -1).contiguous()
        st = start[:, li].contiguous()
        a = (mip, rel, st, win)
        odd = (mip, off_boundary(rel), st, win)
        fns = {name: ((lambda a=a: gs.hat_sample(*a)), lib) for name, lib in libs.items()}
        fns["scalar route"] = ((lambda odd=odd: gs.hat_sample(*odd)), libs["shipped"])
        taps = (off_boundary(mip), rel, st, win)
        fns["2-byte gathers"] = ((lambda taps=taps: gs.hat_sample(*taps)), libs["shipped"])
        p = rel.shape[1]
        nb = b * p * (3 + 2) * 4 + st.numel() * 4 + 6 * chip_smoke.touched_pixels(
            torch, mip, rows_idx, rel[..., 0], rel[..., 1], st, win)
        bound_us = nb / chip_smoke.PEAK_BYTES_PER_S * 1e6
        times = row(f"B4 level {li} (M={mip.shape[1]}, win={win}, B={b}, P={p})", fns,
                    bound_us, 4 * b * p * (3 + 2))
        times["bound"] = bound_us
        for k, v in times.items():
            total[k] = total.get(k, 0.0) + v
    print("B4, the four levels: " + ", ".join(f"{k} {v:.2f}" for k, v in total.items())
          + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
