"""The retina's multi-level glimpse sampler: CUDA kernel and plain version.

Counterpart of ``multimodal_active_ai_tpu/ops/pallas_retina.py``:
:func:`glimpse_sample` takes the place of the TPU kernel ``glimpse_sample``
and :func:`glimpse_sample_plain` follows its XLA version
``glimpse_sample_xla``. For each plan row ``b`` (source image
``b % B_src``, so a view-major ``V·B_src`` plan runs against one pyramid)
and each level ``l``, it samples the channel-interleaved bf16 mip
``(B_src, M_l, 3·M_l)`` by windowed bilinear ("hat") interpolation:
window-relative ``y`` is clamped to ``[0, win-1]``, ``x`` to the window, the
result is multiplied by the per-point ``scale`` (grid-mask keep ×
in-bounds), and it comes back channel-major ``(B, 3L, P)`` float32.

On a CUDA tensor :func:`glimpse_sample` launches the kernel of
``csrc/glimpse_sample.cu`` (one block per chunk of a window, four points a
thread, at most 2×2 bf16 taps read straight from the mip, f32
accumulation, all levels in one launch) or raises; on a CPU tensor it runs
the plain version. There is no fallback from the kernel to the plain
version. The launch plan, :func:`glimpse_sample_plan`, is pure Python and
picks the kernel's routes from the shapes: 16-byte coordinate loads and
output stores where ``P % 4 == 0`` (else 4-byte ones), pixel pairs read as
32-bit words where every mip side is even (else 2-byte taps).

:func:`hat_sample` is the one-level form, the counterpart of the TPU kernel
``hat_sample``: ``(B, P, 2)`` window-relative coordinates in, ``(B, P, 3)``
out, no scale, y weights rounded to bf16 as that kernel rounds them. Its
plain version :func:`hat_sample_plain` follows ``hat_sample_xla``; its
kernel is the second entry point of ``csrc/glimpse_sample.cu``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build

MAX_LEVELS = 8          # GS_MAX_LEVELS in csrc/glimpse_sample.cu
POINTS_PER_THREAD = 4   # GS_K
MAX_THREADS = 64        # GS_MAX_THREADS
MAX_CHUNKS = 65535      # gridDim.z


class SamplerPlan(NamedTuple):
    """Launch plan of B1 or B4 for ``b`` plan rows, ``levels`` levels and
    ``points`` points: a grid of ``(b, levels, chunks)`` blocks of
    ``threads`` threads; block ``(b, l, z)`` samples chunk ``z`` of window
    ``(b, l)``, ``points_per_thread · threads`` points, and each thread
    ``points_per_thread`` of them. Route ``"vec16"`` (``points`` a multiple
    of 4, rows 16-byte aligned): a thread's points are consecutive, read and
    written with 16-byte loads and stores. Route ``"scalar"``: they lie
    ``threads`` apart, so neighbouring threads touch neighbouring words.
    Gathers ``"pairs"`` (every mip side even, mips 4-byte aligned): a tap
    row's two pixels come in as 32-bit words; ``"taps"``: as 2-byte
    loads."""

    route: str
    gather: str
    points: int
    points_per_thread: int
    threads: int
    chunks: int
    grid: tuple[int, int, int]

    def thread_points(self, chunk: int, t: int) -> list[int]:
        """The points thread ``t`` of a chunk-``chunk`` block samples, as
        the kernel enumerates them."""
        k = self.points_per_thread
        first = chunk * k * self.threads
        if self.route == "vec16":
            ps = [first + k * t + i for i in range(k)]
        else:
            ps = [first + t + i * self.threads for i in range(k)]
        return [p for p in ps if p < self.points]


def _plan(b: int, levels: int, p: int, aligned: bool, pairs: bool) -> SamplerPlan:
    if b < 1 or levels < 1 or p < 1:
        raise ValueError(f"glimpse sampler: empty plan (B={b}, L={levels}, P={p})")
    k = POINTS_PER_THREAD
    route = "vec16" if aligned and p % 4 == 0 else "scalar"
    threads = min(MAX_THREADS, -(-p // (32 * k)) * 32)     # whole warps
    chunks = -(-p // (k * threads))
    if chunks > MAX_CHUNKS:
        raise ValueError(f"glimpse sampler: {p} points need {chunks} > {MAX_CHUNKS} chunks")
    return SamplerPlan(route, "pairs" if pairs else "taps", p, k, threads, chunks,
                       (b, levels, chunks))


def glimpse_sample_plan(b: int, levels: int, p: int, aligned: bool = True,
                        pairs: bool = True) -> SamplerPlan:
    """The B1 launch for a ``(B, L, P)`` plan; ``aligned`` says whether
    ``rel_y``, ``rel_x`` and ``scale`` start on a 16-byte boundary,
    ``pairs`` whether every mip has an even side and a 4-byte-aligned
    start. Pure Python, so CPU tests hold it; the kernel checks it."""
    return _plan(b, levels, p, aligned, pairs)


def hat_sample_plan(b: int, p: int, aligned: bool = True, pairs: bool = True) -> SamplerPlan:
    """The B4 launch for ``(B, P, 2)`` coordinates, one level; ``aligned``
    says whether ``rel`` starts on a 16-byte boundary, ``pairs`` as for
    :func:`glimpse_sample_plan`."""
    return _plan(b, 1, p, aligned, pairs)


def glimpse_sample_plain(mips: Sequence[torch.Tensor], rel_y: torch.Tensor,
                         rel_x: torch.Tensor, start: torch.Tensor,
                         scale: torch.Tensor, wins: Sequence[int],
                         msizes: Sequence[int] | None = None) -> torch.Tensor:
    """The sampler in plain PyTorch, step for step as ``glimpse_sample_xla``:
    per level, slice each row's ``win × win`` window (start clamped to
    ``[0, M-win]`` as ``dynamic_slice`` does), contract it with bf16-rounded
    ``y`` hat weights in f32, then with f32 ``x`` hat weights.

    Args:
      mips: per-level ``(B_src, M_l, 3·M_l)`` bf16 mips.
      rel_y, rel_x: ``(B, L, P)`` float32 window-relative coordinates.
      start: ``(B, L, 2)`` int window origins ``(y, x)``.
      scale: ``(B, L, P)`` float32 per-point multipliers.
      wins: per-level window sides.
      msizes: per-level mip sides (checked against the mips when given).

    Returns ``(B, 3L, P)`` float32.
    """
    b, levels, p = rel_y.shape
    _check_geometry(mips, wins, msizes, b, levels)
    rows = torch.arange(b, device=rel_y.device) % mips[0].shape[0]
    outs = [_hat_level(mip, rows, rel_y[:, li], rel_x[:, li], start[:, li], win)
            * scale[:, li, :, None] for li, (mip, win) in enumerate(zip(mips, wins))]
    return torch.cat(outs, -1).transpose(1, 2).contiguous()


def _hat_level(mip: torch.Tensor, rows: torch.Tensor, rel_y: torch.Tensor,
               rel_x: torch.Tensor, start: torch.Tensor, win: int) -> torch.Tensor:
    """One level of the plain sampler: plan row ``b`` reads mip image
    ``rows[b]``; ``rel_y``/``rel_x`` ``(B, P)``, ``start`` ``(B, 2)``.
    Returns ``(B, P, 3)`` float32."""
    b, p = rel_y.shape
    m = mip.shape[1]
    img = mip.view(mip.shape[0], m, m, 3)
    s = start.long().clamp(0, m - win)                            # (B, 2)
    ar = torch.arange(win, device=rel_y.device)
    iy = s[:, 0:1] + ar                                           # (B, win)
    ix = s[:, 1:2] + ar
    patch = img[rows[:, None, None], iy[:, :, None], ix[:, None, :]]
    idx = ar.to(torch.float32)
    ry = rel_y.clamp(0.0, win - 1.0)[..., None]                   # (B, P, 1)
    rx = rel_x.clamp(0.0, win - 1.0)[..., None]
    wy = torch.clamp_min(1.0 - (ry - idx).abs(), 0.0)             # (B, P, win)
    wx = torch.clamp_min(1.0 - (rx - idx).abs(), 0.0)
    wy = wy.to(torch.bfloat16).to(torch.float32)
    tmp = torch.bmm(wy, patch.to(torch.float32).reshape(b, win, win * 3))
    return (tmp.view(b, p, win, 3) * wx[..., None]).sum(2)


def glimpse_sample(mips: Sequence[torch.Tensor], rel_y: torch.Tensor,
                   rel_x: torch.Tensor, start: torch.Tensor,
                   scale: torch.Tensor, wins: Sequence[int],
                   msizes: Sequence[int] | None = None) -> torch.Tensor:
    """Sample all pyramid levels in one call; arguments and result as in
    :func:`glimpse_sample_plain`.

    CUDA tensors launch the hand-written kernel on the current stream, add
    one to ``glimpse_sample.launches`` and leave the launch's plan in
    ``glimpse_sample.plan``; CPU tensors take the plain version. ``start``
    must be int32 and every tensor contiguous on CUDA.
    """
    if rel_y.device.type == "cpu":
        return glimpse_sample_plain(mips, rel_y, rel_x, start, scale, wins,
                                    msizes)
    if rel_y.device.type != "cuda":
        raise ValueError(f"glimpse_sample: unsupported device {rel_y.device}")
    b, levels, p = rel_y.shape
    _check_geometry(mips, wins, msizes, b, levels)
    if levels > MAX_LEVELS:
        raise ValueError(f"glimpse_sample: {levels} levels > {MAX_LEVELS}")
    dev = rel_y.device
    for name, t, dtype, shape in (
            ("rel_y", rel_y, torch.float32, (b, levels, p)),
            ("rel_x", rel_x, torch.float32, (b, levels, p)),
            ("scale", scale, torch.float32, (b, levels, p)),
            ("start", start, torch.int32, (b, levels, 2))):
        _check_tensor(name, t, dtype, shape, dev)
    for li, mip in enumerate(mips):
        _check_tensor(f"mips[{li}]", mip, torch.bfloat16, tuple(mip.shape), dev)

    lib = _library()
    out = torch.empty((b, 3 * levels, p), dtype=torch.float32, device=dev)
    plan = glimpse_sample_plan(b, levels, p, _aligned16(rel_y, rel_x, scale, out),
                               all(_pairs_ok(m) for m in mips))
    ptrs = (ctypes.c_void_p * levels)(*[m.data_ptr() for m in mips])
    msz = (ctypes.c_int * levels)(*[m.shape[1] for m in mips])
    wns = (ctypes.c_int * levels)(*[int(w) for w in wins])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.glimpse_sample_launch(
            ptrs, msz, wns, levels, b, mips[0].shape[0], p,
            int(plan.route == "vec16"), int(plan.gather == "pairs"), plan.threads,
            plan.chunks,
            rel_y.data_ptr(), rel_x.data_ptr(), start.data_ptr(),
            scale.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"glimpse_sample kernel launch failed: CUDA error {err}")
    glimpse_sample.launches += 1
    glimpse_sample.plan = plan
    return out


glimpse_sample.launches = 0
glimpse_sample.plan = None


def hat_sample_plain(mip: torch.Tensor, rel: torch.Tensor, start: torch.Tensor,
                     win: int) -> torch.Tensor:
    """One level in plain PyTorch, step for step as ``hat_sample_xla``.

    Args:
      mip: ``(B, M, 3·M)`` bf16 channel-interleaved mip.
      rel: ``(B, P, 2)`` float32 window-relative ``(y, x)`` coordinates
        (clamped to the window).
      start: ``(B, 2)`` int window origins (clamped to ``[0, M-win]``).
      win: window side.

    Returns ``(B, P, 3)`` float32.
    """
    _check_hat_geometry(mip, rel, start, win)
    rows = torch.arange(mip.shape[0], device=rel.device)
    return _hat_level(mip, rows, rel[..., 0], rel[..., 1], start, win)


def hat_sample(mip: torch.Tensor, rel: torch.Tensor, start: torch.Tensor,
               win: int) -> torch.Tensor:
    """One level; arguments and result as in :func:`hat_sample_plain`.

    CUDA tensors launch the ``hat_sample`` kernel on the current stream, add
    one to ``hat_sample.launches`` and leave the plan in ``hat_sample.plan``;
    CPU tensors take the plain version. On CUDA ``start`` must be int32 and
    every tensor contiguous.
    """
    if rel.device.type == "cpu":
        return hat_sample_plain(mip, rel, start, win)
    if rel.device.type != "cuda":
        raise ValueError(f"hat_sample: unsupported device {rel.device}")
    _check_hat_geometry(mip, rel, start, win)
    b, p, _ = rel.shape
    dev = rel.device
    _check_tensor("rel", rel, torch.float32, (b, p, 2), dev, "hat_sample")
    _check_tensor("start", start, torch.int32, (b, 2), dev, "hat_sample")
    _check_tensor("mip", mip, torch.bfloat16, tuple(mip.shape), dev, "hat_sample")
    lib = _library()
    out = torch.empty((b, p, 3), dtype=torch.float32, device=dev)
    plan = hat_sample_plan(b, p, _aligned16(rel, out), _pairs_ok(mip))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hat_sample_launch(mip.data_ptr(), b, mip.shape[1], int(win), p,
                                    int(plan.route == "vec16"), int(plan.gather == "pairs"),
                                    plan.threads, plan.chunks,
                                    rel.data_ptr(), start.data_ptr(),
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hat_sample kernel launch failed: CUDA error {err}")
    hat_sample.launches += 1
    hat_sample.plan = plan
    return out


hat_sample.launches = 0
hat_sample.plan = None


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("glimpse_sample")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.glimpse_sample_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci),
                       ctypes.POINTER(ci), ci, ci, ci, ci, ci, ci, ci, ci,
                       vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    fn = lib.hat_sample_launch
    if not fn.argtypes:
        fn.argtypes = [vp, ci, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _pairs_ok(mip: torch.Tensor) -> bool:
    """Whether the kernel may read ``mip``'s pixel pairs as 32-bit words."""
    return mip.shape[1] % 2 == 0 and mip.data_ptr() % 4 == 0


def _check_hat_geometry(mip, rel, start, win):
    if mip.dim() != 3 or mip.shape[2] != 3 * mip.shape[1]:
        raise ValueError(f"hat_sample: mip must be (B, M, 3M), got {tuple(mip.shape)}")
    if rel.dim() != 3 or rel.shape[0] != mip.shape[0] or rel.shape[2] != 2:
        raise ValueError(f"hat_sample: rel must be (B, P, 2), got {tuple(rel.shape)}")
    if tuple(start.shape) != (mip.shape[0], 2):
        raise ValueError(f"hat_sample: start must be (B, 2), got {tuple(start.shape)}")
    if not 1 <= win <= mip.shape[1]:
        raise ValueError(f"hat_sample: window {win} outside [1, {mip.shape[1]}]")


def _check_geometry(mips, wins, msizes, b, levels):
    if len(mips) != levels or len(wins) != levels:
        raise ValueError(f"glimpse_sample: {len(mips)} mips and {len(wins)} "
                         f"windows for {levels} levels")
    src_b = mips[0].shape[0]
    if b % src_b != 0:
        raise ValueError(f"plan batch {b} not a multiple of mip batch {src_b}")
    for li, (mip, win) in enumerate(zip(mips, wins)):
        if mip.dim() != 3 or mip.shape[0] != src_b or mip.shape[2] != 3 * mip.shape[1]:
            raise ValueError(f"mips[{li}] must be (B_src, M, 3M), got {tuple(mip.shape)}")
        if msizes is not None and msizes[li] != mip.shape[1]:
            raise ValueError(f"mips[{li}] side {mip.shape[1]} != msizes {msizes[li]}")
        if not 1 <= win <= mip.shape[1]:
            raise ValueError(f"window {win} outside [1, {mip.shape[1]}] at level {li}")


def _check_tensor(name, t, dtype, shape, device, op="glimpse_sample"):
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
