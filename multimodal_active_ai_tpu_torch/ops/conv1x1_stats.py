"""1×1 convolution with its BatchNorm statistics: CUDA kernel, plain version,
gram form and the shared gradient.

Counterpart of ``multimodal_active_ai_tpu/ops/pallas_conv_bn.py``. One
contract, ``(y, Σy, Σy²) = f(x2d, w)``, with ``x2d`` the ``(M, K)`` NHWC
activation flattened to pixels × channels and ``w`` the conv's own weight as
an ``(N, K)`` matrix (``conv.weight.view(N, K)``: the port keeps torch's
layout, so ``y = x2d @ wᵀ``; the JAX package's ``w`` is its transpose).
``y`` comes back in ``x2d``'s type; the statistics are float32 sums over
the M axis of the exact float32 product, taken before ``y`` is rounded.

* :func:`conv1x1_stats` takes the place of the TPU kernel
  ``_conv1x1_stats_fwd`` and its custom VJP ``conv1x1_stats``. On a CUDA
  tensor its forward launches one kernel of ``csrc/conv1x1_stats.cu`` or
  raises; on a CPU tensor it runs :func:`conv1x1_stats_plain`. No fallback
  from kernel to plain. The route follows from the shape and alignment
  alone (:func:`conv1x1_plan`): ``wgmma`` (persistent TMA + wgmma tiles,
  statistics from the accumulator registers, one launch) for bf16 operands
  TMA can address, which every main-path shape is; ``wmma`` for other bf16
  shapes (K or N not a multiple of 8, bases not 16-byte aligned, more N
  tiles than SMs); ``fma`` for float32.
* :func:`gram_stats` is plain torch, as the JAX package's ``gram_stats`` is
  plain jnp: ``Σy = colsum(x)·wᵀ`` and ``Σy² = diag(w (xᵀx) wᵀ)``.

Both share one backward (``_stats_bwd_matmuls``, ``pallas_conv_bn.py:89-99``):
``dyt = (dy + dΣy + 2·y·dΣy²)`` in x's type, with the rounded ``y``, then
``dx = dyt @ w`` and ``dw = dytᵀ @ x`` as plain matmuls.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build
from multimodal_active_ai_tpu_torch.ops.stat_sums import sm_count, ticket_counters

# the wgmma route's shared memory (hop::smem_bytes in csrc/conv1x1_stats.cu)
SLICE_ROW_BYTES = 128            # one 64-wide bf16 K slice of a row
MAX_STAGES = 8
BLOCK_SMEM = 232448              # a block's most dynamic shared memory (227 KB)
SM_SMEM = 233472                 # an SM's, shared by its blocks
CTA_RESERVED = 1024              # the driver's own shared memory per block
WMMA_TILE = 128                  # row tile of the wmma route (BM there)
FMA_TILE = 64                    # row tile of the fma route


class Conv1x1Plan(NamedTuple):
    """How one ``(M, K, N)`` product is launched. ``route`` is ``wgmma``,
    ``wmma`` or ``fma``; the rest describes the wgmma route: ``bm × bn``
    output tiles (``tiles`` of them, ``tiles_n`` along N) walked by
    ``grid`` persistent CTAs (``ctas_per_sm`` on an SM; CTA ``c`` takes
    the tiles ``schedule(c)`` of one N tile), a ring of ``stages`` K
    slices, ``smem`` bytes of dynamic shared memory. For wmma/fma ``bm`` is
    the row tile and ``grid`` the number of CTAs."""

    route: str
    bm: int
    bn: int
    stages: int
    grid: int
    smem: int
    tiles: int
    tiles_n: int
    ctas_per_sm: int

    @property
    def partial_rows(self) -> int:
        """Rows of the float32 partial sums the launch needs."""
        return self.grid if self.route == "wgmma" else -(-self.tiles // self.tiles_n)

    def first_cta(self, tn: int) -> int:
        """The first of the wgmma CTAs that work in N tile ``tn``
        (``hop::first_cta``); they run up to ``first_cta(tn + 1)``."""
        return tn * self.grid // self.tiles_n

    def schedule(self, c: int) -> tuple[int, range]:
        """Wgmma CTA ``c``'s N tile and its run of M tiles, as the kernel
        computes them."""
        tn = ((c + 1) * self.tiles_n - 1) // self.grid
        first = self.first_cta(tn)
        visitors = self.first_cta(tn + 1) - first
        tiles_m = self.tiles // self.tiles_n
        return tn, range((c - first) * tiles_m // visitors, (c - first + 1) * tiles_m // visitors)


def wgmma_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one wgmma CTA (``hop::smem_bytes``)."""
    red_floats = max(bm // 16 * 2 * bn, 8 * bm)
    return (1024 + stages * (bm + bn) * SLICE_ROW_BYTES + 2 * bm * bn * 2 + red_floats * 4
            + 2 * stages * 8 + 16)


def conv1x1_plan(m: int, k: int, n: int, sms: int, bf16: bool = True,
                 aligned: bool = True) -> Conv1x1Plan:
    """The launch plan of ``y = x·wᵀ`` for ``x (m, k)``, ``w (n, k)`` on a
    card with ``sms`` SMs; pure Python, so CPU tests hold it.

    bf16 operands with ``k`` and ``n`` multiples of 8 and 16-byte aligned
    bases (``aligned``), and at most one 128-column N tile per SM, take
    the wgmma route: BN is 64 for ``n <= 64``,
    else 128 (a consumer thread holds ``BN/2`` accumulators; 256 would
    leave too few registers for two CTAs an SM); BM is 128, or 64 where 128-row tiles
    would leave SMs without a tile, and BN drops to 64 where that is still
    too few. The ring takes the most stages that fit: one CTA an SM for
    BM = 128, two for BM = 64."""
    if not bf16:
        tiles_n = -(-n // FMA_TILE)
        tiles = -(-m // FMA_TILE) * tiles_n
        return Conv1x1Plan("fma", FMA_TILE, FMA_TILE, 0, tiles, 0, tiles, tiles_n, 0)
    if k % 8 or n % 8 or not aligned or -(-n // 128) > sms:
        tiles_n = -(-n // WMMA_TILE)
        tiles = -(-m // WMMA_TILE) * tiles_n
        return Conv1x1Plan("wmma", WMMA_TILE, WMMA_TILE, 0, tiles, 0, tiles, tiles_n, 0)

    def tiles_of(bm, bn):
        return -(-m // bm) * -(-n // bn)

    bn = 64 if n <= 64 else 128
    bm = 128
    if tiles_of(bm, bn) < sms:
        bm = 64
    if tiles_of(bm, bn) < sms and bn > 64:
        bn = 64
    ctas_per_sm = 1 if bm == 128 else 2
    while True:
        budget = min(BLOCK_SMEM, SM_SMEM // ctas_per_sm - CTA_RESERVED)
        stages = next((s for s in range(MAX_STAGES, 2, -1)
                       if wgmma_smem_bytes(bm, bn, s) <= budget),
                      None)
        if stages is not None or ctas_per_sm == 1:
            break
        ctas_per_sm = 1
    if stages is None:
        raise ValueError(f"conv1x1_plan: no ring fits for {(m, k, n)}")
    tiles = tiles_of(bm, bn)
    return Conv1x1Plan("wgmma", bm, bn, stages, min(tiles, sms * ctas_per_sm),
                       wgmma_smem_bytes(bm, bn, stages), tiles, -(-n // bn), ctas_per_sm)


def conv1x1_stats_plain(x2d: torch.Tensor, w: torch.Tensor):
    """``(y, Σy, Σy²)`` in plain PyTorch: ``y32 = x·wᵀ`` in float32, the
    statistics from ``y32``, then ``y = y32`` cast to ``x2d``'s type."""
    y32 = x2d.to(torch.float32) @ w.to(torch.float32).t()
    return y32.to(x2d.dtype), y32.sum(0), (y32 * y32).sum(0)


def _conv1x1_stats_cuda(x2d: torch.Tensor, w: torch.Tensor):
    """Launch the kernel; ``conv1x1_stats.launches`` counts the launches."""
    if x2d.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x2d.dtype:
        raise TypeError(f"conv1x1_stats: x {x2d.dtype} and w {w.dtype} must both be "
                        "bfloat16 or both float32")
    if x2d.dim() != 2 or w.dim() != 2 or x2d.shape[1] != w.shape[1]:
        raise ValueError(f"conv1x1_stats: x (M, K) and w (N, K) expected, got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if w.device != x2d.device:
        raise ValueError(f"conv1x1_stats: w on {w.device}, x on {x2d.device}")
    if not (x2d.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv1x1_stats: x and w must be contiguous")
    m, k = x2d.shape
    n = w.shape[0]
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"conv1x1_stats: empty operand {(m, k, n)}")
    dev = x2d.device
    bf16 = x2d.dtype == torch.bfloat16
    aligned = x2d.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = conv1x1_plan(m, k, n, sm_count(dev.index), bf16, aligned)
    y = torch.empty((m, n), dtype=x2d.dtype, device=dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    tickets = ticket_counters("conv1x1_stats", dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.route == "wgmma":
            partial = torch.empty((plan.grid, 2, plan.bn), dtype=torch.float32, device=dev)
            err = lib.conv1x1_stats_wgmma_launch(
                x2d.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, plan.bm, plan.bn,
                plan.stages, plan.grid, plan.smem, partial.data_ptr(),
                tickets.data_ptr(), tickets.numel(), out.data_ptr(), stream)
        else:
            partial = torch.empty((plan.partial_rows, 2, n), dtype=torch.float32, device=dev)
            vec_in = k % 8 == 0 and aligned
            vec_out = n % 8 == 0 and y.data_ptr() % 16 == 0
            err = lib.conv1x1_stats_launch(
                x2d.data_ptr(), w.data_ptr(), m, n, k, int(bf16), int(vec_in), int(vec_out),
                y.data_ptr(), plan.partial_rows, partial.data_ptr(), tickets.data_ptr(),
                tickets.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_stats kernel launch failed ({plan.route} route): "
                           f"CUDA error {err}")
    conv1x1_stats.launches += 1
    return y, out[0], out[1]


def _conv1x1_stats_fwd(x2d, w):
    if x2d.device.type == "cpu":
        return conv1x1_stats_plain(x2d, w)
    if x2d.device.type != "cuda":
        raise ValueError(f"conv1x1_stats: unsupported device {x2d.device}")
    return _conv1x1_stats_cuda(x2d, w)


def _gram_stats_fwd(x2d, w):
    y = x2d @ w.t()
    xf = x2d.to(torch.float32)         # bf16 values, products exact in f32
    wf = w.to(torch.float32)
    s = xf.sum(0) @ wf.t()                               # (N,)
    sq = ((xf.t() @ xf) @ wf.t() * wf.t()).sum(0)        # diag(w G wᵀ), (N,)
    return y, s, sq


class _StatsProduct(torch.autograd.Function):
    """``(y, Σy, Σy²)`` of ``y = x2d @ wᵀ`` with the statistics' cotangents
    folded into the product's backward."""

    @staticmethod
    def forward(ctx, x2d, w, forward_fn):
        y, s, sq = forward_fn(x2d, w)
        ctx.save_for_backward(x2d, w, y)
        return y, s, sq

    @staticmethod
    def backward(ctx, dy, ds, dsq):
        x2d, w, y = ctx.saved_tensors
        with torch.autocast(x2d.device.type, enabled=False):
            dyt = (dy.to(torch.float32) + ds[None, :]
                   + 2.0 * y.to(torch.float32) * dsq[None, :]).to(x2d.dtype)
            dx = dyt @ w.to(x2d.dtype)
            dw = dyt.t() @ x2d
        return dx, dw.to(w.dtype), None


def conv1x1_stats(x2d: torch.Tensor, w: torch.Tensor):
    """Differentiable ``(y, Σy, Σy²)``, ``y = x2d @ wᵀ``: the kernel on CUDA
    (``conv1x1_stats.launches`` += 1), the plain version on the CPU."""
    return _StatsProduct.apply(x2d, w, _conv1x1_stats_fwd)


conv1x1_stats.launches = 0


def gram_stats(x2d: torch.Tensor, w: torch.Tensor):
    """Differentiable ``(y, Σy, Σy²)`` with the statistics from the conv
    input: ``Σy = colsum(x)·wᵀ``, ``Σy² = diag(w (xᵀx) wᵀ)``; plain
    matmuls."""
    return _StatsProduct.apply(x2d, w, _gram_stats_fwd)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("conv1x1_stats")
    fn = lib.conv1x1_stats_launch
    if not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp, ci, vp, vp, ci, vp, vp]
        fn.restype = ci
        lib.conv1x1_stats_wgmma_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                                   ci, vp, vp, ci, vp, vp]
        lib.conv1x1_stats_wgmma_launch.restype = ci
    return lib
