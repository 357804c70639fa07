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
  tensor its forward launches the kernel of ``csrc/conv1x1_stats.cu``
  (tiled tensor-core GEMM for bf16, FMA tiles for float32, statistics from
  the float32 accumulator in the epilogue) or raises; on a CPU tensor it
  runs :func:`conv1x1_stats_plain`. No fallback from kernel to plain.
* :func:`gram_stats` is plain torch, as the JAX package's ``gram_stats`` is
  plain jnp: ``Σy = colsum(x)·wᵀ`` and ``Σy² = diag(w (xᵀx) wᵀ)``.

Both share one backward (``_stats_bwd_matmuls``, ``pallas_conv_bn.py:89-99``):
``dyt = (dy + dΣy + 2·y·dΣy²)`` in x's type, with the rounded ``y``, then
``dx = dyt @ w`` and ``dw = dytᵀ @ x`` as plain matmuls.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build


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
    lib = _library()
    tiles_m = -(-m // lib.conv1x1_stats_tile_m(int(bf16)))
    y = torch.empty((m, n), dtype=x2d.dtype, device=dev)
    partial = torch.empty((tiles_m, 2, n), dtype=torch.float32, device=dev)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    vec_in = k % 8 == 0 and x2d.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    vec_out = n % 8 == 0 and y.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv1x1_stats_launch(x2d.data_ptr(), w.data_ptr(), m, n, k, int(bf16),
                                       int(vec_in), int(vec_out), y.data_ptr(), tiles_m,
                                       partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv1x1_stats kernel launch failed: CUDA error {err}")
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
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp, ci, vp, vp, vp]
        fn.restype = ci
        lib.conv1x1_stats_tile_m.argtypes = [ci]
        lib.conv1x1_stats_tile_m.restype = ci
    return lib
