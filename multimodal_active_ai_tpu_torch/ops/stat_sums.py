"""BatchNorm statistics in one pass: CUDA kernel, plain version, gradient.

Counterpart of ``multimodal_active_ai_tpu/ops/pallas_bn.py``:
:func:`stat_sums` takes the place of the TPU kernel ``_stat_sums_fwd`` and
its custom VJP ``stat_sums``, :func:`batch_mean_var` of ``batch_mean_var``.
For a row-major ``(N, C)`` array (an NHWC activation with the pixels
flattened) it returns the per-channel ``(Σx, Σx²)`` in float32, accumulated
in float32 whatever the input type (bf16 or float32).

On a CUDA tensor the forward launches the kernel of ``csrc/stat_sums.cu``
(row blocks spread over the SMs, float32 partial sums per block, then a
second pass that adds the partials in a fixed order) or raises; on a CPU
tensor it runs :func:`stat_sums_plain`. There is no fallback from the kernel
to the plain version. The backward, ``dx = dΣ + 2·x·dΣ²``, is plain torch,
as it is plain jnp in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build

THREADS = 256          # SS_THREADS in csrc/stat_sums.cu
BLOCKS_PER_SM = 4      # row blocks aimed at per SM (several in flight each)


def stat_sums_plain(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σx, Σx²)`` over axis 0 of an ``(N, C)`` tensor, in float32."""
    xf = x2d.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def _stat_sums_cuda(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; ``stat_sums.launches`` counts the launches."""
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"stat_sums: x is {x2d.dtype}, expected bfloat16 or float32")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"stat_sums: x must be a contiguous (N, C) tensor, got "
                         f"shape {tuple(x2d.shape)} strides {x2d.stride()}")
    n, c = x2d.shape
    if n < 1 or c < 1:
        raise ValueError(f"stat_sums: empty input {tuple(x2d.shape)}")
    dev = x2d.device
    per_vec = 16 // x2d.element_size()
    vec = c % per_vec == 0 and x2d.data_ptr() % 16 == 0
    vcols = c // per_vec if vec else c
    cols = min(vcols, THREADS)
    rows_per_iter = THREADS // cols
    tiles_c = -(-vcols // cols)
    sms = _sm_count(dev.index)
    # at least 4 row passes per block, at most ~BLOCKS_PER_SM blocks per SM
    groups = max(1, min(-(-n // (4 * rows_per_iter)),
                        BLOCKS_PER_SM * sms // tiles_c, 65535))
    partial = torch.empty((groups, 2, c), dtype=torch.float32, device=dev)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stat_sums_launch(x2d.data_ptr(), n, c, int(x2d.dtype == torch.bfloat16),
                                   int(vec), cols, rows_per_iter, groups,
                                   partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stat_sums kernel launch failed: CUDA error {err}")
    stat_sums.launches += 1
    return out[0], out[1]


class _StatSums(torch.autograd.Function):
    """``(Σx, Σx²)`` with the JAX package's VJP (``pallas_bn.py:80-84``)."""

    @staticmethod
    def forward(ctx, x2d):
        ctx.save_for_backward(x2d)
        if x2d.device.type == "cpu":
            return stat_sums_plain(x2d)
        if x2d.device.type != "cuda":
            raise ValueError(f"stat_sums: unsupported device {x2d.device}")
        return _stat_sums_cuda(x2d)

    @staticmethod
    def backward(ctx, dsum, dsumsq):
        (x2d,) = ctx.saved_tensors
        dx = dsum[None, :].float() + 2.0 * x2d.float() * dsumsq[None, :].float()
        return dx.to(x2d.dtype)


def stat_sums(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(Σx, Σx²)`` over axis 0 of ``(N, C)``, float32
    accumulation: the kernel on CUDA (``stat_sums.launches`` += 1), the
    plain version on the CPU."""
    return _StatSums.apply(x2d)


stat_sums.launches = 0


def batch_mean_var(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` over all but the last axis of a trailing-channel
    tensor (NHWC or ``(N, C)``), fast-variance form ``max(E[x²] − E[x]², 0)``
    as flax computes it, from one :func:`stat_sums` pass."""
    c = x.shape[-1]
    n = x.numel() // c
    return mean_var_from_sums(*stat_sums(x.reshape(n, c)), n)


def mean_var_from_sums(s: torch.Tensor, sq: torch.Tensor, n: int):
    """``(mean, var)`` of ``n`` rows from their ``(Σx, Σx²)``, the variance
    biased and in the fast form ``max(E[x²] − E[x]², 0)``."""
    mean = s / n
    return mean, torch.clamp_min(sq / n - mean * mean, 0.0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("stat_sums")
    fn = lib.stat_sums_launch
    if not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib
