"""BatchNorm statistics in one pass: CUDA kernel, plain version, gradient.

Counterpart of ``multimodal_active_ai_tpu/ops/pallas_bn.py``:
:func:`stat_sums` takes the place of the TPU kernel ``_stat_sums_fwd`` and
its custom VJP ``stat_sums``, :func:`batch_mean_var` of ``batch_mean_var``.
For a row-major ``(N, C)`` array (an NHWC activation with the pixels
flattened) it returns the per-channel ``(Σx, Σx²)`` in float32, accumulated
in float32 whatever the input type (bf16 or float32).

On a CUDA tensor the forward launches the kernel of ``csrc/stat_sums.cu``
(one launch: at most one wave of row blocks, float32 partial sums per
block, and the last block of each channel tile adds the partials in a fixed
order) or raises; on a CPU tensor it runs :func:`stat_sums_plain`. There is
no fallback from the kernel to the plain version. The backward,
``dx = dΣ + 2·x·dΣ²``, is plain torch, as it is plain jnp in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build

THREADS = 1024         # SS_THREADS in csrc/stat_sums.cu
TILE_C = 64            # SS_TILE_C: channels per column tile
BLOCKS_PER_SM = 1      # resident blocks per SM (__launch_bounds__)
TICKETS = 1024         # per-device ticket counters (column tiles per call)


class StatSumsPlan(NamedTuple):
    """Launch plan of the ``stat_sums`` kernel for one ``(N, C)`` input:
    ``cols`` 16-byte vectors (``vec``) or channels side by side in a block
    of 1024 threads, ``1024 // cols`` row slots, ``tiles_c`` channel tiles
    (``blockIdx.y``) and ``row_blocks`` runs of ``rows_per_block`` rows
    (``blockIdx.x``); one partial row of ``2·cols·V`` floats per block."""

    vec: bool
    v: int
    cols: int
    tiles_c: int
    row_blocks: int
    rows_per_block: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.tiles_c


def stat_sums_plan(n: int, c: int, element_size: int, vec: bool, sms: int, *,
                   threads: int = THREADS, blocks_per_sm: int = BLOCKS_PER_SM) -> StatSumsPlan:
    """The grid for ``n`` rows of ``c`` channels: at most one wave
    (``sms × blocks_per_sm`` blocks of ``threads``), each row run at least
    one pass of the block's row slots, no block empty. ``cols`` is a power
    of two, so the lanes of a warp that share channels are a shuffle
    pattern. Pure Python, so CPU tests hold it; ``ops/bn_act.py`` plans its
    kernels with it at other ``threads`` and ``blocks_per_sm``."""
    v = 16 // element_size if vec else 1
    vcols = c // v
    cols = 1 << (min(vcols, TILE_C // v).bit_length() - 1)   # a power of two
    slots = threads // cols
    tiles_c = -(-vcols // cols)
    row_blocks = max(1, min(blocks_per_sm * sms // tiles_c, -(-n // slots)))
    rows_per_block = -(-n // (row_blocks * slots)) * slots
    row_blocks = -(-n // rows_per_block)
    return StatSumsPlan(vec, v, cols, tiles_c, row_blocks, rows_per_block)


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
    vec = c % (16 // x2d.element_size()) == 0 and x2d.data_ptr() % 16 == 0
    plan = stat_sums_plan(n, c, x2d.element_size(), vec, sm_count(dev.index))
    partial = torch.empty((plan.blocks, 2, plan.cols * plan.v), dtype=torch.float32,
                          device=dev)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    tickets = ticket_counters("stat_sums", dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stat_sums_launch(x2d.data_ptr(), n, c, int(x2d.dtype == torch.bfloat16),
                                   int(vec), plan.cols, plan.row_blocks, plan.tiles_c,
                                   plan.rows_per_block, partial.data_ptr(),
                                   tickets.data_ptr(), tickets.numel(), out.data_ptr(),
                                   stream)
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
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def ticket_counters(kernel: str, device: torch.device) -> torch.Tensor:
    """``TICKETS`` zeroed int32 counters on ``device`` for ``kernel``'s
    last-block finish, allocated once; each launch leaves them 0 again."""
    return torch.zeros(TICKETS, dtype=torch.int32, device=device)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("stat_sums")
    fn = lib.stat_sums_launch
    if not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [vp, ll, ci, ci, ci, ci, ci, ci, ll, vp, vp, ci, vp, vp]
        fn.restype = ci
    return lib
