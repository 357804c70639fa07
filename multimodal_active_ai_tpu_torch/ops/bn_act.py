"""BatchNorm's training step fused with the residual add and ReLU: CUDA
kernels, plain versions, gradient.

:func:`batch_norm_act` is ``relu?(bn(x) [+ identity])`` for a train-mode
flax-semantics BatchNorm (``models/norm.BatchNorm``): float32 batch
statistics with the one-pass variance ``max(E[x²] − E[x]², 0)``, the running
update ``r ← m·r + (1 − m)·batch`` with the biased variance, and
``(x − mean)·rsqrt(var + ε)·weight + bias`` in float32, then the optional
residual add and ReLU in float32, stored once in ``x``'s type. It replaces
no TPU kernel: on the TPU XLA fuses flax BatchNorm's chain; these kernels
are the port's counterpart of that fusion.

The forward launches two kernels of ``csrc/bn_act.cu`` over the
channels-last ``(rows, C)`` view: ``bn_act_sums`` (the per-channel ``Σx``,
``Σx²`` and the row count in one read of ``x``, one contiguous ``(2C + 1,)``
float32 buffer) and ``bn_act_apply`` (mean, ``rsqrt``, the clamp flag and
the running update finished from that buffer in its prologue, then one
elementwise pass). The backward launches two more: ``bn_act_grad_sums``
(``db = Σ gy``, ``dw = Σ gy·x̂`` with ``gy`` the gradient masked by ``y >
0``) and ``bn_act_grad_apply`` (``dx``, dividing by the buffer's count,
and, with a residual, ``d identity = gy``). With ``sync`` (``models/
norm.SyncBatchNorm`` at world > 1) the statistics are every rank's rows':
one in-place all-reduce of the sums buffer between the forward's kernels
(``parallel/collectives.all_reduce_sum_``), so its count is every rank's
rows, and one of a copy of ``(dw, db)`` between the backward's, so each
rank's ``dx`` carries every rank's cotangent of the global statistics; the
weight and bias gradients stay this rank's, as autograd of the chain gives
them. Saved for the backward: ``x`` in its own type, the ``(3, C)`` float32
``mean``, ``rsqrt`` and clamp flag, the sums buffer (for its count), and
``y`` when ReLU is on (the next convolution's saved input, so no new
storage). It takes CUDA tensors alone (``models/norm.conv_norm_act`` runs
the unfused chain everywhere else). The plain versions repeat the kernels'
arithmetic in plain torch, for the tests and ``chip_smoke.py``. Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_active_ai_tpu_torch.ops import cuda_build
from multimodal_active_ai_tpu_torch.ops.stat_sums import (StatSumsPlan, sm_count,
                                                           stat_sums_plan, ticket_counters)
from multimodal_active_ai_tpu_torch.parallel.collectives import all_reduce_sum_

THREADS = 512          # BN_THREADS in csrc/bn_act.cu
BLOCKS_PER_SM = 2      # grid: at most two blocks of 512 threads per SM
TILE_C = 64            # BN_TILE_C: channels per column tile


def bn_act_plan(n: int, c: int, element_size: int, vec: bool, sms: int) -> StatSumsPlan:
    """The grid of all four kernels for ``n`` rows of ``c`` channels: the
    ``stat_sums`` plan at 512 threads a block and two blocks an SM."""
    return stat_sums_plan(n, c, element_size, vec, sms, threads=THREADS,
                          blocks_per_sm=BLOCKS_PER_SM)


# ---------------------------------------------------------------- plain versions

def _dims(x: torch.Tensor) -> list[int]:
    return [0] + list(range(2, x.dim()))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def mean_raw_var(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 ``E[x]`` and ``E[x²] − E[x]²`` (before the clamp at 0) over
    all but the channel dim 1: ``BatchNorm``'s batch statistics."""
    xf = x.to(torch.float32)
    dims = _dims(x)
    mean = xf.mean(dim=dims)
    return mean, (xf * xf).mean(dim=dims) - mean * mean


def bn_act_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """``(2C + 1,)`` float32 ``Σx``, ``Σx²`` over all but the channel dim 1,
    then the row count."""
    xf = x.to(torch.float32)
    dims = _dims(x)
    count = torch.full((1,), float(x.numel() // x.shape[1]), device=x.device)
    return torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])


def stats_from_sums_plain(sums: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(3, C)`` ``mean``, ``rsqrt(var + ε)``, clamp flag (1 where ``E[x²]
    − E[x]²`` fell below 0) and the clamped ``var`` from the ``(2C + 1,)``
    sums of :func:`bn_act_sums_plain`."""
    c = (sums.shape[0] - 1) // 2
    count = sums[2 * c]
    mean = sums[:c] / count
    raw = sums[c:2 * c] / count - mean * mean
    var = torch.clamp_min(raw, 0.0)
    return torch.stack([mean, torch.rsqrt(var + eps), (raw < 0).to(torch.float32)]), var


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   num_batches_tracked: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   momentum: float) -> None:
    """``r ← momentum·r + (1 − momentum)·batch`` for the batch's ``mean`` and
    biased ``var``; one more batch tracked."""
    running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
    running_var.mul_(momentum).add_(var, alpha=1 - momentum)
    num_batches_tracked.add_(1)


def normalize_act_plain(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, identity: torch.Tensor | None = None,
                        relu: bool = True) -> torch.Tensor:
    """``relu?((x − mean)·(rstd·w) + b [+ identity])`` in float32, cast to
    ``x``'s type; channels on dim 1: the apply pass from ``(3, C)``
    statistics."""
    mul = stats[1] * weight
    y = (x.to(torch.float32) - _per_channel(stats[0], x)) * _per_channel(mul, x) \
        + _per_channel(bias, x)
    if identity is not None:
        y = y + identity.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bn_act_apply_plain(x: torch.Tensor, sums: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                       num_batches_tracked: torch.Tensor, momentum: float, eps: float,
                       identity: torch.Tensor | None = None,
                       relu: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, stats)``: the statistics finished from the ``(2C + 1,)``
    ``sums`` (:func:`stats_from_sums_plain`), the running update, then
    :func:`normalize_act_plain`."""
    stats, var = stats_from_sums_plain(sums, eps)
    update_running(running_mean, running_var, num_batches_tracked, stats[0], var, momentum)
    return normalize_act_plain(x, stats, weight, bias, identity, relu), stats


def _masked(g: torch.Tensor, y: torch.Tensor | None) -> torch.Tensor:
    """``g`` in float32, 0 where ``y <= 0`` (``y`` None: no ReLU)."""
    gf = g.to(torch.float32)
    return gf if y is None else torch.where(y <= 0, 0.0, gf)


def bn_act_grad_sums_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None,
                           stats: torch.Tensor,
                           copy: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``dw = rstd·Σ gy·(x − mean)`` and ``db = Σ gy`` over all but the
    channel dim 1, ``gy`` the output gradient ``g`` masked where ``y <= 0``
    (``y`` None: no ReLU); written into the ``(2, C)`` ``copy`` too when
    given."""
    gf = _masked(g, y)
    dims = _dims(x)
    xc = x.to(torch.float32) - _per_channel(stats[0], x)
    dw, db = (gf * xc).sum(dims) * stats[1], gf.sum(dims)
    if copy is not None:
        copy[0], copy[1] = dw, db
    return dw, db


def bn_act_grad_apply_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None,
                            stats: torch.Tensor, weight: torch.Tensor, dw: torch.Tensor,
                            db: torch.Tensor,
                            count: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, gy)`` in ``x``'s type: ``dx = k·gy − k·db/n − k·rstd·dw/n·(x −
    mean)`` with ``k = rstd·w``, ``n`` the rows ``dw`` and ``db`` sum over
    (``count``, a one-element float32 tensor; ``x``'s rows when None) and
    the last term 0 where the variance was clamped; ``gy``, the residual's
    gradient, as in :func:`bn_act_grad_sums_plain`."""
    gf = _masked(g, y)
    n = float(x.numel() // x.shape[1]) if count is None else count
    mean, rstd, clamped = stats
    k = rstd * weight
    c0 = k * (db / n)
    c1 = torch.where(clamped != 0, 0.0, k * rstd * (dw / n))
    xc = x.to(torch.float32) - _per_channel(mean, x)
    dx = _per_channel(k, x) * gf - _per_channel(c0, x) - _per_channel(c1, x) * xc
    return dx.to(x.dtype), gf.to(g.dtype)


def bn_act_grad_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None,
                      stats: torch.Tensor, weight: torch.Tensor):
    """The backward of :func:`normalize_act_plain` through the batch
    statistics of ``x``'s rows: ``(dx, dw, db, gy)``."""
    dw, db = bn_act_grad_sums_plain(g, x, y, stats)
    dx, gy = bn_act_grad_apply_plain(g, x, y, stats, weight, dw, db)
    return dx, dw, db, gy


# ---------------------------------------------------------------- CUDA kernels

def _rows(t: torch.Tensor) -> torch.Tensor:
    """The contiguous ``(rows, C)`` channels-last view of a channel-dim-1
    tensor: free for ``channels_last`` memory, a copy otherwise."""
    t = t.movedim(1, -1)
    return t.reshape(-1, t.shape[-1]).contiguous()


def _unrows(t2d: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``t2d`` as the channel-dim-1 view of channels-last memory of
    ``shape`` (the channels last)."""
    return t2d.view(shape).movedim(-1, 1)


def _launch_args(x2d: torch.Tensor, *more: torch.Tensor | None):
    """``(n, c, is_bf16, vec, plan)`` for ``x2d`` and the other ``(n, c)``
    tensors of a launch, checked."""
    if not x2d.is_cuda:
        raise ValueError(f"bn_act: unsupported device {x2d.device}")
    dtype = x2d.dtype
    if dtype is not torch.bfloat16 and dtype is not torch.float32:
        raise TypeError(f"bn_act: x is {dtype}, expected bfloat16 or float32")
    n, c = x2d.shape
    if n < 1 or c < 1:
        raise ValueError(f"bn_act: empty input {tuple(x2d.shape)}")
    es = x2d.element_size()
    vec = c % (16 // es) == 0 and x2d.data_ptr() % 16 == 0
    for t in more:
        if t is None:
            continue
        if t.shape != x2d.shape or t.dtype is not dtype or not t.is_contiguous() \
                or t.get_device() != x2d.get_device():
            raise ValueError(f"bn_act: a {t.dtype} {tuple(t.shape)} tensor with strides "
                             f"{t.stride()} on {t.device} beside x {dtype} {tuple(x2d.shape)}")
        vec = vec and t.data_ptr() % 16 == 0
    if not x2d.is_contiguous():
        raise ValueError(f"bn_act: x must be contiguous, has strides {x2d.stride()}")
    return n, c, int(dtype is torch.bfloat16), int(vec), _plan(n, c, es, vec, x2d.get_device())


@functools.lru_cache(maxsize=None)
def _plan(n: int, c: int, element_size: int, vec: bool, device_index: int) -> StatSumsPlan:
    return bn_act_plan(n, c, element_size, vec, sm_count(device_index))


def _check_channels(x2d: torch.Tensor, stats: torch.Tensor | None, *vecs: torch.Tensor) -> None:
    c, device = x2d.shape[1], x2d.get_device()
    if stats is not None and (stats.dtype is not torch.float32 or stats.shape != (3, c)
                              or not stats.is_contiguous() or stats.get_device() != device):
        raise ValueError(f"bn_act: stats must be contiguous float32 (3, {c}) on {x2d.device}")
    for v in vecs:
        if v.dtype is not torch.float32 or v.shape != (c,) or not v.is_contiguous() \
                or v.get_device() != device:
            raise ValueError(f"bn_act: per-channel tensors must be contiguous float32 ({c},) "
                             f"on {x2d.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


@functools.lru_cache(maxsize=None)
def _partial(kernel: str, device_index: int, plan: StatSumsPlan) -> torch.Tensor:
    """Scratch for the partial rows of ``kernel``'s launches with ``plan``,
    allocated once: launches on one stream run in order, and each reads
    only the rows it wrote (the ticket counters assume one stream too)."""
    return torch.empty((plan.blocks, 2, plan.cols * plan.v), dtype=torch.float32,
                       device=torch.device("cuda", device_index))


def _launch(fn, kernel: str, device_index: int, *args) -> None:
    """``fn(*args, stream)`` on the current stream of card ``device_index``,
    that card current during the call; raises if the launch failed."""
    if torch.cuda.current_device() != device_index:
        with torch.cuda.device(device_index):
            return _launch(fn, kernel, device_index, *args)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _check_sums(x2d: torch.Tensor, sums: torch.Tensor) -> None:
    c = x2d.shape[1]
    if sums.dtype is not torch.float32 or sums.shape != (2 * c + 1,) \
            or not sums.is_contiguous() or sums.get_device() != x2d.get_device():
        raise ValueError(f"bn_act: sums must be contiguous float32 ({2 * c + 1},) on {x2d.device}")


def bn_act_sums(x2d: torch.Tensor) -> torch.Tensor:
    """:func:`bn_act_sums_plain` of a contiguous ``(rows, C)`` CUDA tensor:
    the ``(2C + 1,)`` float32 ``Σx``, ``Σx²`` and row count in one launch
    (``bn_act_sums.launches`` += 1)."""
    n, c, bf16, vec, plan = _launch_args(x2d)
    dev = x2d.get_device()
    sums = torch.empty((2 * c + 1,), dtype=torch.float32, device=x2d.device)
    tickets = ticket_counters("bn_act_sums", x2d.device)
    _launch(_library().bn_act_sums_launch, "bn_act_sums", dev,
            x2d.data_ptr(), n, c, bf16, vec, plan.cols, plan.row_blocks, plan.tiles_c,
            plan.rows_per_block, _partial("bn_act_sums", dev, plan).data_ptr(),
            tickets.data_ptr(), tickets.numel(), sums.data_ptr())
    bn_act_sums.launches += 1
    return sums


def bn_act_apply(x2d: torch.Tensor, sums: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor,
                 num_batches_tracked: torch.Tensor, momentum: float, eps: float,
                 identity2d: torch.Tensor | None = None,
                 relu: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bn_act_apply_plain` on contiguous ``(rows, C)`` CUDA tensors,
    ``sums`` the ``(2C + 1,)`` buffer of :func:`bn_act_sums` (or its sum
    over ranks): ``(y, stats)`` in one launch (``bn_act_apply.launches`` +=
    1)."""
    n, c, bf16, vec, plan = _launch_args(x2d, identity2d)
    _check_channels(x2d, None, weight, bias, running_mean, running_var)
    _check_sums(x2d, sums)
    dev = x2d.get_device()
    if num_batches_tracked.dtype is not torch.int64 or num_batches_tracked.get_device() != dev:
        raise ValueError("bn_act: num_batches_tracked must be an int64 tensor on the card")
    y = torch.empty_like(x2d)
    stats = torch.empty((3, c), dtype=torch.float32, device=x2d.device)
    _launch(_library().bn_act_apply_launch, "bn_act_apply", dev,
            x2d.data_ptr(), 0 if identity2d is None else identity2d.data_ptr(), y.data_ptr(),
            sums.data_ptr(), weight.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), num_batches_tracked.data_ptr(), n,
            c, bf16, vec, plan.cols, plan.row_blocks, plan.tiles_c, plan.rows_per_block,
            int(relu), momentum, 1 - momentum, eps)
    bn_act_apply.launches += 1
    return y, stats


def bn_act_grad_sums(g2d: torch.Tensor, x2d: torch.Tensor, y2d: torch.Tensor | None,
                     stats: torch.Tensor,
                     copy: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bn_act_grad_sums_plain` on contiguous ``(rows, C)`` CUDA
    tensors, ``copy`` a contiguous ``(2, C)`` float32 tensor or None, one
    launch (``bn_act_grad_sums.launches`` += 1)."""
    n, c, bf16, vec, plan = _launch_args(x2d, g2d, y2d)
    _check_channels(x2d, stats)
    if copy is not None:
        if not copy.is_contiguous():
            raise ValueError(f"bn_act: copy must be contiguous (2, {c})")
        _check_channels(x2d, None, copy[0], copy[1])
    dev = x2d.get_device()
    dwdb = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    tickets = ticket_counters("bn_act_grad_sums", x2d.device)
    _launch(_library().bn_act_grad_sums_launch, "bn_act_grad_sums", dev,
            g2d.data_ptr(), 0 if y2d is None else y2d.data_ptr(), x2d.data_ptr(),
            stats.data_ptr(), n, c, bf16, vec, plan.cols, plan.row_blocks, plan.tiles_c,
            plan.rows_per_block, _partial("bn_act_grad_sums", dev, plan).data_ptr(),
            tickets.data_ptr(), tickets.numel(), dwdb.data_ptr(), dwdb[1].data_ptr(),
            0 if copy is None else copy.data_ptr())
    bn_act_grad_sums.launches += 1
    return dwdb[0], dwdb[1]


def bn_act_grad_apply(g2d: torch.Tensor, x2d: torch.Tensor, y2d: torch.Tensor | None,
                      stats: torch.Tensor, weight: torch.Tensor, dw: torch.Tensor,
                      db: torch.Tensor, sums: torch.Tensor, want_dx: bool = True,
                      want_identity: bool = False):
    """:func:`bn_act_grad_apply_plain` on contiguous ``(rows, C)`` CUDA
    tensors, ``dw`` and ``db`` summed over the rows that the forward's
    ``(2C + 1,)`` ``sums`` counts, each output None unless wanted, one
    launch (``bn_act_grad_apply.launches`` += 1)."""
    n, c, bf16, vec, plan = _launch_args(x2d, g2d, y2d)
    _check_channels(x2d, stats, weight, dw, db)
    _check_sums(x2d, sums)
    dx = torch.empty_like(x2d) if want_dx else None
    gy = torch.empty_like(x2d) if want_identity else None
    _launch(_library().bn_act_grad_apply_launch, "bn_act_grad_apply", x2d.get_device(),
            g2d.data_ptr(), 0 if y2d is None else y2d.data_ptr(), x2d.data_ptr(),
            stats.data_ptr(), weight.data_ptr(), dw.data_ptr(), db.data_ptr(),
            sums[2 * c:].data_ptr(), 0 if dx is None else dx.data_ptr(),
            0 if gy is None else gy.data_ptr(), n, c, bf16, vec, plan.cols, plan.row_blocks,
            plan.tiles_c, plan.rows_per_block)
    bn_act_grad_apply.launches += 1
    return dx, gy


bn_act_sums.launches = 0
bn_act_apply.launches = 0
bn_act_grad_sums.launches = 0
bn_act_grad_apply.launches = 0


# ---------------------------------------------------------------- the Function

class _BatchNormAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, identity, running_mean, running_var, num_batches_tracked,
                momentum, eps, relu, sync):
        shape = (x.shape[0], *x.shape[2:], x.shape[1])          # channels last
        x2d = _rows(x)
        id2d = None if identity is None else _rows(identity)
        sums = bn_act_sums(x2d)
        if sync:
            all_reduce_sum_(sums)
        y2d, stats = bn_act_apply(x2d, sums, weight, bias, running_mean, running_var,
                                  num_batches_tracked, momentum, eps, id2d, relu)
        ctx.save_for_backward(x2d, y2d if relu else None, stats, weight, sums)
        ctx.channels_last_shape, ctx.sync = shape, sync
        return _unrows(y2d, shape)

    @staticmethod
    def backward(ctx, g):
        x, y, stats, weight, sums = ctx.saved_tensors
        want_dx, _, _, want_id = ctx.needs_input_grad[:4]
        shape = ctx.channels_last_shape
        g2d = _rows(g)
        total = torch.empty((2, x.shape[1]), dtype=torch.float32, device=x.device) \
            if ctx.sync else None
        dw, db = bn_act_grad_sums(g2d, x, y, stats, total)
        if ctx.sync:
            all_reduce_sum_(total)             # on every rank, whatever its rank needs
        dx = gy = None
        if want_dx or want_id:
            dwt, dbt = (dw, db) if total is None else (total[0], total[1])
            dx, gy = bn_act_grad_apply(g2d, x, y, stats, weight, dwt, dbt, sums, want_dx,
                                       want_id)
        dx = None if dx is None else _unrows(dx, shape)
        gy = None if gy is None else _unrows(gy, shape)
        return (dx, dw, db, gy) + (None,) * 7


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   num_batches_tracked: torch.Tensor, momentum: float, eps: float,
                   identity: torch.Tensor | None = None, relu: bool = True,
                   sync: bool = False) -> torch.Tensor:
    """Differentiable ``relu?(BatchNorm(x) [+ identity])`` in training mode,
    channels on dim 1 (NCHW, on CUDA the NCHW view of ``channels_last``
    memory): the batch's float32 statistics, the running buffers updated
    in place (``r ← momentum·r + (1 − momentum)·batch``, one more batch
    tracked), the output in ``x``'s type. ``identity`` has ``x``'s shape and
    type. ``sync``: the batch is every rank's rows, each rank calling this
    in the same order (one in-place all-reduce forward and one backward);
    the weight and bias gradients are this rank's. CUDA tensors only: the
    kernels."""
    if identity is not None and (identity.shape != x.shape or identity.dtype != x.dtype):
        raise ValueError(f"bn_act: identity {identity.dtype} {tuple(identity.shape)} beside x "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"bn_act: unsupported device {x.device}; the kernels run on CUDA only")
    return _BatchNormAct.apply(x, weight, bias, identity, running_mean, running_var,
                               num_batches_tracked, momentum, eps, relu, sync)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("bn_act")
    if not lib.bn_act_sums_launch.argtypes:
        vp, ci, ll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        plan = [ci, ci, ci, ll]       # cols, row_blocks, tiles_c, rows_per_block
        signatures = {
            "bn_act_sums_launch": [vp, ll, ci, ci, ci, *plan, vp, vp, ci, vp, vp],
            "bn_act_apply_launch": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, *plan,
                                    ci, cf, cf, cf, vp],
            "bn_act_grad_sums_launch": [vp, vp, vp, vp, ll, ci, ci, ci, *plan, vp, vp, ci, vp, vp,
                                        vp, vp],
            "bn_act_grad_apply_launch": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci,
                                         *plan, vp],
        }
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ci
    return lib
