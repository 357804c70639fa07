"""Cross-rank collectives with the JAX package's gradient semantics.

Port of ``multimodal_active_ai_tpu/parallel/collectives.py`` and of the
reductions GSPMD inserts into the JAX steps. Every function is the identity
(or a detach) without a process group, and runs the collective whenever one
exists, at any world size; every rank must call it in the same order.

* :func:`cross_replica_concat` is torch's ``dist.all_gather``: the remote
  blocks carry no gradient, the local block optionally does.
* :func:`all_gather_with_grad` is the fully differentiable gather (the
  caption loss): its backward sums every rank's cotangent of this rank's
  block, so each remote cotangent is counted once.
* :func:`all_reduce_sum_with_grad` is the differentiable sum (global
  BatchNorm statistics): its backward is the sum of every rank's cotangent.
* :func:`all_reduce_mean` / :func:`all_reduce_sum` reduce values for
  metrics; :func:`all_reduce_sum_` sums a buffer in place (the fused
  ``sync_bn``'s per-channel sums, ``ops/bn_act.py``);
  :func:`average_gradients` is the gradient all-reduce, one coalesced
  buffer a call.

Every collective on the wire goes through one of three functions, each a
span of its own under a profiler (``utils/profiling.span``):
``collectives.gather`` (the all-gathers), ``collectives.sum`` (the
all-reduces of values, forward and backward) and ``collectives.grad_mean``
(:func:`average_gradients`). Each counts its ``calls`` and ``bytes`` (this
rank's payload: the all-gather's local block, the all-reduce's buffer), as
the kernels count their ``launches``; :func:`counts` reads them and
:func:`stats_line` prints them a step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from multimodal_active_ai_tpu_torch.parallel.distributed import rank, world_size
from multimodal_active_ai_tpu_torch.utils.profiling import span


def _count(fn, payload: torch.Tensor) -> None:
    fn.calls += 1
    fn.bytes += payload.numel() * payload.element_size()


def _gather(x: torch.Tensor) -> torch.Tensor:
    with span("collectives.gather"):
        blocks = [torch.empty_like(x) for _ in range(world_size())]
        block = x.contiguous()
        dist.all_gather(blocks, block)
        _count(_gather, block)
        return torch.cat(blocks, 0)


def _summed(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    with span("collectives.sum"):
        out = x if inplace else x.clone()
        dist.all_reduce(out)
        _count(_summed, out)
        return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad).narrow(0, rank() * ctx.n, ctx.n)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad)


def cross_replica_concat(x: torch.Tensor, differentiable_local: bool = True) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order. The remote
    blocks are detached; the local block carries ``x``'s gradient when
    ``differentiable_local``, else it is detached too."""
    if not dist.is_initialized():
        return x if differentiable_local else x.detach()
    gathered = _gather(x.detach())
    if not differentiable_local:
        return gathered
    n, r = x.shape[0], rank()
    return torch.cat([gathered[:r * n], x, gathered[(r + 1) * n:]], 0)


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` on dim 0, differentiable with respect to every
    block (the gradient of this rank's block is the sum over ranks)."""
    return _AllGather.apply(x) if dist.is_initialized() else x


def all_reduce_sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable: the cotangent of ``x``
    is the sum of every rank's cotangent of the result."""
    return _AllReduceSum.apply(x) if dist.is_initialized() else x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, without gradient."""
    return _summed(x.detach()) if dist.is_initialized() else x.detach()


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced by its sum over ranks, in place and without gradient
    (a contiguous buffer that autograd does not track); ``x`` as it is
    without a process group."""
    return _summed(x, inplace=True) if dist.is_initialized() else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks, without gradient (the JAX package's
    ``mean_across_replicas``)."""
    return all_reduce_sum(x) / world_size() if dist.is_initialized() else x.detach()


@torch.no_grad()
def average_gradients(params) -> None:
    """Replace each ``.grad`` of ``params`` by its mean over ranks: the
    gradient of the global batch's mean loss when every rank's loss is the
    mean over its own rows. One all-reduce of one flat buffer; parameters
    without a gradient stay out. Nothing to do at world 1."""
    if world_size() == 1:
        return
    with span("collectives.grad_mean"):
        grads = [p.grad for p in params if p.grad is not None]
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        _count(average_gradients, flat)
        flat.div_(world_size())
        for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)


_COUNTED = {"collectives.gather": _gather, "collectives.sum": _summed,
            "collectives.grad_mean": average_gradients}
for _fn in _COUNTED.values():
    _fn.calls = _fn.bytes = 0


def counts() -> dict[str, tuple[int, int]]:
    """``{span name: (calls, bytes)}`` of the three collectives since the
    process started or the last :func:`reset_counts`."""
    return {name: (fn.calls, fn.bytes) for name, fn in _COUNTED.items()}


def reset_counts() -> None:
    for fn in _COUNTED.values():
        fn.calls = fn.bytes = 0


def stats_line(steps: int) -> str:
    """One line: each collective's calls and MB a step over ``steps`` steps
    since the last :func:`reset_counts`."""
    n = max(steps, 1)
    parts = [f"{name.split('.')[1]} {calls / n:.1f} calls {b / n / 1e6:.2f} MB"
             for name, (calls, b) in counts().items()]
    return f"collectives a step ({steps} steps): " + " | ".join(parts)
