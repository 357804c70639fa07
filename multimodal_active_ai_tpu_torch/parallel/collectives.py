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
  metrics; :func:`average_gradients` is the gradient all-reduce, one
  coalesced buffer a call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from multimodal_active_ai_tpu_torch.parallel.distributed import rank, world_size


def _gather(x: torch.Tensor) -> torch.Tensor:
    blocks = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(blocks, x.contiguous())
    return torch.cat(blocks, 0)


def _summed(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out)
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
    grads = [p.grad for p in params if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    flat.div_(world_size())
    for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(avg)
