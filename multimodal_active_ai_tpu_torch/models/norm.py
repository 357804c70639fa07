"""Norm layers with flax semantics.

Port of ``multimodal_active_ai_tpu/models/norm.py``. ``bn``, ``sync_bn``
and ``bn_fused`` (``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``,
the same with ``axis_name``, and ``FusedStatsBatchNorm``) differ from
``torch.nn.BatchNorm2d`` where eval-mode outputs would otherwise diverge:

* batch statistics are taken in float32 whatever the input dtype, with the
  one-pass ("fast") variance ``E[x²] - E[x]²`` clipped at 0;
* the running update is ``r ← 0.9·r + 0.1·batch`` with the **biased**
  batch variance (``BatchNorm2d`` uses the unbiased one);
* the output is ``(x - mean)·rsqrt(var + ε)·weight + bias``, computed in
  float32 and cast back to the input dtype.

The buffers keep torch's names (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so ``state_dict`` keys are those
of the reference torch checkpoints, and the three kinds' ``state_dict``s
are interchangeable.

``sync_bn`` (:class:`SyncBatchNorm`) takes the statistics of the global
batch, every rank's rows (``parallel/``): at world 1 it is ``bn``. It is
not ``torch.nn.SyncBatchNorm``, whose unbiased running variance and
Welford merge give other numbers than the JAX package's. ``bn_fused``
launches the ``stat_sums`` kernel on one device only, as the JAX package
does, and raises at world > 1.

:func:`conv_norm_act` is ``relu?(norm(conv(x)) [+ identity])``, the
ResNet's call of every conv and its norm: for a train-mode ``bn`` or
``sync_bn`` on a CUDA tensor the norm, add and ReLU are the fused kernels
of ``ops/bn_act.py``, two launches forward and two backward (for
``sync_bn`` at world > 1 with one in-place all-reduce of the per-channel
sums each way between them); for every other kind, mode and device the
module, then the add and the ReLU as separate ops.
:func:`sync_bn_counts` counts ``sync_bn``'s train-mode calls by route
(``fused``, ``chain``) and :func:`sync_bn_line` prints them a step.

``frozen`` (:class:`FrozenBatchNorm`, the DETR backbone's) holds all four
tensors as buffers, as the reference's ``FrozenBatchNorm2d`` does, and
``group`` (:class:`GroupNormAdapter`) is flax's ``GroupNorm`` (ε = 1e-6,
float32 statistics); neither has a train mode.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.ops import bn_act
from multimodal_active_ai_tpu_torch.ops.stat_sums import batch_mean_var, mean_var_from_sums
from multimodal_active_ai_tpu_torch.parallel import all_reduce_sum_with_grad, world_size


class BatchNorm(nn.Module):
    """Flax-semantics BatchNorm over the channel dim 1 of an NCHW input."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum  # flax convention: weight of the old value
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return self.normalize(x.movedim(1, -1), mean, var, x.dtype).movedim(-1, 1)

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Float32 ``(mean, var)`` of ``x`` over all but the channel dim 1."""
        mean, raw = bn_act.mean_raw_var(x)
        return mean, torch.clamp_min(raw, 0.0)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``r ← momentum·r + (1 - momentum)·batch`` for the batch's
        ``mean`` and biased ``var``."""
        bn_act.update_running(self.running_mean, self.running_var, self.num_batches_tracked,
                              mean, var, self.momentum)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """``(x - mean)·rsqrt(var + ε)·weight + bias`` in float32, cast to
        ``dtype``, for ``x`` with the channels on its last axis."""
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.to(torch.float32) - mean) * mul + self.bias).to(dtype)


class SyncBatchNorm(BatchNorm):
    """:class:`BatchNorm` whose training statistics are the global batch's:
    each rank's float32 ``(Σx, Σx², count)`` are summed over the process
    group by a differentiable all-reduce, so each rank's backward carries
    every rank's cotangent of the global statistics. Same parameters,
    buffers, one-pass variance and running update as ``bn``; at world 1
    it is ``bn`` bit for bit. Every rank runs each train-mode forward.
    This module's ``forward`` is the float32 chain; :func:`conv_norm_act`
    takes ``bn_act``'s kernels instead where :func:`fusable`."""

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _SYNC_BN_CALLS["chain"] += 1
        if world_size() == 1:
            return super()._batch_stats(x)
        xf = x.to(torch.float32)
        dims = [0] + list(range(2, x.dim()))
        s, sq, n = self.global_sums(xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                                    x.numel() // x.shape[1])
        return mean_var_from_sums(s, sq, n)

    @staticmethod
    def global_sums(s: torch.Tensor, sq: torch.Tensor, n: int):
        """``(Σx, Σx², rows)`` of one rank → the sums over every rank
        (returned as they are at world 1)."""
        if world_size() == 1:
            return s, sq, n
        count = torch.full((1,), float(n), dtype=s.dtype, device=s.device)
        total = all_reduce_sum_with_grad(torch.cat([s, sq, count]))
        c = s.shape[0]
        return total[:c], total[c:2 * c], total[2 * c]


def refuse_multi_device(what: str, instead: str) -> None:
    """The JAX package's refusal of its single-device kernels on more than
    one device (root ``contrastive_learning.py:131-136``)."""
    if world_size() > 1:
        raise SystemExit(f"{what} is single-device only; use {instead} on "
                         "multi-device meshes")


class FusedStatsBatchNorm(BatchNorm):
    """:class:`BatchNorm` whose batch statistics come from one
    :func:`~multimodal_active_ai_tpu_torch.ops.stat_sums.batch_mean_var`
    pass (the ``stat_sums`` kernel on CUDA) instead of two ``.mean()``
    reductions. Same parameters, buffers and arithmetic.

    The input is viewed channels-last as ``(N·H·W, C)``: free for the
    port's ``channels_last`` activations on CUDA, a copy otherwise.
    """

    def _batch_stats(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        refuse_multi_device("norm kind 'bn_fused'", "norm kind 'sync_bn'")
        return batch_mean_var(x.movedim(1, -1))


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (the JAX
    package's ``FrozenBatchNorm``, reference ``backbone.py:35-70``).

    ``scale = weight / sqrt(var + ε)`` and ``shift = bias - mean·scale`` are
    taken in float32, then ``x·scale + shift`` in the input's dtype (bf16
    under the drivers' autocast), as the JAX module applies them in its
    dtype. The four tensors are buffers, so no optimizer sees them, and
    there is no ``num_batches_tracked``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class GroupNormAdapter(nn.Module):
    """flax ``GroupNorm`` over the channel dim 1: ``num_groups`` = the
    largest divisor of the channel count that is at most 32, float32
    statistics, ε = 1e-6 (flax's default, not torch's 1e-5), output in the
    input's dtype. Parameters ``weight``/``bias``."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        groups = min(num_groups, num_features)
        while num_features % groups:
            groups -= 1
        self.num_groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.group_norm(x.to(torch.float32), self.num_groups,
                                     self.weight, self.bias, self.eps)
        return y.to(x.dtype)


_SYNC_BN_CALLS = {"fused": 0, "chain": 0}


def sync_bn_counts() -> dict[str, int]:
    """Train-mode :class:`SyncBatchNorm` forward calls by route since the
    process started or the last :func:`reset_sync_bn_counts`: ``fused``
    (the kernels of ``ops/bn_act.py``) and ``chain`` (the module's float32
    chain). A backward follows a call on the route its forward took."""
    return dict(_SYNC_BN_CALLS)


def reset_sync_bn_counts() -> None:
    for route in _SYNC_BN_CALLS:
        _SYNC_BN_CALLS[route] = 0


def sync_bn_line(steps: int) -> str:
    """One line: :func:`sync_bn_counts` a step over ``steps`` steps."""
    n = max(steps, 1)
    return f"sync_bn calls a step ({steps} steps): " + " | ".join(
        f"{route} {calls / n:.1f}" for route, calls in _SYNC_BN_CALLS.items())


def fusable(norm: nn.Module, x: torch.Tensor, identity: torch.Tensor | None = None) -> bool:
    """Whether :func:`conv_norm_act` runs ``norm`` as the fused kernels: a
    train-mode :class:`BatchNorm` or :class:`SyncBatchNorm` on a CUDA bf16
    or float32 ``x``, with an ``identity`` (if any) of its type."""
    kind = type(norm) is BatchNorm or type(norm) is SyncBatchNorm
    return (kind and norm.training and x.is_cuda and x.dtype in (torch.bfloat16, torch.float32)
            and (identity is None or identity.dtype == x.dtype))


def conv_norm_act(conv: nn.Module, norm: nn.Module, x: torch.Tensor,
                  identity: torch.Tensor | None = None, relu: bool = True) -> torch.Tensor:
    """``relu?(norm(conv(x)) [+ identity])``: ``conv``, then one
    :func:`~multimodal_active_ai_tpu_torch.ops.bn_act.batch_norm_act` where
    :func:`fusable` (over every rank's rows for a :class:`SyncBatchNorm` at
    world > 1), else ``norm``, the add and the ReLU one after the other,
    each intermediate freed as soon as the next op has it."""
    y = conv(x)
    if fusable(norm, y, identity):
        sync = type(norm) is SyncBatchNorm
        if sync:
            _SYNC_BN_CALLS["fused"] += 1
        return bn_act.batch_norm_act(y, norm.weight, norm.bias, norm.running_mean,
                                     norm.running_var, norm.num_batches_tracked, norm.momentum,
                                     norm.eps, identity, relu, sync and world_size() > 1)
    out = norm(y)
    del y
    if identity is not None:
        return torch.relu(out + identity) if relu else out + identity
    return torch.relu(out) if relu else out


def make_norm(kind: str):
    """Norm-layer factory, the analogue of the reference's ``norm_layer``:
    ``'bn'``, ``'sync_bn'``, ``'bn_fused'``, ``'frozen'`` or ``'group'``."""
    kinds = {"bn": BatchNorm, "sync_bn": SyncBatchNorm, "bn_fused": FusedStatsBatchNorm,
             "frozen": FrozenBatchNorm, "group": GroupNormAdapter}
    if kind in kinds:
        return kinds[kind]
    raise ValueError(f"unknown norm kind {kind!r}")
