"""1×1 convolution with BatchNorm statistics fused into it.

Port of ``multimodal_active_ai_tpu/models/conv_bn.py``. :func:`conv1x1_bn`
is ``FusedConv1x1BN`` (:35-95) as a function of a Bottleneck's existing
``nn.Conv2d`` 1×1 conv and its norm layer, whose weights it reads: the
port keeps the reference torch names (``conv1``/``bn1``, ``conv3``/``bn3``,
``downsample.0``/``.1``), so a ``state_dict`` has one layout whether or not
the statistics are fused. Numerically it is the conv → BatchNorm pair:
fast-variance statistics, running update ``0.9·r + 0.1·batch`` with the
biased variance, eps from the norm layer. What changes is where the
statistics come from: the ``conv1x1_stats`` kernel's epilogue
(``impl='pallas'``) or the conv input through the gram identity
(``impl='gram'``), never a separate pass over the conv's output. With a
:class:`~multimodal_active_ai_tpu_torch.models.norm.SyncBatchNorm` the
``gram`` route's ``(Σy, Σy²)`` are summed over every rank; the ``pallas``
route is single-device, as in the JAX package, and raises at world > 1.

The layout helpers at the end are the port's own copy of the fused → unfused
half of the JAX package's checkpoint-layout conversion (:110-174), which
:func:`~multimodal_active_ai_tpu_torch.utils.checkpoint.from_jax_variables`
uses to read JAX variables of a model built with ``stat_fusion``.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_active_ai_tpu_torch.models.norm import BatchNorm, SyncBatchNorm, refuse_multi_device
from multimodal_active_ai_tpu_torch.ops.conv1x1_stats import conv1x1_stats, gram_stats
from multimodal_active_ai_tpu_torch.ops.stat_sums import mean_var_from_sums

IMPLS = ("pallas", "gram")


def conv1x1_bn(x: torch.Tensor, conv: nn.Conv2d, bn: BatchNorm, impl: str) -> torch.Tensor:
    """``bn(conv(x))`` for a bias-free 1×1 ``conv`` (any stride) with the
    batch statistics produced by the product itself.

    ``x`` is NCHW (on CUDA the NCHW view of ``channels_last`` memory, for
    which the NHWC flatten is free). The product runs in the autocast type
    when autocast is on, else in ``x``'s type; the normalisation in float32.
    Returns the NCHW view of an NHWC result in that type. Train mode takes
    the statistics from ``conv1x1_stats`` (``impl='pallas'``: the kernel on
    CUDA at any row count) or ``gram_stats`` (``impl='gram'``) and updates
    ``bn``'s running statistics; eval mode is the plain product normalised
    with the running statistics.
    """
    if impl not in IMPLS:
        raise ValueError(f"stat fusion impl {impl!r} not in {IMPLS}")
    if impl == "pallas":
        refuse_multi_device("--stat-fusion pallas", "--stat-fusion gram")
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    stride = conv.stride[0]
    n_out, k = conv.weight.shape[:2]
    if stride != 1:
        # a strided 1x1 conv reads every stride-th pixel (it never pads)
        x = x[:, :, ::stride, ::stride]
    b, _, h, w = x.shape
    with torch.autocast(dev, enabled=False):
        xd = x.permute(0, 2, 3, 1).contiguous().view(-1, k).to(dtype)
        wd = conv.weight.reshape(n_out, k).to(dtype)
        if not bn.training:
            y = xd @ wd.t()
            mean, var = bn.running_mean, bn.running_var
        else:
            y, s, sq = (conv1x1_stats if impl == "pallas" else gram_stats)(xd, wd)
            n = xd.shape[0]
            if isinstance(bn, SyncBatchNorm):
                s, sq, n = bn.global_sums(s, sq, n)
            mean, var = mean_var_from_sums(s, sq, n)
            bn.update_running(mean, var)
        out = bn.normalize(y, mean, var, dtype)
    return out.view(b, h, w, n_out).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# JAX checkpoint layout. A JAX Bottleneck built with stat_fusion folds its
# three Conv(1x1)+BatchNorm pairs into FusedConv1x1BN modules, which renames
# flax's auto-named slots:
#
# Unfused block:  Conv_0 BN_0 | Conv_1 BN_1 | Conv_2 BN_2 [| Conv_3 BN_3]
# Fused block:    Fused_0     | Conv_0 BN_0 | Fused_1     [| Fused_2]
# ---------------------------------------------------------------------------

_F = "FusedConv1x1BN_{}"
_C, _B = "Conv_{}", "BatchNorm_{}"


def _is_fused_bottleneck(d) -> bool:
    return isinstance(d, dict) and _F.format(0) in d


def _unfuse_block(params: dict, stats: dict) -> tuple[dict, dict]:
    def split(f):
        return {"kernel": f["kernel"]}, {"scale": f["scale"], "bias": f["bias"]}

    c0, b0 = split(params[_F.format(0)])
    c2, b2 = split(params[_F.format(1)])
    up = {_C.format(0): c0, _B.format(0): b0,
          _C.format(1): params[_C.format(0)],
          _B.format(1): params[_B.format(0)],
          _C.format(2): c2, _B.format(2): b2}
    us = {_B.format(0): stats.get(_F.format(0)),
          _B.format(1): stats.get(_B.format(0)),
          _B.format(2): stats.get(_F.format(1))}
    if _F.format(2) in params:
        c3, b3 = split(params[_F.format(2)])
        up[_C.format(3)] = c3
        up[_B.format(3)] = b3
        us[_B.format(3)] = stats.get(_F.format(2))
    # a parameter-layout tree alone (an optimizer's moments) has no statistics
    return up, {k: v for k, v in us.items() if v is not None}


def is_fused_layout(params) -> bool:
    """True if any subtree of ``params`` uses the ``FusedConv1x1BN`` layout."""
    if not isinstance(params, dict):
        return False
    return any(k.startswith("FusedConv1x1BN") or is_fused_layout(v)
               for k, v in params.items())


def unfuse_variables(params: dict, batch_stats: dict) -> tuple[dict, dict]:
    """Map JAX ``(params, batch_stats)`` of the fused Bottleneck layout to the
    unfused (``Conv → BatchNorm``) one; other entries pass through. Raises
    if a ``FusedConv1x1BN`` slot is left that no block map covers."""

    def walk(p, s):
        out_p, out_s = {}, {}
        for k, v in p.items():
            if _is_fused_bottleneck(v):
                out_p[k], out_s[k] = _unfuse_block(v, s.get(k, {}))
            elif isinstance(v, dict):
                out_p[k], out_s[k] = walk(v, s.get(k, {}))
            else:
                out_p[k] = v
        for k, v in s.items():       # statistics with no parameter sibling
            if k not in out_s and k not in out_p:
                out_s[k] = v
        return out_p, {k: v for k, v in out_s.items() if not (isinstance(v, dict) and not v)}

    up, us = walk(params, batch_stats)
    if is_fused_layout(up) or is_fused_layout(us):
        raise ValueError("FusedConv1x1BN slots outside a Bottleneck block; "
                         "cannot map them to the reference layout")
    return up, us
