"""The foveated ResNet, its projector and the layers they share, plain.

The reference's modules carry the parameter and buffer names of the
reference torch checkpoints (``conv1``, ``bn1``, ``layer{s}.{i}.conv{k}``,
``downsample.0/1``, ``g.layers.0/2``), so one state dict made by the
benchmark loads into both the reference and the program. Each module
states how its tensors start (:meth:`init_plan`): normal draws with a
standard deviation, or constants.

Semantics (from the published architecture and the JAX package's
documented choices): ``conv1`` on ``3·levels`` channels at stride 1, no
max-pool, v1.5 Bottlenecks (stride on the 3×3), no final pool, so a
``(B, 30, 30, 12)`` glimpse stack gives a ``(B, C, 4, 4)`` map; BatchNorm
with flax's arithmetic (float32 batch statistics, one-pass biased variance
clipped at 0, ε = 1e-5, running ``r ← 0.9·r + 0.1·batch``), or frozen
(``x·scale + shift`` from fixed statistics); the projector flattens C-major.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import EXACT


def calibrate_frozen(body: nn.Module, glimpses: torch.Tensor) -> None:
    """Set every frozen BatchNorm's statistics to the mean and biased
    variance of its own input over ``glimpses``, in forward order, as a
    network trained with BatchNorm carries its inputs' statistics."""
    def pre(mod, args):
        x = args[0]
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(pre) for m in body.modules()
             if isinstance(m, BatchNorm) and m.frozen]
    with torch.no_grad():
        body(glimpses)
    for h in hooks:
        h.remove()


class Conv(nn.Module):
    """Bias-free 2-D convolution, ``padding = k // 2``; init normal with
    std ``√(2 / fan_out)`` (He, fan out)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride = stride

    def init_plan(self):
        w = self.weight
        return [(w, math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3])))]

    def forward(self, x, prec):
        k = self.weight.shape[-1]
        return F.conv2d(prec.q(x), prec.q(self.weight), stride=self.stride, padding=k // 2)


class Linear(nn.Module):
    """``x·Wᵀ + b``; init normal with std ``√(1 / fan_in)`` (LeCun), zero
    bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_plan(self):
        with torch.no_grad():
            self.bias.zero_()
        return [(self.weight, math.sqrt(1.0 / self.weight.shape[1]))]

    def forward(self, x, prec):
        return prec.q(x) @ prec.q(self.weight).T + self.bias


class BatchNorm(nn.Module):
    """Flax-semantics BatchNorm over channel dim 1 of NCHW; ``frozen``
    keeps its statistics as buffers and has no train mode."""

    def __init__(self, c: int, frozen: bool = False, gamma: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.frozen, self.gamma, self.eps = frozen, gamma, eps
        if frozen:
            self.register_buffer("weight", torch.empty(c))
            self.register_buffer("bias", torch.empty(c))
        else:
            self.weight = nn.Parameter(torch.empty(c))
            self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        if not frozen:
            self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def init_plan(self):
        with torch.no_grad():
            self.weight.fill_(self.gamma)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            if not self.frozen:
                self.num_batches_tracked.zero_()
        return []

    def forward(self, x, prec):
        shape = (1, -1, 1, 1)
        if self.frozen:
            scale = self.weight / torch.sqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.view(shape) + shift.view(shape)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, down: bool, frozen: bool,
                 gamma: float):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, planes, 3, stride), BatchNorm(planes, frozen)
        self.conv2, self.bn2 = Conv(planes, planes, 3), BatchNorm(planes, frozen, gamma)
        self.downsample = (nn.ModuleList([Conv(cin, planes, 1, stride), BatchNorm(planes, frozen)])
                           if down else None)

    def forward(self, x, prec):
        idt = x if self.downsample is None else self.downsample[1](self.downsample[0](x, prec), prec)
        out = F.relu(self.bn1(self.conv1(x, prec), prec))
        return F.relu(self.bn2(self.conv2(out, prec), prec) + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, down: bool, frozen: bool,
                 gamma: float):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = Conv(cin, planes, 1), BatchNorm(planes, frozen)
        self.conv2, self.bn2 = Conv(planes, planes, 3, stride), BatchNorm(planes, frozen)
        self.conv3, self.bn3 = Conv(planes, out, 1), BatchNorm(out, frozen, gamma)
        self.downsample = (nn.ModuleList([Conv(cin, out, 1, stride), BatchNorm(out, frozen)])
                           if down else None)

    def forward(self, x, prec):
        idt = x if self.downsample is None else self.downsample[1](self.downsample[0](x, prec), prec)
        out = F.relu(self.bn1(self.conv1(x, prec), prec))
        out = F.relu(self.bn2(self.conv2(out, prec), prec))
        return F.relu(self.bn3(self.conv3(out, prec), prec) + idt)


BLOCKS = {"basic": Basic, "bottleneck": Bottleneck}


class ResNet(nn.Module):
    """``(B, g, g, in_channels)`` NHWC glimpses → ``(B, C, h, w)`` NCHW."""

    def __init__(self, block: str, layers, in_channels: int, frozen: bool = False,
                 residual_gamma: float = 1.0):
        super().__init__()
        cls = BLOCKS[block]
        self.conv1, self.bn1 = Conv(in_channels, 64, 7), BatchNorm(64, frozen)
        cin = 64
        for s, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            blocks = []
            for i in range(n):
                st = stride if i == 0 else 1
                blocks.append(cls(cin, planes, st, st != 1 or cin != planes * cls.expansion,
                                  frozen, residual_gamma))
                cin = planes * cls.expansion
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
        self.out_channels = cin

    def forward(self, x, prec=EXACT):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2), prec), prec))
        for s in range(1, 5):
            for blk in getattr(self, f"layer{s}"):
                x = blk(x, prec)
        return x


class Projector(nn.Module):
    """C-major flatten → Linear → ReLU → Linear, as ``layers.0``/``layers.2``."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleDict({"0": Linear(cin, hidden), "2": Linear(hidden, out)})

    def forward(self, x, prec=EXACT):
        x = x.reshape(x.shape[0], -1)
        return self.layers["2"](F.relu(self.layers["0"](x, prec)), prec)
