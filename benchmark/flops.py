"""The benchmark's own count of a step's operations and of B1's bytes.

Operations are those of the products (convolutions, matrix products and
attention's two products), two per multiply-add, as the algorithm needs
them whatever implements it: each view or glimpse batch forward once, and
a view that takes gradient twice more for its backward (the input's and
the weights' gradients), less the input-gradients nothing needs (the stem
convolution's, whose input is the data; the first decoder layer's value
projection, whose input is the zero target). Nothing is counted for
recomputation, normalisation, activations or the optimizer. The DETR
class head counts the last decoder layer only: the loss reads no other.

B1's least bytes follow the roofline rule: each input byte read once and
each output byte written once, and of the mip pyramid only the pixels
that some tap of nonzero weight reads (bf16 RGB, 6 bytes a pixel), found
from the plan of the draws the run handed the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import retina


def _conv(cin, cout, k, hw_out):
    return 2 * cin * cout * k * k * hw_out * hw_out


def _down(side: int, stride: int) -> int:
    return (side - 1) // stride + 1


def resnet(cfg: dict, side: int) -> tuple[int, int, int]:
    """Forward FLOPs of one glimpse stack through the ResNet, the stem
    convolution's share, and the output side."""
    cin = 3 * len(cfg["retina"]["crop_sizes"])
    stem = _conv(cin, 64, 7, side)
    total, c = stem, 64
    exp = 4 if cfg["block"] == "bottleneck" else 1
    for planes, n, stride in zip((64, 128, 256, 512), cfg["layers"], (1, 2, 2, 2)):
        for i in range(n):
            s = stride if i == 0 else 1
            out = _down(side, s)
            if cfg["block"] == "bottleneck":
                total += (_conv(c, planes, 1, side) + _conv(planes, planes, 3, out)
                          + _conv(planes, planes * 4, 1, out))
            else:
                total += _conv(c, planes, 3, out) + _conv(planes, planes, 3, out)
            if s != 1 or c != planes * exp:
                total += _conv(c, planes * exp, 1, out)
            c, side = planes * exp, out
    return total, stem, side


def simclr_step(cfg: dict, n: int, fixations: int) -> int:
    """One SimCLR step of a global batch of ``n`` images: ``1 + F`` views
    forward, ``F`` of them backward, ``F`` NT-Xent losses."""
    fwd, stem, side = resnet(cfg, cfg["retina"]["glimpse_size"])
    feat = 512 * (4 if cfg["block"] == "bottleneck" else 1) * side * side
    h, d = cfg["projection_hidden"], cfg["projection_dim"]
    fwd += 2 * (feat * h + h * d)
    per_view = n * fwd
    backward = 2 * per_view - n * stem
    loss = 8 * n * n * d + 4 * n * n * d     # 4 similarities; 2 take gradient
    return (1 + fixations) * per_view + fixations * (backward + loss)


def detr_step(cfg: dict, n: int, fixations: int) -> int:
    """One DETR update on ``n`` images of ``F`` glimpses each."""
    fwd, stem, side = resnet(cfg, cfg["retina"]["glimpse_size"])
    feat = 512 * (4 if cfg["block"] == "bottleneck" else 1) * side * side
    d, ff, q, s = cfg["hidden_dim"], cfg["dim_feedforward"], cfg["num_queries"], fixations
    t, tq = n * s, n * q
    f = n * s * fwd + 2 * t * feat * d
    enc = 4 * 2 * t * d * d + 2 * 2 * n * s * s * d + 2 * 2 * t * d * ff
    dec = (4 * 2 * tq * d * d + 2 * 2 * n * q * q * d
           + 2 * 2 * tq * d * d + 2 * 2 * t * d * d + 2 * 2 * n * q * s * d
           + 2 * 2 * tq * d * ff)
    f += cfg["enc_layers"] * enc + cfg["dec_layers"] * dec + 2 * tq * d * cfg["num_classes"]
    return 3 * f - n * s * stem - 2 * tq * d * d


def touched_pixels(plan: retina.LevelPlan, rows: torch.Tensor, mip_side: int) -> int:
    """Distinct mip pixels that some nonzero-weight tap of one level reads."""
    m, win = mip_side, plan.win
    s = plan.start.clamp(0, m - win)
    ry = plan.rel_y.clamp(0, win - 1)
    rxa = (plan.rel_x + s[:, 1:2]).clamp(s[:, 1:2].float(), (s[:, 1:2] + win - 1).float())
    y0, x0 = ry.floor(), rxa.floor()
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            keep = torch.ones_like(ry, dtype=torch.bool)
            if dy:
                keep &= (ry - y0) > 0
            if dx:
                keep &= (rxa - x0) > 0
            y = s[:, 0:1] + y0.long() + dy
            x = x0.long() + dx
            taps.append(((rows[:, None] * m + y) * m + x)[keep])
    return torch.unique(torch.cat(taps)).numel()


def b1_bytes(p: retina.Params, src_batch: int, canvas: int, glimpse: int, crop_sizes) -> int:
    """Least bytes of one B1 launch over plan rows ``p`` (row ``b`` reads
    source image ``b % src_batch``): outputs and coordinates once, and the
    touched mip pixels."""
    b, levels, pts = p.fix_yx.shape[0], len(crop_sizes), glimpse * glimpse
    nbytes = b * 3 * levels * pts * 4 + 3 * b * levels * pts * 4 + b * levels * 2 * 4
    rows = torch.arange(b, device=p.fix_yx.device) % src_batch
    for plan in retina.plans(p, canvas, glimpse, crop_sizes):
        nbytes += 6 * touched_pixels(plan, rows, canvas // plan.factor)
    return nbytes
