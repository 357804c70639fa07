"""The analytic operation count against ``FlopCounterMode`` over the
reference, and B1's least bytes against the plan's shapes."""

import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, spec, traffic, weights
from benchmark.reference import detr, optim, retina, simclr

CELLS = {"simclr": "simclr-r50-b256-f10", "detr": "detr-r50-b256-f2"}


def _cfg(kind, rehearse):
    return spec.Cell(CELLS[kind], rehearse=rehearse).config


@pytest.mark.parametrize("rehearse", [True, False], ids=["small", "published"])
def test_simclr_step_flops(rehearse):
    cfg = _cfg("simclr", rehearse)
    n, views = 2, 3
    model = weights.make(simclr.SimCLR, cfg, 1, "cpu")
    opt = optim.Adam(dict(model.named_parameters()))
    g = torch.randn(views, n, 30, 30, 3 * len(cfg["retina"]["crop_sizes"]))
    vs = type("V", (), {"count": views, "__call__": lambda self, j: g[j]})()
    with FlopCounterMode(display=False) as fc:
        simclr.train_step(model, opt, lambda c: 0.0, 0, vs, 0.05)
    assert fc.get_total_flops() == flops.simclr_step(cfg, n, views - 1)


@pytest.mark.parametrize("rehearse", [True, False], ids=["small", "published"])
def test_detr_step_flops(rehearse):
    cfg = _cfg("detr", rehearse)
    n, s = 2, 2
    model = weights.make(detr.DETR, cfg, 1, "cpu")
    opt = optim.Adam({k: p for k, p in model.named_parameters()
                      if detr.groups(model)[k] != "frozen"}, weight_decay=1e-4)
    g = torch.randn(n, s, 30, 30, 3 * len(cfg["retina"]["crop_sizes"]))
    with FlopCounterMode(display=False) as fc:
        detr.train_step(model, opt, cfg, 1.0, g, torch.rand(n, s, 2), 1,
                        torch.randint(0, cfg["num_classes"], (n,)), torch.Generator())
    assert fc.get_total_flops() == flops.detr_step(cfg, n, s)


def test_b1_bytes_from_the_plan():
    r = _cfg("simclr", False)["retina"]
    n, canvas, g = 3, 640, r["glimpse_size"]
    p, _ = traffic.simclr_views(9, 0, 1, n, canvas, r, "cpu")[0]
    levels, pts = len(r["crop_sizes"]), g * g
    rows = torch.arange(n)
    touched = 0
    for plan in retina.plans(p, canvas, g, r["crop_sizes"]):
        m, win = canvas // plan.factor, plan.win
        pixels = set()
        s = plan.start.clamp(0, m - win)
        for b, i in itertools.product(range(n), range(pts)):
            ry = min(max(float(plan.rel_y[b, i]), 0.0), win - 1.0)
            rx = min(max(float(plan.rel_x[b, i]), 0.0), win - 1.0)
            for y in {int(ry // 1), int(-(-ry // 1))}:
                for x in {int(rx // 1), int(-(-rx // 1))}:
                    pixels.add((int(rows[b]), int(s[b, 0]) + y, int(s[b, 1]) + x))
        touched += len(pixels)
    want = n * 3 * levels * pts * 4 + 3 * n * levels * pts * 4 + n * levels * 2 * 4 + 6 * touched
    assert flops.b1_bytes(p, n, canvas, g, r["crop_sizes"]) == want
