"""The launch plans of the port's kernels, held on the CPU.

``conv1x1_plan`` (B3, ``ops/conv1x1_stats.py``), ``stat_sums_plan`` (B2,
``ops/stat_sums.py``), ``glimpse_sample_plan`` and ``hat_sample_plan`` (B1
and B4, ``ops/glimpse_sample.py``) and ``bn_act_plan`` (the fused
BatchNorm + ReLU, ``ops/bn_act.py``) are pure Python: they choose the tiles,
the ring, the grid, the route and the static schedule that the CUDA
kernels then check and follow. The kernels themselves run only on the card
(``chip_smoke.py``); here the plans are held at the shapes the main path
gives them, on an H100's 132 SMs.
"""

import pytest

import torch

from chip_smoke import resnet50_fused_shapes, resnet_bn_shapes
from multimodal_active_ai_tpu_torch.models.norm import BatchNorm
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder
from multimodal_active_ai_tpu_torch.models.resnet1d import resnet1d_18
from multimodal_active_ai_tpu_torch.ops import bn_act as ba
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs
from multimodal_active_ai_tpu_torch.ops import stat_sums as ss

SMS = 132
B2_B128, B3_B128 = resnet50_fused_shapes(128)
B2_B1, B3_B1 = resnet50_fused_shapes(1)
TAILS = [(96, 24, 40), (64, 16, 64), (100, 12, 7), (1000, 64, 200)]
B3_SHAPES = sorted(B3_B128) + sorted(B3_B1) + TAILS
WGMMA_SHAPES = [(m, k, n) for m, k, n in B3_SHAPES if k % 8 == 0 and n % 8 == 0]
B2_SHAPES = sorted(B2_B128) + sorted(B2_B1) + [(40, 24), (1001, 64), (333, 3), (7, 64)]
BN_R50_B256 = resnet_bn_shapes("ResNet50", 256)
# the other callers' BatchNorms: ResNet-18 (the DQN, the loss-curve and
# convergence cases) and ResNet-10 (tests, the rehearsal), and a 1-D
# ResNet's (B, C, L) read as (B·L, C)
BN_1D = [(4 * 5000, 64), (4 * 2500, 128), (4 * 1250, 256), (4 * 625, 512)]
BN_SHAPES = (sorted(BN_R50_B256) + sorted(resnet_bn_shapes("ResNet18", 128))
             + sorted(resnet_bn_shapes("ResNet10", 8)) + BN_1D
             + [(40, 24), (1001, 64), (333, 3), (7, 64), (1, 2048)])


def test_main_path_shapes():
    assert len(B3_B128) == 15 and sum(B3_B128.values()) == 36
    assert sum(B2_B128.values()) == 17
    assert sorted({m for m, _, _ in B3_B1}, reverse=True) == [900, 225, 64, 16]


@pytest.mark.parametrize("mkn", B3_SHAPES, ids=str)
def test_conv1x1_plan_tiles_and_memory(mkn):
    m, k, n = mkn
    plan = cs.conv1x1_plan(m, k, n, SMS)
    if k % 8 or n % 8:
        assert plan.route == "wmma"
        return
    assert plan.route == "wgmma"
    assert plan.bm in (64, 128)                          # one or two m64 warpgroups
    assert plan.bn % 8 == 0 and 8 <= plan.bn <= 256      # a wgmma width
    assert cs.SLICE_ROW_BYTES == 64 * 2                  # a K slice is one 128-byte row
    assert 3 <= plan.stages <= cs.MAX_STAGES
    assert plan.smem == cs.wgmma_smem_bytes(plan.bm, plan.bn, plan.stages)
    assert plan.smem <= cs.BLOCK_SMEM                    # 227 KB a block
    assert plan.ctas_per_sm * (plan.smem + cs.CTA_RESERVED) <= cs.SM_SMEM
    assert plan.tiles == -(-m // plan.bm) * -(-n // plan.bn)
    assert plan.tiles_n <= plan.grid <= min(plan.tiles, SMS * plan.ctas_per_sm)
    assert plan.partial_rows == plan.grid                # one (2, BN) row per CTA


@pytest.mark.parametrize("mkn", WGMMA_SHAPES, ids=str)
def test_conv1x1_schedule_covers_each_tile_once(mkn):
    plan = cs.conv1x1_plan(*mkn, SMS)
    assert plan.route == "wgmma"
    tiles_m = plan.tiles // plan.tiles_n
    owner = {}
    for c in range(plan.grid):
        tn, run = plan.schedule(c)
        assert len(run) >= 1                             # no CTA idle
        assert plan.first_cta(tn) <= c < plan.first_cta(tn + 1)
        for tm in run:
            assert 0 <= tm < tiles_m and (tn, tm) not in owner
            owner[(tn, tm)] = c
    assert len(owner) == plan.tiles
    # the rows the last CTA of N tile tn adds are exactly its visitors'
    for tn in range(plan.tiles_n):
        visitors = {owner[(tn, tm)] for tm in range(tiles_m)}
        assert visitors == set(range(plan.first_cta(tn), plan.first_cta(tn + 1)))


@pytest.mark.parametrize("mkn", sorted(B3_B128), ids=str)
def test_conv1x1_main_path_fills_a_wave(mkn):
    plan = cs.conv1x1_plan(*mkn, SMS)
    assert plan.route == "wgmma"
    assert plan.tiles >= SMS and plan.grid >= SMS


@pytest.mark.parametrize("mkn", [(100, 12, 7), (96, 20, 40), (64, 64, 60), (4096, 4, 64)],
                         ids=str)
def test_conv1x1_route_by_shape(mkn):
    m, k, n = mkn
    assert cs.conv1x1_plan(m, k, n, SMS).route == "wmma"
    assert cs.conv1x1_plan(m, 64, 64, SMS, aligned=False).route == "wmma"
    assert cs.conv1x1_plan(m, k, n, SMS, bf16=False).route == "fma"


@pytest.mark.parametrize("nc", B2_SHAPES, ids=str)
@pytest.mark.parametrize("element_size, vec", [(2, True), (4, True), (2, False)])
def test_stat_sums_plan_covers_rows_once_in_one_wave(nc, element_size, vec):
    n, c = nc
    vec = vec and c % (16 // element_size) == 0
    plan = ss.stat_sums_plan(n, c, element_size, vec, SMS)
    slots = ss.THREADS // plan.cols
    assert plan.cols & (plan.cols - 1) == 0 and plan.cols * plan.v <= ss.TILE_C
    assert plan.rows_per_block % slots == 0
    assert plan.tiles_c * plan.cols * plan.v >= c > (plan.tiles_c - 1) * plan.cols * plan.v
    assert plan.blocks <= max(SMS * ss.BLOCKS_PER_SM, plan.tiles_c)
    covered = [0] * n
    for b in range(plan.row_blocks):
        rows = range(b * plan.rows_per_block, min(n, (b + 1) * plan.rows_per_block))
        assert len(rows) >= 1                             # no block empty
        for r in rows:
            covered[r] += 1
    assert covered == [1] * n


def _norm_inputs(model, x):
    """The ``(rows, C)`` each BatchNorm of ``model`` sees in one train-mode
    forward of ``x`` (on the meta device: shapes only)."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        (a[0].numel() // a[0].shape[1], a[0].shape[1])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    model(x)
    for h in hooks:
        h.remove()
    return sorted(seen)


@pytest.mark.parametrize("arch, batch", [("ResNet50", 256), ("ResNet18", 128), ("ResNet10", 8)])
def test_resnet_bn_shapes_are_the_models(arch, batch):
    with torch.device("meta"):
        model = build_encoder(arch)
        x = torch.empty(batch, 30, 30, 12)
    assert sorted(resnet_bn_shapes(arch, batch).elements()) == _norm_inputs(model, x)
    assert sum(BN_R50_B256.values()) == 53 and len(BN_R50_B256) == 11


def test_resnet1d_bn_shapes():
    with torch.device("meta"):
        model = resnet1d_18(length=5000)
        x = torch.empty(4, 5000, 1)
    assert set(BN_1D) <= set(_norm_inputs(model, x))


@pytest.mark.parametrize("nc", BN_SHAPES, ids=str)
@pytest.mark.parametrize("element_size, vec", [(2, True), (4, True), (2, False)])
def test_bn_act_plan_covers_rows_once_in_one_wave(nc, element_size, vec):
    """One plan for the four kernels: tiles of at most 64 channels of
    16-byte vectors, at most two blocks of 512 threads an SM (or one block
    a channel tile), each row in exactly one block, no block empty."""
    n, c = nc
    vec = vec and c % (16 // element_size) == 0
    plan = ba.bn_act_plan(n, c, element_size, vec, SMS)
    assert plan.v == (16 // element_size if vec else 1)
    assert plan.cols & (plan.cols - 1) == 0 and plan.cols * plan.v <= ba.TILE_C
    assert ba.THREADS % plan.cols == 0 and (plan.cols <= 32 or plan.cols == 64)
    slots = ba.THREADS // plan.cols
    assert plan.rows_per_block % slots == 0
    assert plan.tiles_c * plan.cols * plan.v >= c > (plan.tiles_c - 1) * plan.cols * plan.v
    assert plan.blocks <= max(SMS * ba.BLOCKS_PER_SM, plan.tiles_c)
    assert plan.row_blocks * plan.rows_per_block >= n > (plan.row_blocks - 1) * plan.rows_per_block
    if (n, c) in BN_R50_B256 and vec:
        # the main path: a full wave of blocks, each with whole passes
        assert plan.blocks >= SMS
        assert plan.cols * plan.v == min(c, ba.TILE_C)


# B1: the main path's plan (B=128, L=4, P=900), a 3-view plan, P=899 (the
# scalar route at the main path's size), P=13 and P=1; B4: one level of each
SAMPLER_PLANS = [(128, 4, 900), (384, 4, 900), (128, 4, 899), (3, 2, 13), (2, 1, 1),
                 (1, 1, 1500)]


def _covered(plan):
    """How often each point of one window is sampled, over the blocks of one
    ``(b, l)`` and their threads."""
    counts = [0] * plan.points
    for chunk in range(plan.chunks):
        for t in range(plan.threads):
            for p in plan.thread_points(chunk, t):
                counts[p] += 1
    return counts


@pytest.mark.parametrize("blp", SAMPLER_PLANS, ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_glimpse_sample_plan_covers_each_point_once(blp, aligned):
    b, levels, p = blp
    plan = gs.glimpse_sample_plan(b, levels, p, aligned)
    assert plan.grid == (b, levels, plan.chunks)          # one block per window chunk
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= gs.MAX_THREADS
    assert plan.points_per_thread == gs.POINTS_PER_THREAD == 4
    per_block = plan.points_per_thread * plan.threads
    assert plan.chunks * per_block >= p > (plan.chunks - 1) * per_block   # no chunk empty
    assert _covered(plan) == [1] * p                      # each (b, l, p) exactly once
    assert plan.route == ("vec16" if aligned and p % 4 == 0 else "scalar")


@pytest.mark.parametrize("bp", [(b, p) for b, _, p in SAMPLER_PLANS], ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_hat_sample_plan_covers_each_point_once(bp, aligned):
    b, p = bp
    plan = gs.hat_sample_plan(b, p, aligned)
    assert plan.grid == (b, 1, plan.chunks)
    assert _covered(plan) == [1] * p
    assert plan.route == ("vec16" if aligned and p % 4 == 0 else "scalar")


def test_glimpse_sample_main_path_plan():
    """B=128, L=4, P=900: four blocks of 64 threads a window, 2,048 blocks
    in all, each thread four consecutive points read and written 16 bytes at
    a time; the last block of a window has 33 busy threads."""
    plan = gs.glimpse_sample_plan(128, 4, 900)
    assert (plan.route, plan.gather) == ("vec16", "pairs")
    assert plan.threads == 64 and plan.chunks == 4 and plan.grid == (128, 4, 4)
    for chunk in range(4):
        busy = [t for t in range(64) if plan.thread_points(chunk, t)]
        assert len(busy) == (64 if chunk < 3 else 33)
        assert all(plan.thread_points(chunk, t) == [256 * chunk + 4 * t + i for i in range(4)]
                   for t in busy)
    scalar = gs.glimpse_sample_plan(128, 4, 900, aligned=False)
    assert scalar.thread_points(0, 5) == [5, 5 + scalar.threads, 5 + 2 * scalar.threads,
                                          5 + 3 * scalar.threads]


def test_sampler_plan_rejects_empty_plans():
    with pytest.raises(ValueError, match="empty"):
        gs.glimpse_sample_plan(0, 4, 900)
    with pytest.raises(ValueError, match="empty"):
        gs.hat_sample_plan(2, 0)
