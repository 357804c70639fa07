"""The launch plans of the port's statistic kernels, held on the CPU.

``conv1x1_plan`` (B3, ``ops/conv1x1_stats.py``) and ``stat_sums_plan``
(B2, ``ops/stat_sums.py``) are pure Python: they choose the tiles, the ring,
the grid and the static schedule that the CUDA kernels then check and
follow. The kernels themselves run only on the card (``chip_smoke.py``);
here the plans are held at the shapes the main path gives them, on an
H100's 132 SMs.
"""

import pytest

from chip_smoke import resnet50_fused_shapes
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs
from multimodal_active_ai_tpu_torch.ops import stat_sums as ss

SMS = 132
B2_B128, B3_B128 = resnet50_fused_shapes(128)
B2_B1, B3_B1 = resnet50_fused_shapes(1)
TAILS = [(96, 24, 40), (64, 16, 64), (100, 12, 7), (1000, 64, 200)]
B3_SHAPES = sorted(B3_B128) + sorted(B3_B1) + TAILS
WGMMA_SHAPES = [(m, k, n) for m, k, n in B3_SHAPES if k % 8 == 0 and n % 8 == 0]
B2_SHAPES = sorted(B2_B128) + sorted(B2_B1) + [(40, 24), (1001, 64), (333, 3), (7, 64)]


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
