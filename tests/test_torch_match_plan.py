"""The launch plan of the best-match kernel (``vidtome_torch.ops.matching.
match_plan``) and the wrapper's checks (``check_operands``), on the CPU: the
kernel runs only on the card (``tests/test_torch_kernels.py``), so its
block rows, grids and shared-memory budgets at chip_smoke.py's rows and at
edge shapes, that every src row is covered once, and what a launch refuses
are pinned here."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from vidtome_torch.ops import matching as t_match

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132
SMEM_BLOCK = 232_448  # bytes a block may take on Hopper
SOURCE = (ROOT / "vidtome_torch" / "csrc" / "matching.cu").read_text()

# (rows a block, src tile resident, grid) at chip_smoke.py's phase-3 rows:
# the level-0 round in one wave of 192-row blocks, the level-1 round in 96
# blocks of 64 (under a wave: more SMs busy), the level-0 global merge in
# 74 blocks of 128 (as busy as 148 of 64, fewer L2 reads of dst), the
# level-1 one in 38 of 64
PHASE3 = {
    (2, 12288, 4096, 320): (192, True, (64, 2)),
    (2, 3072, 1024, 640): (64, True, (48, 2)),
    (2, 4711, 4711, 320): (128, True, (37, 2)),
    (2, 1178, 1178, 640): (64, True, (19, 2)),
}
EDGES = [
    (1, 1, 1, 8), (1, 1, 5000, 8), (3, 5000, 1, 8), (1, 64, 64, 1728),
    (1, 200, 300, 1728), (2, 12288, 300, 1728), (2, 300, 211, 40),
    (4, 777, 129, 648), (1, 130, 1000, 1280), (8, 4096, 4096, 1344),
    (2, 6144, 6144, 640), (3, 65, 64, 704),
]


def _shapes():
    return sorted(PHASE3) + EDGES


def test_phase3_rows_are_the_pinned_ones():
    shapes = [chip_smoke.match_shape(s) for s in chip_smoke.MATCH_SHAPES]
    assert set(shapes) == set(PHASE3)


@pytest.mark.parametrize("shape", sorted(PHASE3))
def test_plan_at_phase3_rows(shape):
    plan = t_match.match_plan(*shape, SMS)
    assert (plan.rows, plan.resident, plan.grid) == PHASE3[shape]


@pytest.mark.parametrize("shape", sorted(PHASE3))
def test_plan_takes_the_least_busy_sm(shape):
    """No other block height leaves the busiest SM fewer src rows."""
    B, S, D, C = shape
    plan = t_match.match_plan(*shape, SMS)

    def busiest(rows):
        return -(-(-(-S // rows) * B) // SMS) * rows
    assert all(busiest(plan.rows) <= busiest(r) for r in (64, 128, 192))


@pytest.mark.parametrize("shape", _shapes())
def test_plan_covers_every_src_row_once(shape):
    B, S, D, C = shape
    plan = t_match.match_plan(*shape, SMS)
    tiles, batch = plan.grid
    assert batch == B and plan.rows in (64, 128, 192)
    assert tiles * plan.rows >= S > (tiles - 1) * plan.rows


@pytest.mark.parametrize("shape", _shapes())
def test_plan_fits_shared_memory(shape):
    B, S, D, C = shape
    plan = t_match.match_plan(*shape, SMS)
    assert plan.smem <= SMEM_BLOCK
    atoms = -(-C // 64)
    src_tile = atoms * plan.rows * 128
    if plan.resident:  # the whole src tile, the ring of 4 dst boxes
        assert plan.smem == src_tile + 4 * 128 * 128 + 8 * 9 + 1024
    else:  # each stage a dst box and a src box; resident would not fit
        assert plan.smem == 4 * (128 + plan.rows) * 128 + 8 * 9 + 1024
        assert src_tile + 4 * 128 * 128 + 8 * 9 + 1024 > SMEM_BLOCK


@pytest.mark.parametrize("C,rows,resident", [
    (320, 192, True), (384, 192, True), (448, 128, True), (640, 128, True),
    (704, 64, True), (1280, 64, True), (1344, 192, False),
    (1728, 192, False)])
def test_src_tile_resident_where_it_fits(C, rows, resident):
    """The largest block height that keeps the src tile resident (where
    none does, the largest), at a shape where every height leaves the
    busiest SM the same rows (S = 384 rows an SM)."""
    plan = t_match.match_plan(1, 384 * SMS, 1000, C, SMS)
    assert (plan.rows, plan.resident) == (rows, resident)


def test_plan_constants_match_the_source():
    """The planner's ring, boxes and limits are those of csrc/matching.cu."""
    const = dict(re.findall(r"constexpr (?:int|uint32_t) (k\w+) = ([^;]+);",
                            SOURCE))
    assert int(const["kStages"]) == t_match._STAGES
    assert int(const["kBD"]) * 128 == t_match._DST_BOX
    assert int(const["kMaxC"]) == t_match.MAX_C
    assert int(const["kSmemMax"]) == t_match.SMEM_MAX
    for rows in (64, 128, 192):
        for res in (1, 0):
            assert f"case {rows} * 2{' + 1' if res else ''}: return " \
                   f"launch<{rows // 64}, {'true' if res else 'false'}>" \
                   in SOURCE


def test_source_scores_with_wgmma_fed_by_tma():
    code = "\n".join(ln.split("//")[0] for ln in SOURCE.splitlines())
    assert "mma.sync" not in code and "mma_16816" not in code
    assert "load_tile" not in code
    assert "wgmma_ss(" in code and "tma_load(" in code
    assert "mbar_wait(empty" in code


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("src,dst,error", [
    ((2, 64, 32), (2, 64, 32), None),
    ((2, 300, 40), (2, 211, 40), None),
    ((2, 64, 36), (2, 64, 36), ValueError),       # C not a multiple of 8
    ((1, 64, 1736), (1, 64, 1736), ValueError),   # C past 1728
    ((1, 0, 32), (1, 64, 32), ValueError),        # no src row
    ((1, 64, 32), (1, 0, 32), ValueError),        # no dst row
    ((2, 64, 32), (1, 64, 32), ValueError),       # batch mismatch
    ((1, 64, 32), (1, 64, 40), ValueError),       # width mismatch
    ((64, 32), (64, 32), ValueError),             # not [B, S, C]
])
def test_launch_refuses_shapes_outside_the_contract(src, dst, error):
    if error is None:
        t_match.check_operands(_bf16(*src), _bf16(*dst))
        return
    with pytest.raises(error):
        t_match.check_operands(_bf16(*src), _bf16(*dst))


def test_launch_refuses_fp32_views_and_unaligned_bases():
    x = torch.zeros(1, 64, 32)
    with pytest.raises(TypeError, match="bf16"):
        t_match.check_operands(x, x)
    wide = _bf16(1, 64, 48)
    with pytest.raises(ValueError, match="contiguous"):
        t_match.check_operands(wide[:, :, :40], wide[:, :, :40])
    flat = _bf16(8 + 64 * 32)
    shifted = flat[4:4 + 64 * 32].view(1, 64, 32)  # 8 bytes past 16
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16"):
        t_match.check_operands(shifted, shifted)


def test_cpu_tensors_take_the_plain_version():
    src = torch.randn(2, 70, 24).bfloat16()
    dst = torch.randn(2, 50, 24).bfloat16()
    before = t_match.best_match.launches
    got = t_match.best_match(src, dst)
    want = t_match.reference_best_match(src, dst)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert t_match.best_match.launches == before
