"""The fused sublayer kernel's launch, on the CPU: the planner
(``vidtome_torch.ops.sublayer.plan``), the shared memory it lays out, the
TMA views the kernel reads (``tensor_maps``) and the cached scaled Wq.

The kernel needs the card; what it is told comes from here.  A plan splits
a 64-row tile by whole heads over a cluster of at most 8 blocks of at most
320 columns each; every (row, column) of the output is owned by one
block; a block's shared memory stays within 232,448 bytes.  The views are
held against torch's own strided views of the same storage, so the byte
strides address what the kernel means to read.
"""

from __future__ import annotations

import math

import pytest
import torch

from vidtome_torch.ops import sublayer as t_sub

# (B, S, C, heads): SD2.1 PnP generation (phase 3 of chip_smoke.py), SD1.5
# at batch 8 (8 heads: D = 40, 80, 160), and the tests' widths
SD21 = [(12, 4096, 320, 5), (12, 1024, 640, 10), (12, 256, 1280, 20),
        (12, 64, 1280, 20)]
SD15 = [(8, 4096, 320, 8), (8, 1024, 640, 8), (8, 256, 1280, 8),
        (8, 64, 1280, 8)]
TEST_WIDTHS = [(2, S, C, heads) for S in (1, 100)
               for C, heads in ((64, 4), (128, 2), (160, 4), (640, 8))]
# SDXL (D = 64: 10 and 20 heads) under PnP (batch 12) and CFG (batch 8),
# its refiner as configured here (D = 96: 8 and 16 heads) and the
# refiner's widths at D = 64 (12 and 24 heads)
SDXL = [(12, 4096, 640, 10), (12, 1024, 1280, 20), (8, 4096, 640, 10),
        (8, 1024, 1280, 20), (8, 4096, 768, 8), (8, 1024, 1536, 16),
        (8, 256, 1536, 16), (8, 4096, 768, 12), (8, 1024, 1536, 24),
        (8, 256, 1536, 24)]
ROWS = SD21 + SD15 + TEST_WIDTHS + SDXL


def test_plan_sd21_rows():
    """One, two and four blocks a cluster at C = 320, 640, 1280: 768, 384,
    192 and 48 blocks, five heads of 64 a rank."""
    plans = [t_sub.plan(B, S, C, h, 77, 77) for B, S, C, h in SD21]
    assert [p.cluster for p in plans] == [1, 2, 4, 4]
    assert [p.grid[0] * p.grid[1] for p in plans] == [768, 384, 192, 48]
    for p in plans:
        assert (p.width, p.heads_rank, p.head_dim, p.kvp) == (320, 5, 64, 80)


@pytest.mark.parametrize("C,heads,cluster,heads_rank", [
    (640, 10, 2, 5), (1280, 20, 4, 5), (768, 12, 4, 3), (1536, 24, 8, 3),
    (768, 8, 4, 2), (1536, 16, 8, 2)])
def test_plan_takes_sdxl_and_refiner_widths(C, heads, cluster, heads_rank):
    """Every SDXL and refiner width at 77 keys: 12 and 24 heads of 64 split
    into three a rank (clusters of 1, 2, 4 or 8 cannot split them into two
    or five), the refiner's 8 and 16 heads of 96 into two."""
    for B, S in ((4, 4096), (8, 1024), (12, 256)):
        p = t_sub.plan(B, S, C, heads, 77, 77)
        assert (p.cluster, p.heads_rank, p.head_dim) == (
            cluster, heads_rank, C // heads)
        assert p.smem <= t_sub.SMEM_LIMIT and p.kvp == 80


@pytest.mark.parametrize("B,S,C,heads", ROWS)
def test_plan_owns_every_row_and_column_once(B, S, C, heads):
    p = t_sub.plan(B, S, C, heads, 77, 77)
    inst = p.instance
    D = C // heads
    assert p.cluster in t_sub.CLUSTERS and p.cluster <= 8
    assert p.C == C and p.width * p.cluster == C
    assert p.width <= t_sub.MAX_WIDTH and p.width % inst.KCH == 0
    assert inst.KCH == t_sub.CHUNKS.get((D, p.heads_rank), 64)
    # whole heads a rank, split between the two consumers
    assert p.head_dim == D and p.heads_rank * D == p.width
    assert inst.HW0 + inst.HW1 == p.heads_rank and inst.HW0 >= inst.HW1
    assert (D, p.heads_rank) in t_sub.INSTANCES
    # each column by one rank, each row by one tile
    owner = torch.zeros(C, dtype=torch.int64)
    for r in range(p.cluster):
        owner[r * p.width:(r + 1) * p.width] += 1
    assert torch.equal(owner, torch.ones(C, dtype=torch.int64))
    tiles = p.grid[0] // p.cluster
    assert p.grid == (tiles * p.cluster, B)
    assert (tiles - 1) * t_sub.ROWS < S <= tiles * t_sub.ROWS
    # the out projection's columns of the two consumers cover the rank's
    assert 2 * inst.NO == p.width and inst.NO % 16 == 0


@pytest.mark.parametrize("B,S,C,heads", ROWS)
@pytest.mark.parametrize("skv", [16, 77, 128])
def test_plan_shared_memory_fits(B, S, C, heads, skv):
    p = t_sub.plan(B, S, C, heads, skv, skv)
    inst = p.instance
    lay = t_sub.layout(inst, p.cluster, p.stages, p.kv_bufs)
    assert p.smem == lay.total <= t_sub.SMEM_LIMIT
    assert 2 <= p.stages <= t_sub.MAX_STAGES and p.kv_bufs in (1, 2)
    assert p.kvp == (80 if skv <= 80 else 128) == inst.KVP
    # the slice, the ring, the K / V buffers, the partials, in order and on
    # the swizzle span
    assert lay.ring == p.width * 128
    assert lay.kv == lay.ring + p.stages * lay.stage
    assert lay.stage % 1024 == 0 and lay.kv_head % 1024 == 0
    assert lay.stage >= lay.a_bytes + 2 * inst.KCH * max(
        inst.NQ0 + inst.NQ1, 2 * inst.NO)
    assert lay.a_bytes == (inst.KCH * 128 if p.cluster > 1 else 0)
    assert lay.kv_head == 2 * inst.NA * inst.KVP * inst.SW
    # x and a1 staged over the K / V buffers (twice); the epilogue's fp32
    # tile over the slice and the ring
    assert lay.part - lay.kv >= 2 * p.width * 128
    assert lay.part - lay.kv >= (2 if inst.HW1 else 1) * p.kv_bufs * \
        lay.kv_head
    assert 64 * (p.width + 8) * 4 <= lay.kv


def test_plan_counts_waves():
    """The cluster size follows the clusters the card holds at once: at
    SD1.5's level 0, one block a cluster fills 132 SMs in 4 waves where
    two-block clusters take 8 (66 at once); where the card held many more
    of two, the halved blocks win."""
    assert t_sub.plan(8, 4096, 320, 8, 77, 77).cluster == 1
    roomy = t_sub.plan(8, 4096, 320, 8, 77, 77,
                       clusters=lambda D, HR, kvp, n, smem:
                       132 if n == 1 else 512)
    assert roomy.cluster == 2 and roomy.heads_rank == 4
    none = lambda D, HR, kvp, n, smem: 0  # noqa: E731
    with pytest.raises(ValueError):
        t_sub.plan(8, 4096, 320, 8, 77, 77, clusters=none)


def test_plan_raises_where_no_instance_takes_the_row():
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 5120, 80, 77, 77)   # 640 columns a rank at least
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 320, 3, 77, 77)     # heads do not split C
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 300, 5, 77, 77)     # D = 60, not a multiple of 8
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 320, 5, 129, 129)   # past 128 keys
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 320, 5, 77, 78)     # kv_len past the keys
    with pytest.raises(ValueError):
        t_sub.plan(1, 64, 96, 2, 77, 77)      # D = 48: no instance


def _view(t: torch.Tensor, m: t_sub.TensorMap) -> torch.Tensor:
    """torch's view of t's storage through the map's dims and byte strides
    (of bf16 elements), outermost first: t holds each element's index."""
    strides = [s // 2 for s in reversed(m.strides)] + [1]
    return t.as_strided(list(reversed(m.dims)), strides)


@pytest.mark.parametrize("B,S,C,heads", SD21[1:2] + SD15[:3] + TEST_WIDTHS)
def test_tensor_maps_address_the_views(B, S, C, heads):
    skv, kv_len = 80, 77
    p = t_sub.plan(B, S, C, heads, skv, kv_len)
    inst = p.instance
    D = C // heads
    wq0, wq1, wout, k, v, scratch, x, a1 = t_sub.tensor_maps(p, skv)
    for m in (wq0, wq1, wout, k, v, scratch, x):
        assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in m.strides)
        assert all(0 < b <= 256 for b in m.box)
        # one swizzle row a box row, or unswizzled rows of whole 16 bytes
        assert m.box[0] * 2 == m.swizzle or (m.swizzle == 0
                                             and m.box[0] * 2 % 16 == 0)
    # Wq [C, C] as [heads, D, C]: consumer 0's heads, then consumer 1's;
    # a box's DP rows reach past D only into TMA's zero fill
    w = torch.arange(C * C, dtype=torch.float32).reshape(C, C)
    assert wq0.dims == (C, D, heads, 1) and wq1.dims == wq0.dims
    assert torch.equal(_view(w, wq0)[0], w.view(heads, D, C))
    assert wq0.box == (inst.KCH, inst.DP, inst.HW0, 1)
    assert wq1.box == (inst.KCH, inst.DP, max(inst.HW1, 1), 1)
    assert inst.DP - D == (8 if D % 16 else 0)
    assert wq0.box[1] * wq0.box[2] == inst.NQ0
    # Wout [C, C]: a consumer's NO output rows
    assert torch.equal(_view(w, wout)[0, 0], w)
    assert wout.box == (inst.KCH, inst.NO, 1, 1)
    # K, V [B, Skv, C] as [B, heads, kv_len, D]: keys past kv_len and
    # columns past D read as zeros (the box reaches kvp rows, an atom)
    kt = torch.arange(B * skv * C, dtype=torch.float32).reshape(B, skv, C)
    assert k.dims == (D, kv_len, heads, B) and v == k
    want = kt.view(B, skv, heads, D)[:, :kv_len].transpose(1, 2)
    assert torch.equal(_view(kt, k), want)
    assert k.box == (inst.COLS, p.kvp, 1, 1) and inst.NA * inst.COLS >= D
    assert k.swizzle == (128 if inst.DP <= 64 else 64)
    # the scratch [2, B, S, C] as [B, 2, S, C]: 64-row, 32-column chunks
    st = torch.arange(2 * B * S * C, dtype=torch.float32).reshape(2, B, S, C)
    assert scratch.dims == (C, S, 2, B) and scratch.box == (32, 64, 1, 1)
    assert torch.equal(_view(st, scratch), st.transpose(0, 1))
    # x, a1 [B, S, C] as [B, 1, S, C]: two boxes of half the rank's columns
    xt = torch.arange(B * S * C, dtype=torch.float32).reshape(B, S, C)
    assert x == a1 and x.dims == (C, S, 1, B) and x.swizzle == 0
    assert x.box == (p.width // 2, 64, 1, 1)
    assert torch.equal(_view(xt, x)[:, 0], xt)


def test_tensor_maps_sd15_level0_zero_fills_the_padded_head():
    """D = 40: q's 48 columns a head come from 48-row boxes of the 40-row
    [heads, D, C] view (8 rows of zeros); K's atom is 64 columns over 40."""
    p = t_sub.plan(8, 4096, 320, 8, 77, 77)
    wq0, _, _, k, _, _, _, _ = t_sub.tensor_maps(p, 77)
    assert (p.cluster, p.head_dim, p.instance.DP) == (1, 40, 48)
    assert wq0.dims[1] == 40 and wq0.box[1] == 48
    assert k.dims[0] == 40 and k.box[0] == 64 and k.swizzle == 128


def test_scaled_wq_is_cached_and_rebuilt_on_edit():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(320, 320, generator=g).bfloat16()
    first = t_sub.scaled_wq(w, 5)
    want = t_sub._scaled_wq(w, 5, torch.bfloat16)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first.view(torch.int16), want.view(torch.int16))
    assert t_sub.scaled_wq(w, 5) is first  # no work on the second call
    with torch.no_grad():
        w.mul_(2)  # an in-place edit: a new version
    second = t_sub.scaled_wq(w, 5)
    assert second is not first
    assert torch.equal(second, t_sub._scaled_wq(w, 5, torch.bfloat16))
    assert torch.equal(second.float(), (first.float() * 2))
    # another head count, another scale
    eight = t_sub.scaled_wq(w, 8)
    assert torch.equal(eight, t_sub._scaled_wq(w, 8, torch.bfloat16))
    assert not torch.equal(eight, second)
    # a parameter's .data replaced: rebuilt
    p = torch.nn.Parameter(w.clone())
    a = t_sub.scaled_wq(p, 5)
    p.data = p.data * 0.5
    b = t_sub.scaled_wq(p, 5)
    assert torch.equal(b, t_sub._scaled_wq(p, 5, torch.bfloat16))
    assert not torch.equal(a, b)
    scale = math.log2(math.e) / math.sqrt(64)
    assert torch.equal(b, (p.float() * scale).bfloat16())
