"""The launch plans of the bf16 and W8A8 fused-resnet conv kernels
(``vidtome_torch.ops.resnet.conv_plan``, ``conv_plan_w8a8``), the TMA
views of their packed weights (``weight_map``) and the weight packing of
``ResnetBlock2D`` and the int8 tables, on the CPU: the kernels themselves
run only on the card (``tests/test_torch_kernels.py``), so their grids,
tiles and shared-memory budgets at chip_smoke.py's rows and at SD1.5's
block shapes, the bytes TMA reads each weight tile from, and that no call
repacks the weights are pinned here."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from vidtome_torch.models.layers import ResnetBlock2D
from vidtome_torch.ops import groupnorm as t_gn
from vidtome_torch.ops import resnet as t_res
from vidtome_torch.ops.quant import packed_conv_weight, quantize_unet

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132
SMEM_BLOCK = 232_448   # bytes a block may take on Hopper
SMEM_SM = 233_472      # an SM's shared memory, 1 KB of it reserved a block
# (tile_h, block_n) at each of chip_smoke.py's rows
PHASE3 = {
    (8, 64, 64, 320, 320): (16, 160),
    (8, 32, 32, 640, 640): (16, 160),
    (8, 64, 64, 640, 320): (16, 160),
    (8, 16, 16, 2560, 1280): (8, 160),
    (4, 64, 64, 960, 320): (16, 160),
    (8, 8, 8, 1280, 1280): (8, 64),
}
# the ResnetBlock2D convolutions of SD1.5 at batch 8 (conv1 Ci -> Co and
# conv2 Co -> Co of every block, down, mid and up)
SD15 = sorted({(8, s, s, ci, co) for s, ci, co in [
    (64, 320, 320), (32, 320, 640), (32, 640, 640), (16, 640, 1280),
    (16, 1280, 1280), (8, 1280, 1280), (8, 2560, 1280), (16, 2560, 1280),
    (16, 1920, 1280), (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
    (64, 960, 320), (64, 640, 320)] for ci in (ci, co)})

# the ResnetBlock2D shapes of chip_smoke.py's int8 SDXL phase (meta_rows'
# " int8" kinds: an SDXL call at batch 4 and 8, a refiner call at batch 8),
# which phase 3 runs both variants at, (B, H, W, Ci, Co): the refiner's
# 384 / 768 / 1536 output channels are no multiple of 160 or 320, its
# groups 12, 24 or 48 channels wide
SDXL = sorted({(B, s, s, ci, co) for B in (4, 8) for s, ci, co in [
    (128, 320, 320), (128, 640, 320), (128, 960, 320), (64, 320, 640),
    (64, 640, 640), (64, 960, 640), (64, 1280, 640), (64, 1920, 640),
    (32, 640, 1280), (32, 1280, 1280), (32, 1920, 1280), (32, 2560, 1280)]}
              | {(8, s, s, ci, co) for s, ci, co in [
                  (128, 384, 384), (128, 768, 384), (128, 1152, 384),
                  (64, 384, 768), (64, 768, 768), (64, 1152, 768),
                  (64, 1536, 768), (64, 2304, 768), (32, 768, 1536),
                  (32, 1536, 1536), (32, 2304, 1536), (32, 3072, 1536),
                  (16, 1536, 1536), (16, 3072, 1536)]})


def test_phase3_rows_are_the_pinned_ones():
    assert set(PHASE3) == set(chip_smoke.RESNET_SHAPES)


@pytest.mark.parametrize("shape", sorted(PHASE3))
def test_plan_at_phase3_rows(shape):
    B, H, W, Ci, Co = shape
    plan = t_res.conv_plan(*shape)
    assert (plan.tile_h, plan.block_n) == PHASE3[shape]
    # one wave of the card at least, at every row
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= SMS
    # one activated halo for 160 output channels wherever that fills a wave
    if Co >= 128:
        tiles = -(-H // 8) * -(-W // 8)
        assert plan.block_n == 160 or tiles * -(-Co // 160) * B < SMS


@pytest.mark.parametrize("shape", SD15)
def test_plan_at_sd15_blocks(shape):
    B, H, W, Ci, Co = shape
    plan = t_res.conv_plan(*shape)
    th, tw, wgs, bn = plan.tile_h, plan.tile_w, plan.warpgroups, plan.block_n
    assert tw == 8 and th == 8 * wgs and bn in (160, 64)
    assert plan.tiles == -(-H // th) * -(-W // tw)
    assert plan.grid == (plan.tiles, -(-Co // bn), B)
    # no tile's first row of tiles half empty: a whole image at 8x8
    assert th == 8 or th < 2 * H
    assert plan.arg == wgs | bn << 8
    # the shared memory the C dispatch takes: the weight ring, three halo
    # buffers of 8 planes of 16-byte pixel rows (an odd number of them),
    # the ring's barriers and the alignment slack
    stages = 3 if wgs == 1 and bn > 64 else 4
    halo = ((th + 2) * 10) | 1
    assert plan.smem == stages * bn * 128 + 3 * 8 * halo * 16 + 16 * stages \
        + 1024
    assert plan.smem <= SMEM_BLOCK
    if wgs == 1:  # two blocks of one warpgroup share an SM
        assert 2 * (plan.smem + 1024) <= SMEM_SM


def test_sdxl_rows_are_the_pinned_ones():
    assert set(chip_smoke.meta_rows(" int8")["fused_resnet"]) == set(SDXL)


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("shape", SDXL)
def test_plan_at_sdxl_blocks(shape, w8a8):
    """Both convolutions of every SDXL and refiner block: the grid covers
    the output channels (the last block ragged at 384, 768 and 1536), fills
    a wave, and fits a block's shared memory; the channels meet the
    wrappers' alignment and split into the 32 groups."""
    B, H, W, Ci, Co = shape
    make = t_res.conv_plan_w8a8 if w8a8 else t_res.conv_plan
    assert Ci % 32 == 0 and Co % 32 == 0  # the W8A8 wrapper's rule
    for cin in (Ci, Co):
        plan = make(B, H, W, cin, Co)
        assert plan.grid == (plan.tiles, -(-Co // plan.block_n), B)
        assert plan.tiles == -(-H // plan.tile_h) * -(-W // plan.tile_w)
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= SMS
        assert plan.smem <= SMEM_BLOCK
        assert plan.block_n * (plan.grid[1] - 1) < Co


@pytest.mark.parametrize("B,H,W,Ci,Co,want", [
    (1, 13, 21, 64, 64, (8, 64)),     # small grid: the most blocks
    (2, 8, 8, 96, 32, (8, 64)),       # 8x8: never the 16-high tile
    (4, 64, 64, 320, 320, (16, 160)),  # cfg-skip batch at level 0
])
def test_plan_at_small_and_odd_shapes(B, H, W, Ci, Co, want):
    plan = t_res.conv_plan(B, H, W, Ci, Co)
    assert (plan.tile_h, plan.block_n) == want


def test_plan_follows_the_sm_count():
    # on a card of 64 SMs the 16x16 level fills a wave with the 16x8 tile
    assert t_res.conv_plan(8, 16, 16, 2560, 1280, sms=132).tile_h == 8
    assert t_res.conv_plan(8, 16, 16, 2560, 1280, sms=64).tile_h == 16


@pytest.mark.parametrize("Ci,Co,bn", [(320, 320, 160), (96, 224, 64),
                                      (40, 96, 64), (2560, 1280, 160)])
def test_weight_map_reads_the_packed_storage(Ci, Co, bn):
    dims, strides, box = t_res.weight_map(Ci, Co, bn)
    assert dims == (Ci, 9, Co, 1)
    assert box == (64, 1, bn, 1)
    # TMA's rules: byte strides multiples of 16, 128 bytes a swizzled row
    assert all(s % 16 == 0 for s in strides) and box[0] * 2 == 128
    # the strides are those of the OIHW view of packed [O, 3, 3, I]
    # storage, tap by tap: element (c, tap, o) of the map is w[o, c, tap]
    w = torch.zeros(Co, Ci, 3, 3, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    so, sc, sy, sx = w.stride()
    assert sc == 1 and sy == 3 * sx
    assert strides == (2 * sx, 2 * so, 2 * so * Co)


def test_resnet_block_keeps_packed_conv_weights():
    block = ResnetBlock2D(32, 64, 16)
    for dtype in (torch.bfloat16, torch.float32):
        block = block.to(dtype)
        for conv in (block.conv1, block.conv2):
            w = conv.weight
            assert w.dtype == dtype
            assert w.is_contiguous(memory_format=torch.channels_last)
            # the [O, 3, 3, I] view is free: no copy
            assert packed_conv_weight(w).data_ptr() == w.data_ptr()


def test_launch_hands_the_module_weights_to_the_c_entry(monkeypatch):
    """``_launch`` gives the C entry the module's own weight storage (no
    per-call repack) and the plan's tile argument; the C entry, the
    stream and the GroupNorm statistics passes are stood in for here."""
    torch.manual_seed(0)
    B, H, W, Ci, Co = 2, 16, 16, 64, 96
    block = ResnetBlock2D(Ci, Co, 16).to(torch.bfloat16)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    def stats(x, groups, eps):
        s = x.float().reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
        return s.mean(dim=(1, 3)), s.var(dim=(1, 3)).add(eps).rsqrt()

    monkeypatch.setattr(t_res, "_library", lambda: (entry, None))
    monkeypatch.setattr(t_res, "_stream", lambda x: 0)
    monkeypatch.setattr(t_res, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(t_gn, "group_stats", stats)
    monkeypatch.setattr(
        t_gn, "stats_from_partials",
        lambda s, q, groups, count, eps: (torch.zeros(B, groups),
                                          torch.ones(B, groups)))
    x = torch.randn(B, H, W, Ci).bfloat16()
    tvec = torch.randn(B, Co)
    n1, n2, sc = block.norm1, block.norm2, block.conv_shortcut
    out = t_res._launch(x, tvec, n1.weight, n1.bias, block.conv1.weight,
                        block.conv1.bias, n2.weight, n2.bias,
                        block.conv2.weight, block.conv2.bias,
                        sc.weight[:, :, 0, 0], sc.bias, n1.num_groups,
                        n2.num_groups, n1.eps)
    assert out.shape == (B, H, W, Co)
    assert len(calls) == 2
    for args, conv, cin in ((calls[0], block.conv1, Ci),
                            (calls[1], block.conv2, Co)):
        assert args[5] == conv.weight.data_ptr()
        assert args[12:18] == (B, H, W, cin, Co, 32)
        assert args[18] == t_res.conv_plan(B, H, W, cin, Co).arg
    # conv1 writes the GN2 partials, conv2 takes the shortcut
    assert calls[0][10] is not None and calls[0][8] is None
    assert calls[1][10] is None and calls[1][8] is not None


def _check_w8a8_plan(plan, shape):
    """The W8A8 plan's fields against each other and the card's limits."""
    B, H, W, Ci, Co = shape
    assert (plan.tile_h, plan.tile_w) == (8, 8)
    assert (plan.warpgroups, plan.block_n) in t_res._W8A8_TILES
    assert plan.tiles == -(-H // 8) * -(-W // 8)
    assert plan.grid == (plan.tiles, -(-Co // plan.block_n), B)
    assert plan.arg == plan.warpgroups | plan.block_n << 8
    # the C dispatch's shared memory: a ring of 4 stages of block_n rows of
    # 128 bytes, three 10 x 10 halo buffers of 8 planes of 16-byte pixel
    # rows (101 of them), the barriers and the alignment slack
    assert plan.smem == 4 * plan.block_n * 128 + 3 * 8 * 101 * 16 + 64 + 1024
    assert plan.smem <= SMEM_BLOCK
    # the kernel hands the producer's registers to the consumers
    # (setmaxnreg) only where the block holds its SM alone
    if plan.warpgroups == 2:
        assert 2 * (plan.smem + 1024) > SMEM_SM


def test_w8a8_phase3_rows_are_the_pinned_ones():
    assert set(chip_smoke.RESNET_SHAPES) == set(PHASE3)


@pytest.mark.parametrize("shape", sorted(PHASE3))
def test_w8a8_plan_at_phase3_rows(shape):
    # one 10 x 10 halo for 320 output channels at every row, conv1 and
    # conv2: the activation, not the products, bounds the kernel
    B, H, W, Ci, Co = shape
    for cin in (Ci, Co):
        plan = t_res.conv_plan_w8a8(B, H, W, cin, Co)
        _check_w8a8_plan(plan, (B, H, W, cin, Co))
        assert (plan.warpgroups, plan.block_n) == (2, 320)


@pytest.mark.parametrize("shape", SD15)
def test_w8a8_plan_at_sd15_blocks(shape):
    plan = t_res.conv_plan_w8a8(*shape)
    _check_w8a8_plan(plan, shape)
    assert plan.block_n == 320  # SD's widths are multiples of 320


@pytest.mark.parametrize("B,H,W,Ci,Co,want", [
    (3, 16, 24, 96, 224, (1, 64)),    # small grid: 18 blocks at 320
    (2, 8, 8, 64, 32, (1, 64)),       # Co under one warpgroup's 160
    (1, 13, 21, 64, 64, (1, 64)),
    (8, 8, 8, 1280, 1280, (2, 320)),  # 32 blocks, each SM's share at most
    (4, 64, 64, 960, 320, (2, 320)),  # cfg-skip batch at level 0
])
def test_w8a8_plan_at_small_and_odd_shapes(B, H, W, Ci, Co, want):
    plan = t_res.conv_plan_w8a8(B, H, W, Ci, Co)
    assert (plan.warpgroups, plan.block_n) == want


def test_w8a8_plan_follows_the_sm_count():
    # 18 blocks at 320 against 72 at 64: on a card of 8 SMs 320 is cheaper
    assert t_res.conv_plan_w8a8(3, 16, 24, 96, 224, sms=132).block_n == 64
    assert t_res.conv_plan_w8a8(3, 16, 24, 96, 224, sms=8).block_n == 320


def _tma_box(storage: np.ndarray, dims, strides, box, coords, elem: int):
    """What a TMA load of ``box`` at ``coords`` reads from the bytes
    ``storage`` through a map of ``dims`` and byte ``strides`` (elements of
    ``elem`` bytes; coordinates past a dim read zeros), as [box[2], box[0]]
    elements of the box's two non-unit dims."""
    i0 = coords[0] + np.arange(box[0])
    i2 = coords[2] + np.arange(box[2])
    inside = (i2[:, None] < dims[2]) & (i0[None, :] < dims[0])
    off = (i0[None, :] * elem + coords[1] * strides[0]
           + i2[:, None] * strides[1] + coords[3] * strides[2])
    out = np.zeros((box[2], box[0], elem), np.uint8)
    for k in range(elem):
        out[..., k][inside] = storage[off[inside] + k]
    return out


@pytest.mark.parametrize("Ci,Co,bn", [(320, 320, 160), (96, 224, 64),
                                      (960, 64, 64), (256, 160, 160)])
def test_w8a8_weight_map_reads_the_packed_int8_storage(Ci, Co, bn):
    dims, strides, box = t_res.weight_map(Ci, Co, bn, w8a8=True)
    assert dims == (Ci, 9, Co, 1)
    assert box == (128, 1, bn, 1)
    # TMA's rules: byte strides multiples of 16, 128 bytes a swizzled row
    assert all(s % 16 == 0 for s in strides) and box[0] == 128
    # the int8 table's weight: an OIHW view of packed [O, 3, 3, I] storage
    torch.manual_seed(Ci + Co)
    conv = torch.nn.Conv2d(Ci, Co, 3, padding=1)
    table = quantize_unet(torch.nn.ModuleDict({"conv1": conv}))
    w = table.get(conv).weight
    assert w.dtype == torch.int8 and w.shape == (Co, Ci, 3, 3)
    packed = packed_conv_weight(w)
    assert packed.data_ptr() == w.data_ptr()
    storage = packed.view(torch.uint8).numpy().reshape(-1)
    wn = w.numpy()
    # every (chunk, tap, N tile) box the kernel loads: the chunk's
    # channels of that tap, zeros past Cin (a ragged chunk) and past Cout
    for c0 in range(0, Ci, 128):
        for tap in range(9):
            for n0 in range(0, Co, bn):
                got = _tma_box(storage, dims, strides, box, (c0, tap, n0, 0),
                               1)[..., 0].view(np.int8)
                want = np.zeros((bn, 128), np.int8)
                part = wn[n0:n0 + bn, c0:c0 + 128, tap // 3, tap % 3]
                want[:part.shape[0], :part.shape[1]] = part
                assert np.array_equal(got, want), (c0, tap, n0)


def test_bf16_weight_map_reads_the_packed_storage_box_by_box():
    Ci, Co, bn = 96, 224, 160
    dims, strides, box = t_res.weight_map(Ci, Co, bn)
    w = torch.randn(Co, Ci, 3, 3).bfloat16().contiguous(
        memory_format=torch.channels_last)
    storage = packed_conv_weight(w).view(torch.uint8).numpy().reshape(-1)
    wn = w.view(torch.int16).numpy()
    for c0 in range(0, Ci, 64):
        for tap in (0, 4, 8):
            for n0 in range(0, Co, bn):
                got = _tma_box(storage, dims, strides, box, (c0, tap, n0, 0),
                               2).view(np.int16)[..., 0]
                want = np.zeros((bn, 64), np.int16)
                part = wn[n0:n0 + bn, c0:c0 + 64, tap // 3, tap % 3]
                want[:part.shape[0], :part.shape[1]] = part
                assert np.array_equal(got, want), (c0, tap, n0)


def test_launch_hands_the_int8_table_weights_to_the_c_entry(monkeypatch):
    """The W8A8 ``_launch`` gives the C entry the int8 table's own packed
    weight storage (no per-call copy), the W8A8 plan's tile argument and
    GN2 partials of the plan's tile count; the C entry, the stream and the
    GroupNorm statistics passes are stood in for here."""
    torch.manual_seed(0)
    B, H, W, Ci, Co = 2, 24, 24, 64, 96
    block = ResnetBlock2D(Ci, Co, 16).to(torch.bfloat16)
    table = quantize_unet(block)
    q1, q2 = table.get(block.conv1), table.get(block.conv2)
    calls, partials = [], []

    def entry(*args):
        calls.append(args)
        return 0

    def stats(x, groups, eps):
        s = x.float().reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
        return s.mean(dim=(1, 3)), s.var(dim=(1, 3)).add(eps).rsqrt()

    def from_partials(psum, psq, groups, count, eps):
        partials.append((psum, psq))
        return torch.zeros(B, groups), torch.ones(B, groups)

    monkeypatch.setattr(t_res, "_library", lambda: (None, entry))
    monkeypatch.setattr(t_res, "_stream", lambda x: 0)
    monkeypatch.setattr(t_res, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(t_gn, "group_stats", stats)
    monkeypatch.setattr(t_gn, "stats_from_partials", from_partials)
    x = torch.randn(B, H, W, Ci).bfloat16()
    tvec = torch.randn(B, Co)
    n1, n2, sc = block.norm1, block.norm2, block.conv_shortcut
    out = t_res._launch(x, tvec, n1.weight, n1.bias, q1.weight,
                        block.conv1.bias, n2.weight, n2.bias, q2.weight,
                        block.conv2.bias, sc.weight[:, :, 0, 0], sc.bias,
                        n1.num_groups, n2.num_groups, n1.eps,
                        quant=(q1.scale, q2.scale, q1.act_scale,
                               q2.act_scale))
    assert out.shape == (B, H, W, Co)
    assert len(calls) == 2 and len(partials) == 1
    for args, q, cin in ((calls[0], q1, Ci), (calls[1], q2, Co)):
        assert args[6] == q.weight.data_ptr()  # the table's int8 storage
        assert args[14:20] == (B, H, W, cin, Co, 32)
        plan = t_res.conv_plan_w8a8(B, H, W, cin, Co)
        assert args[20] == plan.arg
    # conv1 writes the GN2 partials, [B, the plan's tiles, Co]; conv2 takes
    # the shortcut
    psum, psq = partials[0]
    plan1 = t_res.conv_plan_w8a8(B, H, W, Ci, Co)
    assert psum.shape == psq.shape == (B, plan1.tiles, Co)
    assert (calls[0][12], calls[0][13]) == (psum.data_ptr(), psq.data_ptr())
    assert calls[0][10] is None and calls[1][12] is None
    assert calls[1][10] is not None and calls[1][9] is None
