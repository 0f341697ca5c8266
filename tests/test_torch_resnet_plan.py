"""The launch plan of the bf16 fused-resnet conv kernel
(``vidtome_torch.ops.resnet.conv_plan``), the TMA view of its packed
weight (``weight_map``) and the weight packing of ``ResnetBlock2D``, on the
CPU: the kernel itself runs only on the card (``tests/test_torch_kernels.py``),
so its grid, tile and shared-memory budget at chip_smoke.py's rows and at
SD1.5's block shapes, the byte strides TMA reads the weight with, and that
no call repacks the weights are pinned here."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from vidtome_torch.models.layers import ResnetBlock2D
from vidtome_torch.ops import groupnorm as t_gn
from vidtome_torch.ops import resnet as t_res
from vidtome_torch.ops.quant import packed_conv_weight

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
