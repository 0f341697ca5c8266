"""The Hopper kernels of vidtome_torch against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA device
(the kernels have no CPU mode).  This file imports no JAX, so it also runs
on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Each kernel runs in bf16 and is held against its plain version in fp32 on
the same bf16 inputs.  Tolerances: attention, 2e-2 absolute (bf16
probabilities and bf16 output, 2^-8 relative each, on outputs of at most
about 1), and flash also FLASH_TOL of max |ref|: with unit-normal q, k, v
over thousands of keys the outputs are about 0.02 (the sqrt(e / Skv) of a
softmax average), so 2e-2 absolute would let a dropped K tile through;
GroupNorm, 3e-2 relative to max(1, |y|) (one bf16 ulp of values up to 4 is
2^-6, plus fp32 sums in another order); fused resnet, 2e-2 of max |ref|
(the kernel rounds the activations entering both convolutions and the
intermediate h to bf16, 2^-9 relative each, over K = 9 * Cin products);
best match, max scores to 1e-4 absolute (fp32 sums of up to 1728 products
in another order) and argmax equal wherever the plain version's top two
scores differ by more than 1e-3 (closer pairs are near-ties that the sum
order may flip), exact duplicate dst rows going to the lowest index;
single-pass attention, 2e-2 absolute and 1e-2 of max |ref| (its sound
readings are at most 4.6e-3 of max |ref|, the kv_len mask left out reads
1.35e-2 or more at 77 of 80 keys); fused sublayer, 5e-2
absolute on x3 and y3 (x3 up to |6| rounds to bf16 by up to 2^-6, and the
kernel rounds y2, q, p and a to bf16 where the fp32 plain version does
not, about 1e-2 more).  The W8A8 fused resnet is held against its plain
version run in bf16 on the card (the same rounding points, so the same
int8 activations but where fp32 sums in another order move a value across
a rounding boundary), 2e-2 of max |ref| as the bf16 kernel.  The
GroupNorm entries: y as above (in fp32 to 1e-4 relative to max(1, |y|)),
the statistics to 1e-4 relative (fp32 sums in another order), and the same
bits on a second call (no atomics).  GEGLU's gate equals its plain version
h * F.gelu(gate) to the bit in bf16 and fp32: the kernel runs the eager
path's fp32 arithmetic with the same two roundings.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vidtome_torch.models.layers import GEGLU
from vidtome_torch.ops import attention as t_attn
from vidtome_torch.ops import geglu as t_geglu
from vidtome_torch.ops import groupnorm as t_gn
from vidtome_torch.ops import matching as t_match
from vidtome_torch.ops import quant as t_quant
from vidtome_torch.ops import resnet as t_res
from vidtome_torch.ops import sublayer as t_sub

torch.set_num_threads(2)

ATTN_TOL = 2e-2
FLASH_TOL = 1e-2  # of max |ref|, as chip_smoke.py's
GN_TOL = 3e-2
RESNET_TOL = 2e-2
MATCH_TOL = 1e-4
MATCH_GAP = 1e-3
SUBLAYER_TOL = 5e-2
SMALL_KV_REL_TOL = 1e-2  # of max |ref|, as chip_smoke.py's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, shape, cuda, scale=1.0, shift=0.0):
    a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(cuda, torch.bfloat16)


def _check_flash(got, want):
    err = (got.float() - want).abs().max().item()
    assert err < ATTN_TOL
    assert err <= FLASH_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv,D,kv_valid", [
    (2, 8, 5120, 5120, 40, None),    # merged L0 self-attention
    (2, 8, 1536, 1536, 80, None),    # merged L1 self-attention
    (8, 8, 256, 256, 160, None),     # L2 per frame
    (2, 8, 300, 300, 40, 211),       # ragged length + caller padding mask
    (8, 8, 4096, 77, 40, None),      # cross-attention vs 77 text tokens
    (2, 1, 1024, 1024, 512, None),   # VAE mid block, one head
    (2, 2, 100, 64, 16, None),       # tiny test widths
    (3, 5, 1536, 1536, 64, None),    # SD2.1 L1 merged self-attention
    (2, 8, 1000, 1536, 80, None),    # Sq not a multiple of the block rows
    (1, 1, 1000, 1100, 512, None),   # the same at D = 512 (64 rows)
    (2, 4, 700, 700, 80, 555),       # kv_valid_len inside a 64-key tile
    (1, 2, 300, 333, 512, 301),      # kv_valid_len inside a 32-key tile
    (1, 3, 200, 1000, 160, 999),     # D = 160, the last key masked
])
def test_flash_kernel_matches_plain(cuda, B, H, Sq, Skv, D, kv_valid):
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, (B, H, s, D), cuda) for s in (Sq, Skv, Skv))
    before = t_attn.flash_attention.launches
    got = t_attn.flash_attention(q, k, v, kv_valid_len=kv_valid)
    torch.cuda.synchronize()
    assert t_attn.flash_attention.launches == before + 1
    want = t_attn.reference_attention(q.float(), k.float(), v.float(),
                                      kv_valid_len=kv_valid)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _check_flash(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 80])
def test_flash_kernel_takes_head_views(cuda, D):
    """[B, S, H*D] projections viewed as [B, H, S, D] need no copy."""
    rng = np.random.default_rng(4)
    B, S, H = 2, 333, 8
    x = [_bf16(rng, (B, S, H * D), cuda) for _ in range(3)]
    q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in x)
    got = t_attn.flash_attention(q, k, v)
    want = t_attn.reference_attention(q.float(), k.float(), v.float())
    _check_flash(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", [(2, 8, 5120, 40), (1, 1, 1000, 512)])
def test_flash_kernel_gives_the_same_bits_twice(cuda, B, H, S, D):
    rng = np.random.default_rng(16)
    q, k, v = (_bf16(rng, (B, H, S, D), cuda) for _ in range(3))
    got = t_attn.flash_attention(q, k, v)
    again = t_attn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_kernel_rejects_fp32(cuda):
    q = torch.zeros(1, 1, 64, 40, device=cuda)
    with pytest.raises(TypeError):
        t_attn.flash_attention(q, q, q)


# (B, rows, C, silu, eps, dtype): every GroupNorm shape of SD1.5's UNet at
# 512x512 (resident slabs), the VAE's (the 65536- and 262144-row ones
# stream), the CFG-skip batch, and the narrow test widths
GN_CASES = [
    (8, 4096, 320, True, 1e-5, torch.bfloat16),
    (8, 4096, 320, False, 1e-6, torch.bfloat16),  # Transformer2D input norm
    (8, 4096, 640, True, 1e-5, torch.bfloat16),
    (8, 4096, 960, True, 1e-5, torch.bfloat16),
    (8, 1024, 320, True, 1e-5, torch.bfloat16),
    (8, 1024, 640, False, 1e-6, torch.bfloat16),
    (8, 1024, 960, True, 1e-5, torch.bfloat16),
    (8, 1024, 1280, True, 1e-5, torch.bfloat16),
    (8, 1024, 1920, True, 1e-5, torch.bfloat16),
    (8, 256, 640, True, 1e-5, torch.bfloat16),
    (8, 256, 1280, False, 1e-6, torch.bfloat16),
    (8, 256, 1920, True, 1e-5, torch.bfloat16),
    (8, 256, 2560, True, 1e-5, torch.bfloat16),
    (8, 64, 1280, True, 1e-5, torch.bfloat16),
    (8, 64, 2560, True, 1e-5, torch.bfloat16),
    (4, 4096, 960, True, 1e-5, torch.bfloat16),   # the CFG-skip batch
    (8, 4096, 512, False, 1e-5, torch.bfloat16),  # VAE mid block
    (8, 16384, 128, True, 1e-5, torch.bfloat16),
    (8, 16384, 512, True, 1e-5, torch.bfloat16),
    (8, 65536, 256, True, 1e-5, torch.bfloat16),  # streaming
    (8, 262144, 128, True, 1e-5, torch.bfloat16),  # streaming, largest
    (4, 262144, 128, True, 1e-5, torch.bfloat16),  # streaming, 64-byte rows
    (2, 1000, 96, False, 1e-6, torch.bfloat16),
    (1, 300, 64, True, 1e-5, torch.float32),
]


def _gn_inputs(seed, cuda, B, rows, C, dtype, affine=torch.float32):
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (B, rows, C), cuda, scale=2.0, shift=0.5).to(dtype)
    w = torch.from_numpy(rng.normal(size=C).astype(np.float32) + 1).to(
        cuda, affine)
    b = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(
        cuda, affine)
    return x, w, b


def _check_gn(got, want, dtype):
    assert got.dtype == dtype
    err = ((got.float() - want).abs() / want.abs().clamp_min(1.0)).max()
    assert err.item() < (GN_TOL if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,rows,C,silu,eps,dtype", GN_CASES)
def test_group_norm_kernel_matches_plain(cuda, B, rows, C, silu, eps, dtype):
    """The stats and apply entries (``VIDTOME_GN_MODE=stats``), each against
    its plain version, the same bits twice."""
    x, w, b = _gn_inputs(3, cuda, B, rows, C, dtype)
    before = t_gn.group_norm.launches
    mean, rstd = t_gn.group_stats(x, 32, eps)
    got = t_gn.apply_group_norm(x, mean, rstd, w, b, 32, silu)
    again = t_gn.apply_group_norm(x, *t_gn.group_stats(x, 32, eps), w, b, 32,
                                  silu)
    torch.cuda.synchronize()
    assert t_gn.group_norm.launches == before + 4
    assert torch.equal(got, again)  # no atomics: the same bits every run
    want_mean, want_rstd = t_gn.reference_group_stats(x.float(), 32, eps)
    torch.testing.assert_close(mean, want_mean, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=0, rtol=1e-4)
    # apply against the plain normalize from the same statistics
    want = t_gn.reference_apply(x.float(), mean, rstd, w, b, 32, silu)
    _check_gn(got, want, dtype)


def _resnet_args(rng, cuda, B, H, W, Ci, Co):
    f32 = lambda *shape, s=1.0, m=0.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * s + m).astype(np.float32)).to(cuda)
    args = [_bf16(rng, (B, H, W, Ci), cuda), f32(B, Co, s=0.3),
            f32(Ci, s=0.2, m=1.0), f32(Ci, s=0.1),
            f32(Co, Ci, 3, 3, s=(9 * Ci) ** -0.5).bfloat16(), f32(Co, s=0.1),
            f32(Co, s=0.2, m=1.0), f32(Co, s=0.1),
            f32(Co, Co, 3, 3, s=(9 * Co) ** -0.5).bfloat16(), f32(Co, s=0.1)]
    if Ci != Co:
        args += [f32(Co, Ci, s=Ci ** -0.5).bfloat16(), f32(Co, s=0.1)]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [
    (8, 64, 64, 320, 320),    # SD1.5 level 0, identity shortcut
    (4, 64, 64, 960, 320),    # ragged width, projection, cfg-skip batch
    (2, 8, 8, 96, 32),        # tiny widths, projection, 8x8 image
    (1, 13, 21, 64, 64),      # ragged tiles on both image axes
    (8, 8, 8, 1280, 1280),    # SD1.5 8x8 level: one 8x8 tile an image
    (8, 16, 16, 2560, 1280),  # up block 1, skip-concat width
    # the SDXL refiner's widths: 36- and 12-channel groups, Co = 384 and
    # 768 not a multiple of 160
    (2, 32, 32, 1152, 384),
    (2, 16, 16, 384, 768),
    (2, 16, 16, 3072, 1536),
])
def test_fused_resnet_kernel_matches_plain(cuda, B, H, W, Ci, Co):
    rng = np.random.default_rng(5)
    args = _resnet_args(rng, cuda, B, H, W, Ci, Co)
    before = t_res.fused_resnet.launches
    got = t_res.fused_resnet(*args)
    torch.cuda.synchronize()
    assert t_res.fused_resnet.launches == before + 1
    want = t_res.reference_fused_resnet(*[a.float() for a in args])
    assert got.shape == (B, H, W, Co) and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 8, 2), (8, 8, 1)])
@pytest.mark.parametrize("block_n", [160, 64])
@pytest.mark.parametrize("B,H,W,Ci,Co,groups1,spike", [
    # a ragged last chunk (40 of 64 channels) at 8 groups, ragged tiles on
    # both image axes, Co past the N tile
    (2, 13, 21, 40, 96, 8, False),
    # a ragged last chunk (96 = 64 + 32) with large values in the channels
    # a 2-D weight map (the next tap's) or an unmasked halo (the next
    # pixel's) would read, Co = 224 past both N tiles
    (3, 16, 24, 96, 224, 32, True),
])
def test_fused_resnet_kernel_instances_match_plain(
        cuda, monkeypatch, tile, block_n, B, H, W, Ci, Co, groups1, spike):
    # one kernel instance, whatever conv_plan would pick
    monkeypatch.setattr(t_res, "_TILES", (tile,))
    monkeypatch.setattr(t_res, "_BLOCK_N", (block_n,))
    rng = np.random.default_rng(14)
    args = _resnet_args(rng, cuda, B, H, W, Ci, Co)
    if spike:
        args[0][..., :32] *= 8
        args[4][:, :32] *= 8
        args[8][:, :32] *= 8
    kw = dict(num_groups1=groups1)
    got = t_res.fused_resnet(*args, **kw)
    want = t_res.reference_fused_resnet(*[a.float() for a in args], **kw)
    assert got.shape == (B, H, W, Co) and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL


@pytest.mark.cuda
def test_fused_resnet_kernel_takes_packed_module_weights(cuda):
    # SD1.5's 8x8 level at batch 8, the weights as ResnetBlock2D holds them
    # (OIHW views of packed [O, 3, 3, I] storage)
    rng = np.random.default_rng(15)
    args = _resnet_args(rng, cuda, 8, 8, 8, 1280, 1280)
    for i in (4, 8):
        args[i] = args[i].contiguous(memory_format=torch.channels_last)
    got = t_res.fused_resnet(*args)
    want = t_res.reference_fused_resnet(*[a.float() for a in args])
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [(8, 64, 64, 320, 320),
                                         (8, 16, 16, 2560, 1280)])
def test_fused_resnet_kernel_gives_the_same_bits_twice(cuda, B, H, W, Ci,
                                                       Co):
    # the GN2 partials are reduced in a fixed order, without atomics
    args = _resnet_args(np.random.default_rng(16), cuda, B, H, W, Ci, Co)
    assert torch.equal(t_res.fused_resnet(*args), t_res.fused_resnet(*args))


@pytest.mark.cuda
def test_fused_resnet_kernel_rejects_fp32(cuda):
    args = _resnet_args(np.random.default_rng(0), cuda, 1, 8, 8, 32, 32)
    with pytest.raises(TypeError):
        t_res.fused_resnet(*[a.float() for a in args])


def _unit_bf16(rng, shape, cuda):
    a = rng.normal(size=shape).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    return torch.from_numpy(a).to(cuda, torch.bfloat16)


def _check_match(got, want, scores):
    if scores.shape[-1] > 1:
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > MATCH_GAP
    else:  # one dst row: every argmax is 0
        clear = torch.ones(scores.shape[:-1], dtype=torch.bool,
                           device=scores.device)
    assert (got[0] - want[0]).abs().max().item() < MATCH_TOL
    assert torch.equal(got[1][clear], want[1][clear])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,C", [
    (2, 12288, 4096, 320),    # level-0 local round
    (2, 300, 211, 40),        # ragged S and D, C not a multiple of 16
    (1, 64, 64, 1728),        # widest C the kernel takes
    (2, 4711, 4711, 320),     # level-0 global merge against the bank
    (2, 3072, 1024, 640),     # level-1 local round
    (1, 200, 300, 1728),      # wide C: src streamed beside dst, 64 rows
    (2, 12288, 300, 1728),    # the same with 192-row blocks
    (1, 1, 1, 8),             # one src row, one dst row, narrowest C
])
def test_best_match_kernel_matches_plain(cuda, B, S, D, C):
    rng = np.random.default_rng(6)
    src, dst = _unit_bf16(rng, (B, S, C), cuda), _unit_bf16(rng, (B, D, C), cuda)
    before = t_match.best_match.launches
    got = t_match.best_match(src, dst)
    torch.cuda.synchronize()
    assert t_match.best_match.launches == before + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.long
    scores = torch.bmm(src.float(), dst.float().transpose(1, 2))
    _check_match(got, t_match.reference_best_match(src.float(), dst.float()),
                 scores)


@pytest.mark.cuda
def test_best_match_kernel_ties_to_lowest_index(cuda):
    """dst is a set of rows followed by an exact copy of it: every score
    appears twice and the lowest index must win."""
    rng = np.random.default_rng(7)
    src = _unit_bf16(rng, (2, 500, 64), cuda)
    base = _unit_bf16(rng, (2, 130, 64), cuda)
    got = t_match.best_match(src, torch.cat([base, base], dim=1))
    want = t_match.reference_best_match(src.float(), base.float())
    scores = torch.bmm(src.float(), base.float().transpose(1, 2))
    assert (got[1] < 130).all()
    _check_match(got, want, scores)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("resident", [True, False])
def test_best_match_kernel_instances_match_plain(cuda, rows, resident):
    """Every instance of the C entry (block rows, src tile resident or
    streamed), whatever the planner would pick, on one shape."""
    rng = np.random.default_rng(8)
    B, S, D, C = 2, 500, 333, 320
    src, dst = _unit_bf16(rng, (B, S, C), cuda), _unit_bf16(rng, (B, D, C), cuda)
    mx = torch.empty(B, S, device=cuda)
    ix = torch.empty(B, S, dtype=torch.long, device=cuda)
    err = t_match._library()(src.data_ptr(), dst.data_ptr(), mx.data_ptr(),
                             ix.data_ptr(), B, S, D, C, rows, int(resident),
                             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    scores = torch.bmm(src.float(), dst.float().transpose(1, 2))
    _check_match((mx, ix), t_match.reference_best_match(src.float(),
                                                        dst.float()), scores)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,C", [
    (2, 4711, 4711, 320),     # the global merge's ragged D
    (1, 300, 1, 64),          # one dst row: 127 of the tile's columns masked
    (2, 200, 131, 40),        # ragged D and C
])
def test_best_match_kernel_masks_columns_past_d(cuda, B, S, D, C):
    """Every score negative: the zero-filled dst rows past D score exactly 0
    and must not win (a dropped column mask returns 0 and an index >= D)."""
    rng = np.random.default_rng(9)
    src = _unit_bf16(rng, (B, S, C), cuda).abs()
    dst = -_unit_bf16(rng, (B, D, C), cuda).abs()
    got = t_match.best_match(src, dst)
    want = t_match.reference_best_match(src.float(), dst.float())
    assert (want[0] < 0).all() and (got[0] < 0).all()
    assert (got[1] < D).all()
    _check_match(got, want, torch.bmm(src.float(), dst.float().transpose(1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [136, 8, 130])
def test_best_match_kernel_ties_across_tiles_and_warpgroups(cuda, n):
    """dst is n rows and an exact copy of them; every src row is a copy of
    one of those rows, so its best score is an exact tie between the two
    copies, and the lowest index must win in every consumer warpgroup of
    the 192-row blocks.  n = 136: the copies straddle 128-row dst tiles in
    the same thread's columns (n a multiple of 8), so the running compare
    across tiles decides; n = 8: both in one tile and one thread, so the
    thread's scan decides; n = 130: in different threads, so their
    combine decides."""
    rng = np.random.default_rng(10)
    B, S, C = 2, 12288, 64
    assert t_match.match_plan(B, S, 2 * n, C).rows == 192
    base = _unit_bf16(rng, (B, n, C), cuda)
    pick = torch.from_numpy(rng.integers(0, n, (B, S))).to(cuda)
    src = torch.stack([base[b, pick[b]] for b in range(B)])
    got = t_match.best_match(src, torch.cat([base, base], dim=1))
    want = t_match.reference_best_match(src.float(), base.float())
    assert torch.equal(got[1], pick)
    assert torch.equal(want[1], pick)
    assert (got[0] - want[0]).abs().max().item() < MATCH_TOL


@pytest.mark.cuda
def test_best_match_kernel_same_bits_on_every_call(cuda):
    rng = np.random.default_rng(11)
    src = _unit_bf16(rng, (2, 4711, 320), cuda)
    dst = _unit_bf16(rng, (2, 4711, 320), cuda)
    first = t_match.best_match(src, dst)
    second = t_match.best_match(src, dst)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_best_match_kernel_rejects_unaligned_and_strided(cuda):
    flat = torch.zeros(8 + 64 * 32, dtype=torch.bfloat16, device=cuda)
    x = flat[4:4 + 64 * 32].view(1, 64, 32)  # 8 bytes past 16-byte bounds
    with pytest.raises(ValueError, match="16"):
        t_match.best_match(x, x)
    wide = torch.zeros(1, 64, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t_match.best_match(wide[:, :, :40], wide[:, :, :40])


@pytest.mark.cuda
def test_best_match_kernel_rejects_fp32(cuda):
    x = torch.zeros(1, 64, 32, device=cuda)
    with pytest.raises(TypeError):
        t_match.best_match(x, x)


def _check_small_kv(got, want):
    err = (got.float() - want).abs().max().item()
    assert err < ATTN_TOL
    assert err <= SMALL_KV_REL_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv,D,kv_valid", [
    (8, 5, 4096, 77, 64, None),     # SD2.1 cross-attention (inversion)
    (12, 5, 4096, 77, 64, None),    # SD2.1 PnP generation, L0 cross
    (12, 20, 256, 256, 64, None),   # SD2.1 PnP generation, 16x16 self
    (12, 20, 64, 77, 64, None),     # SD2.1 mid block cross
    (8, 8, 4096, 77, 40, None),     # SD1.5 cross-attention, level 0
    (8, 8, 1024, 77, 80, None),     # SD1.5 cross-attention, level 1
    (8, 8, 256, 77, 160, None),     # SD1.5 cross-attention, level 2
    (8, 8, 256, 256, 160, None),    # SD1.5 16x16 self-attention: widest
    (8, 8, 64, 77, 160, None),      # SD1.5 mid block cross
    (8, 8, 64, 64, 160, None),      # SD1.5 mid block self
    (24, 20, 64, 64, 64, None),     # SD2.1 8x8 self-attention
    (2, 3, 300, 80, 64, 77),        # masked key tail, ragged Sq
    (2, 4, 100, 80, 40, 77),        # 77 of 80 keys, Sq not a multiple of 64
    (2, 4, 200, 256, 160, 200),     # 200 of 256 keys, ragged Sq
    (3, 2, 130, 100, 80, 99),       # 128-key instance, ragged Sq
    (2, 2, 100, 16, 16, None),      # D=16 with 16 keys
])
def test_small_kv_kernel_matches_plain(cuda, B, H, Sq, Skv, D, kv_valid):
    rng = np.random.default_rng(8)
    q, k, v = (_bf16(rng, (B, H, s, D), cuda) for s in (Sq, Skv, Skv))
    before = t_attn.small_kv_attention.launches
    got = t_attn.small_kv_attention(q, k, v, kv_valid_len=kv_valid)
    torch.cuda.synchronize()
    assert t_attn.small_kv_attention.launches == before + 1
    want = t_attn.reference_attention(q.float(), k.float(), v.float(),
                                      kv_valid_len=kv_valid)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _check_small_kv(got, want)


@pytest.mark.cuda
def test_small_kv_kernel_ignores_large_keys_past_kv_len(cuda):
    """Keys past kv_valid_len carry large values, so letting any of them
    into the softmax moves the output by far more than the tolerance."""
    rng = np.random.default_rng(12)
    q, k, v = (_bf16(rng, (2, 4, 300, 64), cuda) if s == "q" else
               _bf16(rng, (2, 4, 80, 64), cuda) for s in "qkv")
    k[:, :, 77:] = 30.0 * q[:, :, :3].mean(dim=2, keepdim=True)
    v[:, :, 77:] = 50.0
    got = t_attn.small_kv_attention(q, k, v, kv_valid_len=77)
    want = t_attn.reference_attention(q.float(), k.float(), v.float(),
                                      kv_valid_len=77)
    _check_small_kv(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 80, 160])
def test_small_kv_kernel_takes_head_views(cuda, D):
    """[B, S, H*D] projections viewed as [B, H, S, D] need no copy."""
    rng = np.random.default_rng(10)
    B, S, H = 2, 333, 8
    x = _bf16(rng, (B, S, H * D), cuda)
    ctx = [_bf16(rng, (B, 77, H * D), cuda) for _ in range(2)]
    q = x.view(B, S, H, D).transpose(1, 2)
    k, v = (t.view(B, 77, H, D).transpose(1, 2) for t in ctx)
    got = t_attn.small_kv_attention(q, k, v)
    want = t_attn.reference_attention(q.float(), k.float(), v.float())
    _check_small_kv(got, want)


@pytest.mark.cuda
def test_small_kv_kernel_takes_head_views_and_dispatch(cuda):
    rng = np.random.default_rng(9)
    B, S, H, D = 2, 333, 5, 64
    x = _bf16(rng, (B, S, H * D), cuda)
    ctx = [_bf16(rng, (B, 77, H * D), cuda) for _ in range(2)]
    q = x.view(B, S, H, D).transpose(1, 2)
    k, v = (t.view(B, 77, H, D).transpose(1, 2) for t in ctx)
    before = (t_attn.small_kv_attention.launches,
              t_attn.flash_attention.launches)
    got = t_attn.attention(q, k, v)
    assert (t_attn.small_kv_attention.launches,
            t_attn.flash_attention.launches) == (before[0] + 1, before[1])
    want = t_attn.reference_attention(q.float(), k.float(), v.float())
    _check_small_kv(got, want)
    t_attn.attention(q, q, q)  # 333 keys: flash
    assert t_attn.flash_attention.launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv,D", [(8, 8, 4096, 77, 40),
                                          (8, 8, 256, 256, 160)])
def test_small_kv_kernel_gives_the_same_bits_twice(cuda, B, H, Sq, Skv, D):
    rng = np.random.default_rng(17)
    q, k, v = (_bf16(rng, (B, H, s, D), cuda) for s in (Sq, Skv, Skv))
    got = t_attn.small_kv_attention(q, k, v)
    again = t_attn.small_kv_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_attention_wrappers_launch_on_the_current_stream(cuda):
    """The raw handle the wrappers pass is the current stream's, on a side
    stream too (as under CUDA graph capture), and a launch there matches
    one on the default stream."""
    rng = np.random.default_rng(19)
    q, k, v = (_bf16(rng, (2, 4, s, 64), cuda) for s in (300, 77, 77))
    want = t_attn.small_kv_attention(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert (torch._C._cuda_getCurrentRawStream(q.get_device())
                == side.cuda_stream)
        got = t_attn.small_kv_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_small_kv_kernel_rejects_fp32(cuda):
    q = torch.zeros(1, 1, 64, 40, device=cuda)
    with pytest.raises(TypeError):
        t_attn.small_kv_attention(q, q, q)


@pytest.mark.cuda
def test_small_kv_kernel_rejects_a_misaligned_stride(cuda):
    # rows of 124 bf16 (248 bytes): not a multiple of 16 bytes
    t = torch.zeros(2, 10, 124, device=cuda, dtype=torch.bfloat16)[..., :120]
    view = t.view(2, 10, 3, 40).transpose(1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        t_attn.small_kv_attention(view, view, view)


def _sublayer_args(rng, cuda, B, S, C, skv):
    def f32(*shape, s=1.0, m=0.0):
        return torch.from_numpy((rng.normal(size=shape) * s + m).astype(
            np.float32)).to(cuda)

    return [_bf16(rng, (B, S, C), cuda), _bf16(rng, (B, S, C), cuda, 0.5),
            _bf16(rng, (B, skv, C), cuda), _bf16(rng, (B, skv, C), cuda),
            f32(C, C, s=C ** -0.5).bfloat16(), f32(C, C, s=C ** -0.5).bfloat16(),
            f32(C, s=0.1), f32(C, s=0.1, m=1.0), f32(C, s=0.1),
            f32(C, s=0.1, m=1.0), f32(C, s=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,heads,skv,kv_len", [
    (12, 4096, 320, 5, 77, 77),     # SD2.1 PnP generation, level 0
    (12, 1024, 640, 10, 77, 77),    # level 1
    (12, 256, 1280, 20, 77, 77),    # level 2
    (12, 64, 1280, 20, 77, 77),     # mid block
    (2, 4096, 320, 8, 77, 77),      # SD1.5 level 0: D = 40
    (2, 100, 640, 8, 80, 77),       # D = 80, ragged S, masked key tail
    (2, 16, 64, 4, 16, 16),         # tiny test widths
    (8, 1024, 640, 8, 77, 77),      # SD1.5 level 1 at batch 8: D = 80
    (8, 256, 1280, 8, 77, 77),      # SD1.5 level 2: D = 160
    (8, 64, 1280, 8, 77, 77),       # SD1.5 mid block: D = 160
    (2, 70, 1280, 8, 128, 100),     # 128 padded keys, 100 valid, D = 160
    (8, 4096, 640, 10, 77, 77),     # SDXL level 1: two ranks of 5 heads
    (8, 1024, 1280, 20, 77, 77),    # SDXL level 2 and mid: four ranks
    (8, 4096, 768, 8, 77, 77),      # SDXL refiner level 1: D = 96, four
    (8, 1024, 1536, 16, 77, 77),    # ranks of 2; level 2: eight ranks
    (8, 256, 1536, 16, 77, 77),     # refiner mid block
    (2, 100, 768, 8, 128, 100),     # D = 96, 128 padded keys
    (8, 4096, 768, 12, 77, 77),     # 12 heads of 64: four ranks of 3
    (8, 1024, 1536, 24, 77, 77),    # 24 heads of 64: eight ranks of 3
    (2, 100, 768, 12, 128, 100),    # three heads a rank, 128 padded keys
])
def test_fused_sublayer_kernel_matches_plain(cuda, B, S, C, heads, skv,
                                             kv_len):
    args = _sublayer_args(np.random.default_rng(10), cuda, B, S, C, skv)
    before = t_sub.fused_cross_sublayer.launches
    x3, y3 = t_sub.fused_cross_sublayer(*args, heads=heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert t_sub.fused_cross_sublayer.launches == before + 1
    wx3, wy3 = t_sub.reference_cross_sublayer(*[a.float() for a in args],
                                              heads=heads, kv_len=kv_len)
    assert x3.dtype == y3.dtype == torch.bfloat16
    assert (x3.float() - wx3).abs().max().item() < SUBLAYER_TOL
    assert (y3.float() - wy3).abs().max().item() < SUBLAYER_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,heads", [
    (2, 100, 320, 5),    # one block a cluster
    (2, 100, 640, 10),   # two
    (2, 70, 1280, 20),   # four
])
def test_fused_sublayer_kernel_ignores_keys_past_kv_len(cuda, B, S, C,
                                                        heads):
    """Garbage rows of k and v past kv_len give the bits of zeros there
    (TMA reads them as zeros; the scores are masked)."""
    rng = np.random.default_rng(12)
    args = _sublayer_args(rng, cuda, B, S, C, 96)
    clean = [a.clone() for a in args]
    for t in clean[2:4]:
        t[:, 77:] = 0
    for t, fill in zip(args[2:4], (37.0, -5.0)):
        t[:, 77:] = fill
    got = t_sub.fused_cross_sublayer(*args, heads=heads, kv_len=77)
    want = t_sub.fused_cross_sublayer(*clean, heads=heads, kv_len=77)
    ref = t_sub.reference_cross_sublayer(*[a.float() for a in clean],
                                         heads=heads, kv_len=77)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        assert (g.float() - r).abs().max().item() < SUBLAYER_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,heads", [(3, 200, 320, 8), (2, 130, 1280, 20)])
def test_fused_sublayer_kernel_same_bits_twice(cuda, B, S, C, heads):
    """Statistics reduced over DSMEM in rank order, no atomics: two calls
    give the same bits."""
    args = _sublayer_args(np.random.default_rng(13), cuda, B, S, C, 77)
    first = t_sub.fused_cross_sublayer(*args, heads=heads, kv_len=77)
    second = t_sub.fused_cross_sublayer(*args, heads=heads, kv_len=77)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sublayer_kernel_reads_bf16_affines(cuda):
    """bout and the LayerNorm affines as a bf16 module holds them."""
    args = _sublayer_args(np.random.default_rng(14), cuda, 2, 100, 640,
                          77)[:6]
    args += [t.bfloat16() for t in _sublayer_args(
        np.random.default_rng(15), cuda, 1, 1, 640, 1)[6:]]
    before = t_sub.fused_cross_sublayer.launches
    x3, y3 = t_sub.fused_cross_sublayer(*args, heads=10, kv_len=77)
    torch.cuda.synchronize()
    assert t_sub.fused_cross_sublayer.launches == before + 1
    wx3, wy3 = t_sub.reference_cross_sublayer(*[a.float() for a in args],
                                              heads=10, kv_len=77)
    assert (x3.float() - wx3).abs().max().item() < SUBLAYER_TOL
    assert (y3.float() - wy3).abs().max().item() < SUBLAYER_TOL


@pytest.mark.cuda
def test_fused_sublayer_kernel_rejects_what_it_cannot_take(cuda):
    args = _sublayer_args(np.random.default_rng(11), cuda, 1, 32, 320, 77)
    with pytest.raises(TypeError):
        t_sub.fused_cross_sublayer(*[a.float() for a in args], heads=8,
                                   kv_len=77)
    with pytest.raises(ValueError):  # D = 320 / 3 is not an integer
        t_sub.fused_cross_sublayer(*args, heads=3, kv_len=77)


def _w8a8_args(rng, cuda, B, H, W, Ci, Co, spike=False):
    """bf16 block inputs with int8 conv weights (packed as the int8 tables
    hold them) and their scales; ``spike``: large values in the first 32
    channels of x and of both weights' inputs."""
    args = _resnet_args(rng, cuda, B, H, W, Ci, Co)
    if spike:
        args[0][..., :32] *= 8
        args[4][:, :32] *= 8
        args[8][:, :32] *= 8
    q = []
    for i in (4, 8):
        w_q, scale = t_quant.quantize_weight(args[i])
        q.append(scale)
        args[i] = t_quant.packed_conv_weight(w_q).permute(0, 3, 1, 2)
    return args, dict(w1_scale=q[0], w2_scale=q[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [
    (8, 64, 64, 320, 320),    # SD1.5 level 0, identity shortcut
    (4, 64, 64, 960, 320),    # ragged 64-channel chunk, cfg-skip batch
    (8, 16, 16, 2560, 1280),  # up block 1, skip-concat width
    (2, 8, 8, 64, 32),        # tiny widths, projection, 8x8 image
    (1, 13, 21, 64, 64),      # ragged tiles on both image axes
    # conv1 a half 128-channel chunk (320 = 2.5 chunks), Co = 96 past the
    # 64-channel N tile
    (2, 16, 16, 320, 96),
    # one ragged chunk (96 of 128 channels), Co = 224 past the N tile
    (3, 16, 24, 96, 224),
    # the SDXL refiner's widths: 384 = 320 + 64 output channels, 36- and
    # 12-channel groups
    (2, 32, 32, 1152, 384),
    (2, 16, 16, 384, 768),
    (2, 16, 16, 3072, 1536),
])
def test_fused_resnet_w8a8_kernel_matches_plain(cuda, B, H, W, Ci, Co):
    args, kw = _w8a8_args(np.random.default_rng(12), cuda, B, H, W, Ci, Co)
    before = t_res.fused_resnet_w8a8.launches
    got = t_res.fused_resnet_w8a8(*args, **kw)
    torch.cuda.synchronize()
    assert t_res.fused_resnet_w8a8.launches == before + 1
    want = t_res.reference_fused_resnet(*args, quant=True, **kw).float()
    assert got.shape == (B, H, W, Co) and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [(2, 320), (1, 64)])
@pytest.mark.parametrize("B,H,W,Ci,Co,groups1,spike", [
    # a ragged last chunk (32 of 128 channels) at 8 groups, ragged tiles on
    # both image axes, Co past the N tile (at 320, short of the first
    # warpgroup's 160: the second's weight box is not loaded)
    (2, 13, 21, 160, 96, 8, False),
    # one ragged chunk (96 of 128) with large values in the channels a 2-D
    # weight map (the next tap's) or an unmasked halo (the next pixel's)
    # would read, Co = 224 past the N tile (at 320, in the second
    # warpgroup's channels)
    (3, 16, 24, 96, 224, 32, True),
    # Co = 640 over two blocks of 320, two chunks
    (2, 16, 16, 256, 640, 32, False),
])
def test_fused_resnet_w8a8_kernel_instances_match_plain(
        cuda, monkeypatch, launch, B, H, W, Ci, Co, groups1, spike):
    # one kernel instance, whatever conv_plan_w8a8 would pick
    monkeypatch.setattr(t_res, "_W8A8_TILES", (launch,))
    args, kw = _w8a8_args(np.random.default_rng(18), cuda, B, H, W, Ci, Co,
                          spike)
    kw["num_groups1"] = groups1
    got = t_res.fused_resnet_w8a8(*args, **kw)
    want = t_res.reference_fused_resnet(*args, quant=True, **kw).float()
    assert got.shape == (B, H, W, Co) and got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [(8, 64, 64, 320, 320),
                                         (3, 16, 24, 96, 224),
                                         (8, 8, 8, 1280, 1280)])
def test_w8a8_conv_entry_matches_plain_conv(cuda, B, H, W, Ci, Co):
    """One launch of the W8A8 C entry as conv1 (GN1 prologue, +b1+tvec,
    GN2 partials) against the plain W8A8 conv (``_conv3x3``) of the same
    bf16 activation."""
    args, kw = _w8a8_args(np.random.default_rng(19), cuda, B, H, W, Ci, Co)
    x, tvec, gamma, beta, w, bias = args[:6]
    s = x.float().reshape(B, -1, 32, Ci // 32)
    mean = s.mean(dim=(1, 3))
    rstd = torch.rsqrt((s * s).mean(dim=(1, 3)) - mean * mean + 1e-5)
    sx = t_quant.static_act_scale(gamma, beta)
    out, psum, psq = t_res._conv(
        x, mean.contiguous(), rstd.contiguous(), gamma, beta,
        t_quant.packed_conv_weight(w), bias, tvec, None, 32, True,
        (sx, kw["w1_scale"]))
    torch.cuda.synchronize()
    a = t_res._gn_silu(x, x, gamma, beta, 32, 1e-5)
    want = (t_res._conv3x3(a, w, kw["w1_scale"], sx)
            + (bias + tvec)[:, None, None, :])
    err = (out.float() - want).abs().max() / want.abs().max()
    assert err.item() < RESNET_TOL
    # the GN2 partials: a tile's sums of the fp32 values, over the plan's
    # tiles, add up to the plain sums
    plan = t_res.conv_plan_w8a8(B, H, W, Ci, Co, t_res._sm_count(0))
    assert psum.shape == psq.shape == (B, plan.tiles, Co)
    q_want = (want * want).sum(dim=(1, 2))
    assert ((psq.sum(dim=1) - q_want).abs() / q_want).max().item() < 1e-2
    s_err = (psum.sum(dim=1) - want.sum(dim=(1, 2))).abs()
    assert (s_err / want.abs().sum(dim=(1, 2))).max().item() < 1e-2


@pytest.mark.cuda
def test_fused_resnet_w8a8_kernel_gives_the_same_bits_twice(cuda):
    # the GN2 partials are reduced in a fixed order, without atomics
    args, kw = _w8a8_args(np.random.default_rng(20), cuda, 8, 64, 64, 320,
                          320)
    assert torch.equal(t_res.fused_resnet_w8a8(*args, **kw),
                       t_res.fused_resnet_w8a8(*args, **kw))


@pytest.mark.cuda
def test_fused_resnet_w8a8_kernel_rejects_what_it_cannot_take(cuda):
    args, kw = _w8a8_args(np.random.default_rng(13), cuda, 1, 8, 8, 48, 48)
    with pytest.raises(ValueError, match="multiples of 32"):
        t_res.fused_resnet_w8a8(*args, **kw)
    args, kw = _w8a8_args(np.random.default_rng(13), cuda, 1, 8, 8, 32, 32)
    with pytest.raises(TypeError):
        t_res.fused_resnet_w8a8(args[0].float(), *args[1:], **kw)
    args[4] = args[4].float()
    with pytest.raises(TypeError, match="int8"):
        t_res.fused_resnet_w8a8(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B,rows,C,silu,eps,dtype", GN_CASES)
def test_full_group_norm_kernel_matches_plain(cuda, B, rows, C, silu, eps,
                                              dtype):
    x, w, b = _gn_inputs(14, cuda, B, rows, C, dtype)
    before = t_gn.full_group_norm.launches
    got = t_gn.full_group_norm(x, w, b, 32, eps, silu)
    again = t_gn.full_group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert t_gn.full_group_norm.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits every run
    _check_gn(got, t_gn.reference_group_norm(x.float(), w, b, 32, eps, silu),
              dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,rows,C", [(8, 4096, 320), (8, 262144, 128)])
def test_group_norm_kernel_takes_a_bf16_affine(cuda, B, rows, C):
    """The affine as a bf16 module holds it: no cast launch, the same
    result as the fp32 affine of the same values."""
    x, w, b = _gn_inputs(17, cuda, B, rows, C, torch.bfloat16,
                         affine=torch.bfloat16)
    got = t_gn.full_group_norm(x, w, b, 32, 1e-5, True)
    want = t_gn.full_group_norm(x, w.float(), b.float(), 32, 1e-5, True)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,tiles,C,count", [
    (8, 128, 320, 4096),    # L0 conv tiles
    (4, 16, 1280, 64),
    (8, 256, 640, 1024),
    (2, 3, 96, 300),
])
def test_group_norm_finalize_matches_plain(cuda, B, tiles, C, count):
    rng = np.random.default_rng(18)
    x = torch.from_numpy((rng.normal(size=(B, tiles, 32, C)) * 2 + 0.5)
                         .astype(np.float32)).to(cuda)
    sums, sqs = x.sum(2).contiguous(), (x * x).sum(2).contiguous()
    before = t_gn.group_norm.launches
    mean, rstd = t_gn.stats_from_partials(sums, sqs, 32, count, 1e-5)
    again = t_gn.stats_from_partials(sums, sqs, 32, count, 1e-5)
    torch.cuda.synchronize()
    assert t_gn.group_norm.launches == before + 2
    assert torch.equal(mean, again[0]) and torch.equal(rstd, again[1])
    want = t_gn.reference_stats_from_partials(sums, sqs, 32, count, 1e-5)
    torch.testing.assert_close(mean, want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want[1], atol=0, rtol=1e-4)


@pytest.mark.cuda
def test_group_norm_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.default_rng(19)
    x = _bf16(rng, (2, 64, 36), cuda)
    w, b = torch.ones(36, device=cuda), torch.zeros(36, device=cuda)
    with pytest.raises(ValueError, match="no slice"):  # 9 channels a group
        t_gn.full_group_norm(x, w, b, 4)
    x = _bf16(rng, (2, 64, 64), cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        t_gn.full_group_norm(x.half(), w, b, 32)
    with pytest.raises(ValueError, match="weight"):
        t_gn.full_group_norm(x, w[:32], b, 32)
    with pytest.raises(TypeError, match="one dtype"):
        t_gn.full_group_norm(x, w.bfloat16(), b, 32)
    with pytest.raises(ValueError, match="aligned"):
        t_gn.full_group_norm(x.view(-1)[4:4 + 64 * 100].view(1, 100, 64),
                             w, b, 32)


@pytest.mark.cuda
def test_gn_mode_routes_cuda_tensors(cuda, monkeypatch):
    rng = np.random.default_rng(15)
    x = _bf16(rng, (2, 256, 64), cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    for key in ("VIDTOME_GN_MODE", "VIDTOME_DISABLE_PALLAS_GN"):
        monkeypatch.delenv(key, raising=False)
    counts = lambda: (t_gn.group_norm.launches,  # noqa: E731
                      t_gn.full_group_norm.launches)
    for mode, step in (("auto", (0, 1)), ("stats", (2, 0)), ("full", (0, 1))):
        monkeypatch.setenv("VIDTOME_GN_MODE", mode)
        before = counts()
        t_gn.group_norm(x, w, b, 32, 1e-5, True)
        assert counts() == (before[0] + step[0], before[1] + step[1]), mode
    monkeypatch.setenv("VIDTOME_GN_MODE", "xla")
    with pytest.raises(ValueError, match="xla"):
        t_gn.group_norm(x, w, b, 32)
    monkeypatch.setenv("VIDTOME_GN_MODE", "full")
    monkeypatch.setenv("VIDTOME_DISABLE_PALLAS_GN", "1")
    with pytest.raises(ValueError, match="xla"):
        t_gn.group_norm(x, w, b, 32)


def _geglu_input(cuda, rows, inner, dtype, seed=0):
    """[..., 2 * inner] projection outputs drawn on the card (gate values
    across gelu's bend and tails)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((*rows, 2 * inner), generator=gen, device=cuda)
            * 2.0).to(dtype)


def _bits(t):
    """t's bits as integers: equal bits, not equal values (-0 is not 0, a
    NaN is itself)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _check_geglu(y):
    before = t_geglu.geglu.launches
    got = t_geglu.geglu(y)
    want = t_geglu.geglu_plain(y)
    torch.cuda.synchronize()
    assert t_geglu.geglu.launches == before + 1
    assert got.shape == want.shape and got.dtype == y.dtype
    assert got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want)), (
        int((_bits(got) != _bits(want)).sum()),
        (got.float() - want.float()).abs().max().item())


# (tokens, inner) at each level of SD1.5 / SD2.x at 512x512
GEGLU_LEVELS = [(4096, 1280), (1024, 2560), (256, 5120), (64, 5120)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens,inner", GEGLU_LEVELS)
@pytest.mark.parametrize("batch", [8, 12, 32, 56, 84])
def test_geglu_kernel_equals_plain_at_the_cells_rows(cuda, batch, tokens,
                                                     inner, dtype):
    """Inversion (32 rows), the first chunk (8 / 12) and the batched call
    (56 / 84) of both cells, bit for bit."""
    _check_geglu(_geglu_input(cuda, (batch, tokens), inner, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,inner", [
    ((8, 4096), 2560), ((8, 1024), 5120),       # SDXL levels 1, 2
    ((8, 4096), 3072), ((8, 1024), 6144),       # the refiner's
    ((8, 256), 6144),                           # the refiner's mid block
    ((8, 4096), 640), ((12, 4096), 768),        # {model: 2} shares
    ((12, 4096), 512), ((6, 1024), 1280),
    ((3, 77), 37), ((2, 5), 1), ((4, 33), 12),  # odd widths: scalar path
    ((2, 300), 20), ((5,), 1284), ((1, 1), 8),
])
def test_geglu_kernel_equals_plain_at_other_widths(cuda, rows, inner, dtype):
    _check_geglu(_geglu_input(cuda, rows, inner, dtype, seed=inner))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geglu_kernel_gives_the_same_bits_twice(cuda, dtype):
    y = _geglu_input(cuda, (56, 4096), 1280, dtype, seed=3)
    got = t_geglu.geglu(y)
    again = t_geglu.geglu(y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))


@pytest.mark.cuda
def test_geglu_kernel_handles_infinities_and_zeros(cuda):
    """gelu's limits as the eager path computes them, bit for bit: a -inf
    gate gives -inf * 0 (NaN), +inf the product with inf, zeros zero."""
    y = _geglu_input(cuda, (4, 64), 1280, torch.bfloat16, seed=4)
    y[0, :, 1280:] = float("-inf")
    y[1, :, 1280:] = float("inf")
    y[2, :, 1280:] = 0.0
    y[3, :, :1280] = 0.0
    _check_geglu(y)


@pytest.mark.cuda
def test_geglu_kernel_launches_on_the_current_stream(cuda):
    y = _geglu_input(cuda, (8, 1024), 2560, torch.bfloat16, seed=5)
    want = t_geglu.geglu(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert (torch._C._cuda_getCurrentRawStream(y.get_device())
                == side.cuda_stream)
        got = t_geglu.geglu(y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_geglu_kernel_refuses_what_it_cannot_take(cuda):
    y = _geglu_input(cuda, (4, 64), 64, torch.bfloat16)
    before = t_geglu.geglu.launches
    with pytest.raises(TypeError):
        t_geglu.geglu(y.half())
    with pytest.raises(ValueError, match="contiguous"):
        t_geglu.geglu(y.transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        t_geglu.geglu(y[..., :64])
    flat = torch.zeros(4 * 64 * 128 + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        t_geglu.geglu(flat[1:1 + 4 * 64 * 128].view(4, 64, 128))
    assert t_geglu.geglu.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geglu_module_launches_the_kernel_once_a_call(cuda, dtype):
    torch.manual_seed(6)
    mod = GEGLU(320, 1280).to(cuda, dtype)
    x = torch.randn(2, 256, 320, device=cuda).to(dtype)
    with torch.no_grad():
        before = t_geglu.geglu.launches
        got = mod(x)
        assert t_geglu.geglu.launches == before + 1
        mod(x)
        assert t_geglu.geglu.launches == before + 2
        h, gate = mod.proj(x).chunk(2, dim=-1)
        assert torch.equal(_bits(got),
                           _bits(h * torch.nn.functional.gelu(gate)))
