"""Fused ResnetBlock2D: hand-written Hopper kernels and their plain version.

Counterpart of ``vidtome_tpu/ops/resnet.py``.  :func:`fused_resnet`
replaces the Pallas ``fused_resnet`` with bf16 weights and
:func:`fused_resnet_w8a8` its W8A8 variant (``quant=True``: int8 weights
and activations).  On a CUDA tensor either runs the block as

  1. GN1 statistics of x (the stats entry of ``ops/groupnorm.py``, one
     launch);
  2. conv1 (bf16: ``csrc/resnet_bf16.cu``, W8A8: ``csrc/resnet_w8a8.cu``):
     GN1 normalize+SiLU as the input tile is staged (W8A8: then quantized
     with the static post-norm scale), +b1+tvec (W8A8: after dequantizing),
     h stored bf16, per-tile fp32 channel sums of h for GN2;
  3. GN2 statistics from those partials (the finalize entry of
     ``ops/groupnorm.py``: fixed order, no atomics);
  4. conv2 (the same kernel): GN2 normalize+SiLU (+quantize) prologue,
     +b2 +shortcut epilogue, the block output bf16;

and on a CPU tensor it runs :func:`reference_fused_resnet`.  As in the JAX
package, the time-embedding projection (``tvec``) and the 1x1 projection
shortcut are computed outside the kernel, the latter as a plain matmul in
bf16 also under W8A8.  The conv weights are read as [Co, 3, 3, Ci]
storage: ``ResnetBlock2D`` keeps its OIHW weights as views of such storage
(``models/layers.py``), as the int8 tables do, so no call repacks them.
The kernels' tiles and output channels a block come from
:func:`conv_plan` (bf16) and :func:`conv_plan_w8a8`.  The source notes say
what bounds each kernel and how its design answers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vidtome_torch.ops import groupnorm
from vidtome_torch.ops.cuda_build import build_library
from vidtome_torch.ops.quant import (int8_conv_acc, packed_conv_weight,
                                     static_act_scale)


def _gn_silu(x: torch.Tensor, stats_of: torch.Tensor, weight, bias,
             num_groups: int, eps: float) -> torch.Tensor:
    """silu(groupnorm(x)) with the statistics of ``stats_of`` (fp32, the
    same shape), rounded to x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    s = stats_of.float().reshape(B, -1, num_groups, C // num_groups)
    mean = s.mean(dim=(1, 3), keepdim=True)
    var = ((s * s).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0)
    y = (x.float().reshape(s.shape) - mean) * torch.rsqrt(var + eps)
    y = y.reshape(x.shape) * weight.float() + bias.float()
    return F.silu(y).to(x.dtype)


def _conv3x3(a: torch.Tensor, w: torch.Tensor, w_scale=None,
             sx=None) -> torch.Tensor:
    """3x3 convolution, zero padding 1, in fp32: a [B, H, W, Ci] NHWC,
    w [Co, Ci, 3, 3] -> [B, H, W, Co].  W8A8 (``w`` int8, ``w_scale`` [Co],
    ``sx`` the activation scale): a quantized as the kernel does,
    round(a * (1 / sx)) clamped to +-127, exact int32 sums, dequantized once
    by sx * w_scale."""
    if w_scale is None:
        return F.conv2d(a.float().permute(0, 3, 1, 2), w.float(),
                        padding=1).permute(0, 2, 3, 1)
    q = torch.round(a.float() * (1.0 / sx)).clamp(-127, 127).to(torch.int8)
    return int8_conv_acc(q, w).float() * (sx * w_scale)


def reference_fused_resnet(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight,
                           n2_bias, w2, b2, ws=None, bs=None,
                           num_groups1: int = 32, num_groups2: int = 32,
                           eps: float = 1e-5, w1_scale=None, w2_scale=None,
                           quant: bool = False,
                           act_scales=None) -> torch.Tensor:
    """Plain version of the kernels' arithmetic, in x's dtype at the
    kernels' rounding points: the activations entering each conv and h are
    rounded to x's dtype, the convolutions and GroupNorm statistics run in
    fp32, GN2's statistics are taken on h before rounding.  In fp32 this is
    the unfused ``ResnetBlock2D``.

    x [B, H, W, Ci]; tvec [B, Co] (silu(temb) @ W_t + b_t); conv weights
    [Co, Ci, 3, 3] (PyTorch layout); ws [Co, Ci] and bs [Co] for a
    projection shortcut, None for identity.  ``quant=True`` is W8A8: w1 and
    w2 int8 with per-channel scales w1_scale / w2_scale [Co], each conv's
    activation quantized with the static scale of its norm (``act_scales``,
    or :func:`~vidtome_torch.ops.quant.static_act_scale` of the norm
    affine), int32 sums dequantized once per output."""
    if quant:
        if w1_scale is None or w2_scale is None:
            raise ValueError("quant=True needs w1_scale and w2_scale")
        sx1, sx2 = act_scales or (static_act_scale(n1_weight, n1_bias),
                                  static_act_scale(n2_weight, n2_bias))
        q1, q2 = (w1_scale.float(), sx1), (w2_scale.float(), sx2)
    else:
        q1 = q2 = (None, None)
    h = _conv3x3(_gn_silu(x, x, n1_weight, n1_bias, num_groups1, eps), w1,
                 *q1)
    h = h + (b1.float() + tvec.float())[:, None, None, :]
    a2 = _gn_silu(h.to(x.dtype), h, n2_weight, n2_bias, num_groups2, eps)
    sc = x if ws is None else F.linear(x, ws.to(x.dtype), bs.to(x.dtype))
    out = _conv3x3(a2, w2, *q2) + b2.float() + sc.float()
    return out.to(x.dtype)


@functools.cache
def _library():
    bf16 = build_library("vidtome_resnet_bf16",
                         ("resnet_bf16.cu",)).vidtome_resnet_conv3x3
    bf16.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    w8a8 = build_library("vidtome_resnet_w8a8",
                         ("resnet_w8a8.cu",)).vidtome_resnet_conv3x3_w8a8
    w8a8.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    for fn in (bf16, w8a8):
        fn.restype = ctypes.c_int
    return bf16, w8a8


H100_SMS = 132
# the bf16 kernel's pixel tiles, (height, width, consumer warpgroups of
# 8 x 8 pixels), and output channels a block, as csrc/resnet_bf16.cu
# instantiates them
_TILES = ((16, 8, 2), (8, 8, 1))
_BLOCK_N = (160, 64)
# the cost of activating one halo pixel of a 64-channel chunk, counted in
# output channels of one pixel's products (the prologue's tanh per element
# against the tensor cores' rate)
_HALO_COST = 64
# the W8A8 kernel's launches, (consumer warpgroups side by side along the
# output channels, output channels a block), as csrc/resnet_w8a8.cu
# instantiates them, each on an 8 x 8 pixel tile
_W8A8_TILES = ((2, 320), (1, 64))


class ConvPlan(NamedTuple):
    """One conv launch: the pixel tile (``tile_h`` x ``tile_w``), its
    consumer warpgroups (bf16: each 8 rows of 8 pixels; W8A8: each
    ``block_n / warpgroups`` of the channels), ``block_n`` output channels
    a block, the pixel tiles of one image (the GN2 partials' middle
    dimension), the grid (tiles, output-channel blocks, batch) and the
    dynamic shared memory a block takes (the weight ring, three halo
    buffers of 8 planes of 16-byte pixel rows, the barriers, 1024 bytes of
    alignment slack)."""
    tile_h: int
    tile_w: int
    warpgroups: int
    block_n: int
    tiles: int
    grid: tuple[int, int, int]
    smem: int

    @property
    def arg(self) -> int:
        """The C entry's ``tile`` argument."""
        return self.warpgroups | self.block_n << 8


def _smem(tile_h: int, block_n: int, stages: int) -> int:
    """Dynamic shared memory of a conv block: the weight ring (``block_n``
    rows of 128 bytes a stage: 64 bf16 or 128 int8 channels), three halo
    buffers of 8 planes of 16-byte pixel rows (an odd number of them), the
    ring's barriers and 1024 bytes of alignment slack."""
    halo = (tile_h + 2) * 10
    return stages * block_n * 128 + 3 * 8 * (halo | 1) * 16 + 16 * stages \
        + 1024


def conv_plan(B: int, H: int, W: int, Cin: int, Cout: int,
              sms: int = H100_SMS) -> ConvPlan:
    """The pixel tile and output channels a block of the bf16 conv at
    [B, H, W, Cin] -> Cout on a card of ``sms`` SMs.  The 16 x 8 tile (two
    warpgroups) only where the image is more than 8 high: no tile's first
    row of tiles is half empty or more.  Among the choices whose grid
    fills a wave (at least ``sms`` blocks), the one of least cost: the
    busiest SM's blocks, ceil(blocks / sms), times a block's products and
    halo activation; where none fills a wave, the one with the most blocks
    (then the least cost)."""
    plans = []
    for th, tw, wgs in _TILES:
        if th > 8 and th >= 2 * H:
            continue
        tiles = -(-H // th) * -(-W // tw)
        halo = (th + 2) * (tw + 2)
        for bn in _BLOCK_N:
            blocks = tiles * -(-Cout // bn) * B
            cost = -(-blocks // sms) * (th * tw * bn + _HALO_COST * halo)
            # the weight ring: 3 stages where two blocks share an SM
            stages = 3 if wgs == 1 and bn > 64 else 4
            plans.append((blocks < sms, cost if blocks >= sms else -blocks,
                           cost, ConvPlan(th, tw, wgs, bn, tiles,
                                          (tiles, -(-Cout // bn), B),
                                          _smem(th, bn, stages))))
    return min(plans, key=lambda p: p[:3])[3]


def conv_plan_w8a8(B: int, H: int, W: int, Cin: int, Cout: int,
                   sms: int = H100_SMS) -> ConvPlan:
    """The launch of the W8A8 conv at [B, H, W, Cin] -> Cout on a card of
    ``sms`` SMs: an 8 x 8 pixel tile, two consumer warpgroups of 160
    output channels each or one of 64 (``_W8A8_TILES``).  A block holds an
    SM (the card allocates registers by whole warpgroups), and the
    activation of the halo, not the products, bounds the kernel: the plan
    of least cost, the busiest SM's blocks, ceil(blocks / sms), times a
    block's products and halo activation (an int8 chunk activates 128
    channels for products of a bf16 chunk's time, so twice the bf16 plan's
    halo cost); then the more blocks."""
    tiles = -(-H // 8) * -(-W // 8)
    plans = []
    for wgs, bn in _W8A8_TILES:
        blocks = tiles * -(-Cout // bn) * B
        cost = -(-blocks // sms) * (64 * bn + 2 * _HALO_COST * 100)
        plans.append((cost, -blocks, ConvPlan(
            8, 8, wgs, bn, tiles, (tiles, -(-Cout // bn), B),
            _smem(8, bn, 4))))
    return min(plans, key=lambda p: p[:2])[2]


def weight_map(Cin: int, Cout: int, block_n: int, w8a8: bool = False):
    """The TMA view of the packed weight [Cout, 3, 3, Cin] (bf16, or int8
    with ``w8a8``) that the conv kernels read their B tiles through
    (``hopper.cuh``, ``encode_conv_weights``): dims (Cin, 9 taps, Cout, 1),
    innermost first, byte strides of the outer three, and the box (128
    bytes of channels: 64 bf16 or 128 int8, 1 tap, ``block_n`` rows, 1).
    Past Cin (a ragged last chunk) and past Cout TMA reads zeros; a 2-D
    [Cout, 9 * Cin] view would read the next tap's channels instead."""
    e = 1 if w8a8 else 2
    return ((Cin, 9, Cout, 1), (e * Cin, 9 * e * Cin, 9 * e * Cin * Cout),
            (128 // e, 1, block_n, 1))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(x: torch.Tensor) -> int:
    """The current stream's raw handle on x's card (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _conv(x, mean, rstd, gamma, beta, w_packed, bias, tvec, resid, groups,
          partials: bool, quant=None):
    """One launch of a conv kernel (``quant``: (act_scale, w_scale) for
    the W8A8 variant); returns (out, psum, psq)."""
    B, H, W, Cin = x.shape
    Cout = w_packed.shape[0]
    plan = (conv_plan if quant is None else conv_plan_w8a8)(
        B, H, W, Cin, Cout, _sm_count(x.get_device()))
    out = torch.empty(B, H, W, Cout, dtype=torch.bfloat16, device=x.device)
    psum = psq = None
    if partials:
        psum = torch.empty(B, plan.tiles, Cout, dtype=torch.float32,
                           device=x.device)
        psq = torch.empty_like(psum)
    norm = (x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
            beta.data_ptr())
    tail = (bias.data_ptr(), _ptr(tvec), _ptr(resid), out.data_ptr(),
            _ptr(psum), _ptr(psq), B, H, W, Cin, Cout, groups, plan.arg,
            _stream(x))
    bf16_fn, w8a8_fn = _library()
    if quant is None:
        err = bf16_fn(*norm, w_packed.data_ptr(), *tail)
    else:
        act_scale, w_scale = quant
        err = w8a8_fn(*norm, act_scale.data_ptr(), w_packed.data_ptr(),
                      w_scale.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"fused resnet conv launch failed: error {err} "
                           f"(x{tuple(x.shape)} -> {Cout} channels"
                           f"{', W8A8' if quant else ''})")
    return out, psum, psq


def _check(x, tvec, w1, w2, vectors: dict, ws, align: int, num_groups1,
           num_groups2) -> None:
    """Shapes and devices of a fused block's operands; raises on anything
    the kernels do not take."""
    B, H, W, Ci = x.shape
    Co = w1.shape[0]
    if (w1.shape != (Co, Ci, 3, 3) or w2.shape != (Co, Co, 3, 3)
            or (ws is None) != (Ci == Co) or tvec.shape != (B, Co)):
        raise ValueError(f"fused resnet: inconsistent shapes x{tuple(x.shape)}"
                         f" w1{tuple(w1.shape)} w2{tuple(w2.shape)} "
                         f"tvec{tuple(tvec.shape)}")
    if Ci % align or Co % align or Ci % num_groups1 or Co % num_groups2:
        raise ValueError(f"fused resnet: channels {Ci} -> {Co} must be "
                         f"multiples of {align} and of the group counts")
    if ws is not None and ws.shape != (Co, Ci):
        raise ValueError(f"ws: expected [{Co}, {Ci}], got {tuple(ws.shape)}")
    for name, (t, n) in vectors.items():
        if t is None or t.shape != n:
            raise ValueError(f"{name}: expected {list(n)}, got "
                             f"{None if t is None else tuple(t.shape)}")
    for name, t in (("w1", w1), ("w2", w2), ("tvec", tvec), ("ws", ws),
                    *((k, v[0]) for k, v in vectors.items())):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def _launch(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias, w2, b2,
            ws, bs, num_groups1, num_groups2, eps, quant=None):
    """The block on the card; ``quant``: (w1_scale, w2_scale, sx1, sx2)
    with int8 w1, w2 for W8A8, else None (bf16 weights)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused resnet kernel takes bf16, got {x.dtype}")
    B, H, W, Ci = x.shape
    Co = w1.shape[0]
    vectors = {"n1_weight": (n1_weight, (Ci,)), "n1_bias": (n1_bias, (Ci,)),
               "b1": (b1, (Co,)), "n2_weight": (n2_weight, (Co,)),
               "n2_bias": (n2_bias, (Co,)), "b2": (b2, (Co,))}
    if ws is not None:
        vectors["bs"] = (bs, (Co,))
    if quant is not None:
        vectors.update(w1_scale=(quant[0], (Co,)), w2_scale=(quant[1], (Co,)),
                       act_scale1=(quant[2], ()), act_scale2=(quant[3], ()))
        for name, w in (("w1", w1), ("w2", w2)):
            if w.dtype != torch.int8:
                raise TypeError(f"W8A8 fused resnet: {name} must be int8, got "
                                f"{w.dtype}")
    _check(x, tvec, w1, w2, vectors, ws, 8 if quant is None else 32,
           num_groups1, num_groups2)
    x = x.contiguous()
    # the weights as [Co, 3, 3, Ci], one tap's channels contiguous: a free
    # view of the OIHW views of packed storage that ResnetBlock2D and the
    # int8 tables hold (any other layout is copied)
    if quant is None:
        w1p = packed_conv_weight(w1.to(torch.bfloat16))
        w2p = packed_conv_weight(w2.to(torch.bfloat16))
        q1 = q2 = None
    else:
        w1p, w2p = packed_conv_weight(w1), packed_conv_weight(w2)
        s1, s2, sx1, sx2 = (_f32(t) for t in quant)
        q1, q2 = (sx1, s1), (sx2, s2)
    mean1, rstd1 = groupnorm.group_stats(x, num_groups1, eps)
    h, psum, psq = _conv(x, mean1, rstd1, _f32(n1_weight), _f32(n1_bias),
                         w1p, _f32(b1), _f32(tvec), None, num_groups1, True,
                         q1)
    mean2, rstd2 = groupnorm.stats_from_partials(psum, psq, num_groups2,
                                                 H * W, eps)
    sc = x if ws is None else _bf16(F.linear(x, _bf16(ws), _bf16(bs)))
    out, _, _ = _conv(h, mean2, rstd2, _f32(n2_weight), _f32(n2_bias), w2p,
                      _f32(b2), None, sc, num_groups2, False, q2)
    return out


def fused_resnet(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias,
                 w2, b2, ws=None, bs=None, num_groups1: int = 32,
                 num_groups2: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """shortcut(x) + conv2(silu(gn2(conv1(silu(gn1(x))) + b1 + tvec))) + b2
    for x [B, H, W, Ci]; arguments as :func:`reference_fused_resnet`.

    CUDA tensors launch the Hopper kernel (bf16 only; anything it cannot
    take raises); CPU tensors run :func:`reference_fused_resnet`."""
    args = (x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias, w2, b2,
            ws, bs, num_groups1, num_groups2, eps)
    if not x.is_cuda:
        return reference_fused_resnet(*args)
    out = _launch(*args)
    fused_resnet.launches += 1
    return out


def fused_resnet_w8a8(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias,
                      w2, b2, ws=None, bs=None, num_groups1: int = 32,
                      num_groups2: int = 32, eps: float = 1e-5, *,
                      w1_scale, w2_scale, act_scales=None) -> torch.Tensor:
    """The W8A8 block: w1, w2 int8 [Co, Ci, 3, 3] (best an OIHW view of
    packed [Co, 3, 3, Ci] storage, as the int8 tables hold them) with fp32
    per-channel scales; ``act_scales`` the static activation scales of
    conv1 and conv2 (None: from the norm affines).  Replaces Pallas
    ``fused_resnet(..., quant=True)``.

    CUDA tensors launch the Hopper kernel (bf16 activations, Ci and Co
    multiples of 32; anything else raises); CPU tensors run
    :func:`reference_fused_resnet` with ``quant=True``."""
    if act_scales is None:
        act_scales = (static_act_scale(n1_weight, n1_bias),
                      static_act_scale(n2_weight, n2_bias))
    args = (x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias, w2, b2,
            ws, bs, num_groups1, num_groups2, eps)
    if not x.is_cuda:
        return reference_fused_resnet(*args, w1_scale=w1_scale,
                                      w2_scale=w2_scale, quant=True,
                                      act_scales=act_scales)
    out = _launch(*args, quant=(w1_scale, w2_scale, *act_scales))
    fused_resnet_w8a8.launches += 1
    return out


fused_resnet.launches = 0
fused_resnet_w8a8.launches = 0
