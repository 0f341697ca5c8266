"""Fused ResnetBlock2D: a hand-written Hopper kernel and its plain version.

Counterpart of ``vidtome_tpu/ops/resnet.py``.  :func:`fused_resnet`
replaces the Pallas ``fused_resnet`` (bf16; the W8A8 variant is not
ported): on a CUDA tensor it runs the block as

  1. GN1 statistics of x (the Triton statistics passes of
     ``ops/groupnorm.py``);
  2. conv1 (``csrc/resnet.cu``): GN1 normalize+SiLU as the input tile is
     loaded, +b1+tvec, h stored bf16, per-tile fp32 channel sums of h for
     GN2;
  3. GN2 statistics from those partials (the Triton reduction pass, fixed
     order, no atomics);
  4. conv2 (``csrc/resnet.cu``): GN2 normalize+SiLU prologue, +b2
     +shortcut epilogue, the block output bf16;

and on a CPU tensor it runs :func:`reference_fused_resnet`.  As in the JAX
package, the time-embedding projection (``tvec``) and the 1x1 projection
shortcut are computed outside the kernel, the latter as a plain matmul.
The source note in ``csrc/resnet.cu`` says what bounds the kernel and how
its design answers.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from vidtome_torch.ops import groupnorm
from vidtome_torch.ops.cuda_build import build_library


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


def _conv3x3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 convolution, zero padding 1, in fp32: a [B, H, W, Ci] NHWC,
    w [Co, Ci, 3, 3] -> [B, H, W, Co]."""
    return F.conv2d(a.float().permute(0, 3, 1, 2), w.float(),
                    padding=1).permute(0, 2, 3, 1)


def reference_fused_resnet(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight,
                           n2_bias, w2, b2, ws=None, bs=None,
                           num_groups1: int = 32, num_groups2: int = 32,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the kernel's arithmetic, in x's dtype at the
    kernel's rounding points: the activations entering each conv and h are
    rounded to x's dtype, the convolutions and GroupNorm statistics run in
    fp32, GN2's statistics are taken on h before rounding.  In fp32 this is
    the unfused ``ResnetBlock2D``.

    x [B, H, W, Ci]; tvec [B, Co] (silu(temb) @ W_t + b_t); conv weights
    [Co, Ci, 3, 3] (PyTorch layout); ws [Co, Ci] and bs [Co] for a
    projection shortcut, None for identity."""
    h = _conv3x3(_gn_silu(x, x, n1_weight, n1_bias, num_groups1, eps), w1)
    h = h + (b1.float() + tvec.float())[:, None, None, :]
    a2 = _gn_silu(h.to(x.dtype), h, n2_weight, n2_bias, num_groups2, eps)
    sc = x if ws is None else F.linear(x, ws.to(x.dtype), bs.to(x.dtype))
    out = _conv3x3(a2, w2) + b2.float() + sc.float()
    return out.to(x.dtype)


@functools.cache
def _library():
    lib = build_library("vidtome_resnet", ("resnet.cu",))
    fn = lib.vidtome_resnet_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tile_width(W: int) -> int:
    """Width of the kernel's 128-pixel tile for an image W pixels wide."""
    return 32 if W >= 32 else 16 if W >= 16 else 8


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _conv(x, mean, rstd, gamma, beta, w_packed, bias, tvec, resid, groups,
          partials: bool):
    """One launch of ``vidtome_resnet_conv3x3``; returns (out, psum, psq)."""
    B, H, W, Cin = x.shape
    Cout = w_packed.shape[0]
    tw = _tile_width(W)
    n_tiles = -(-H // (128 // tw)) * -(-W // tw)
    out = torch.empty(B, H, W, Cout, dtype=torch.bfloat16, device=x.device)
    psum = psq = None
    if partials:
        psum = torch.empty(B, n_tiles, Cout, dtype=torch.float32,
                           device=x.device)
        psq = torch.empty_like(psum)
    err = _library()(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), w_packed.data_ptr(), bias.data_ptr(), _ptr(tvec),
        _ptr(resid), out.data_ptr(), _ptr(psum), _ptr(psq), B, H, W, Cin,
        Cout, groups, tw, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused resnet conv launch failed: error {err} "
                           f"(x{tuple(x.shape)} -> {Cout} channels)")
    return out, psum, psq


def _launch(x, tvec, n1_weight, n1_bias, w1, b1, n2_weight, n2_bias, w2, b2,
            ws, bs, num_groups1, num_groups2, eps):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused resnet kernel takes bf16, got {x.dtype}")
    B, H, W, Ci = x.shape
    Co = w1.shape[0]
    if (w1.shape != (Co, Ci, 3, 3) or w2.shape != (Co, Co, 3, 3)
            or (ws is None) != (Ci == Co) or tvec.shape != (B, Co)):
        raise ValueError(f"fused resnet: inconsistent shapes x{tuple(x.shape)}"
                         f" w1{tuple(w1.shape)} w2{tuple(w2.shape)} "
                         f"tvec{tuple(tvec.shape)}")
    if Ci % 8 or Co % 8 or Ci % num_groups1 or Co % num_groups2:
        raise ValueError(f"fused resnet: channels {Ci} -> {Co} must be "
                         f"multiples of 8 and of the group counts")
    vectors = {"n1_weight": (n1_weight, Ci), "n1_bias": (n1_bias, Ci),
               "b1": (b1, Co), "n2_weight": (n2_weight, Co),
               "n2_bias": (n2_bias, Co), "b2": (b2, Co)}
    if ws is not None:
        vectors["bs"] = (bs, Co)
        if ws.shape != (Co, Ci):
            raise ValueError(f"ws: expected [{Co}, {Ci}], got "
                             f"{tuple(ws.shape)}")
    for name, (t, n) in vectors.items():
        if t is None or t.shape != (n,):
            raise ValueError(f"{name}: expected [{n}], got "
                             f"{None if t is None else tuple(t.shape)}")
    for name, t in (("w1", w1), ("w2", w2), ("tvec", tvec), ("ws", ws),
                    *((k, v[0]) for k, v in vectors.items())):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    bf16 = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    x = x.contiguous()
    # weights [Co, Ci, 3, 3] -> [Co, 3, 3, Ci]: one tap's channels contiguous
    w1p = bf16(w1.permute(0, 2, 3, 1))
    w2p = bf16(w2.permute(0, 2, 3, 1))
    mean1, rstd1 = groupnorm.group_stats(x, num_groups1, eps)
    h, psum, psq = _conv(x, mean1, rstd1, f32(n1_weight), f32(n1_bias), w1p,
                         f32(b1), f32(tvec), None, num_groups1, True)
    mean2, rstd2 = groupnorm.stats_from_partials(psum, psq, num_groups2,
                                                 H * W, eps)
    sc = x if ws is None else bf16(F.linear(x, bf16(ws), bf16(bs)))
    out, _, _ = _conv(h, mean2, rstd2, f32(n2_weight), f32(n2_bias), w2p,
                      f32(b2), None, sc, num_groups2, False)
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


fused_resnet.launches = 0
