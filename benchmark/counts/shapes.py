"""Operations and bytes of the UNet's and the VAE's layers from shapes."""

from __future__ import annotations

import math


def linear(rows: int, k: int, n: int) -> float:
    """A dense layer [rows, k] @ [k, n]."""
    return 2.0 * rows * k * n


def conv(batch: int, ho: int, wo: int, cin: int, cout: int, kh: int,
         kw: int) -> float:
    """A convolution's products at output size ho x wo."""
    return 2.0 * batch * ho * wo * cin * cout * kh * kw


def attention_core(batch: int, heads: int, sq: int, skv: int,
                   d: int) -> float:
    """Scores and the weighted sum: two products of sq x skv x d a head."""
    return 4.0 * batch * heads * sq * skv * d


def cross_attention(x_shape, ctx_shape, heads: int, head_dim: int,
                    shared_lanes: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one attention call: x [B, S, C], the context
    [B, Skv, Cctx] (None: self-attention), q, k, v and out projections
    (out with a bias) and the core.  Under PnP's shared q and k
    (``shared_lanes`` L > 1) only lane 0's rows are projected to q and k."""
    B, S, C = x_shape
    inner = heads * head_dim
    cross = ctx_shape is not None
    Bc, Skv, Cc = ctx_shape if cross else x_shape
    qk_rows = B // shared_lanes
    flops = (linear(qk_rows * S, C, inner) + linear(qk_rows * Skv, Cc, inner)
             + linear(Bc * Skv, Cc, inner) + linear(B * S, inner, C)
             + attention_core(B, heads, S, Skv, head_dim))
    weights = C * inner + 2 * Cc * inner + inner * C + C
    acts = B * S * C * 2 + (Bc * Skv * Cc if cross else 0)
    return flops, float((weights + acts) * itemsize)


def resnet_block(x_shape, temb_shape, cout: int,
                 itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of a ResnetBlock2D: x [B, H, W, Cin], the time
    embedding [B, T]; two 3x3 convolutions, the time projection, a 1x1
    shortcut where the widths differ, the two norms' affine parameters."""
    B, H, W, Cin = x_shape
    T = temb_shape[-1]
    flops = (conv(B, H, W, Cin, cout, 3, 3) + conv(B, H, W, cout, cout, 3, 3)
             + linear(B, T, cout))
    weights = 9 * Cin * cout + 9 * cout * cout + T * cout + 3 * cout
    weights += 2 * Cin + 2 * cout
    if Cin != cout:
        flops += conv(B, H, W, Cin, cout, 1, 1)
        weights += Cin * cout + cout
    acts = B * H * W * (Cin + cout) + B * T
    return flops, float((weights + acts) * itemsize)


def layer(module_kind: str, in_shape, out_shape, weight_shape) -> float:
    """Operations of one dense layer or convolution, from its input,
    output and weight shapes (channels last)."""
    if module_kind == "linear":
        rows = math.prod(in_shape[:-1])
        return linear(rows, weight_shape[1], weight_shape[0])
    B, Ho, Wo, Cout = out_shape
    cout, cin_g, kh, kw = weight_shape
    return conv(B, Ho, Wo, cin_g, Cout, kh, kw)
