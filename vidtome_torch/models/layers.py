"""Building blocks of the Stable Diffusion UNet, NHWC at every boundary.

Counterpart of ``vidtome_tpu/models/layers.py``.  Activations are
[B, H, W, C] (or [B, S, C] tokens) as in the JAX package; a contiguous NHWC
tensor permuted to NCHW is already ``channels_last``, so ``F.conv2d`` takes
it without a copy.  Parameter names follow the diffusers layout
(``to_out.0``, ``ff.net.0.proj``, ``downsamplers.0.conv``), so a diffusers
checkpoint loads with few renames (``models/convert.py``).

On CUDA every GroupNorm runs the GroupNorm kernel (``ops/groupnorm.py``) and
every attention one of the attention kernels (``ops/attention.py``: the
single-pass kernel for KV of at most 256 tokens, flash above); with
``resnet_mode="fused"`` every ResnetBlock2D without a PnP injection runs
the fused resnet kernel (``ops/resnet.py``), and with
``sublayer_mode="fused"`` every bf16 TransformerBlock runs its
norm2 -> attn2 -> norm3 chain through the fused sublayer kernel
(``ops/sublayer.py``).  LayerNorm, the other convs and dense layers stay
PyTorch's, as the JAX package leaves them to XLA.

Int8 (W8A8, ``quant: int8``): every block takes the call's int8 table
``qt`` (``ops/quant.QuantTable``, None for the serving dtype); a
:class:`Linear` or :class:`Conv2d` that the table holds runs the int8
product of ``ops/quant.py``, the others their own weights.  A quantized
ResnetBlock2D under ``resnet_mode="fused"`` runs the W8A8 fused resnet
kernel (``ops/resnet.fused_resnet_w8a8``).

PnP (``control: pnp``) rides the batch as lane-major blocks
[source | uncond | cond]: :func:`inject_lane0` hands lane 0's values to
every lane, for the q and k of the injected self-attentions and for the
conv features of the injected resnet (JAX ``layers.py:344-430``).

On a mesh (``parallel/mesh.py``): a Linear that ``shard_params`` made
row-parallel sums its partial products over the model axis and adds its
bias after the sum (int8: the dynamic activation scale is the max over
the model axis, the int32 sums are summed exact); under the data axis a
block is given this rank's rows and their :class:`~vidtome_torch.parallel.
mesh.Rows` (``rows``), and gathers the whole batch where work crosses
rows: the token merging of a block (its matching, plans and banks are the
whole batch's, on every rank; attn1 runs on the joined rows that hold this
rank's) and PnP's lane 0.

Spans (``logging_utils.span``, in a profiler's trace only):
``vidtome/transformer`` a Transformer2D, ``vidtome/attn`` a CrossAttention
and a fused sublayer, ``vidtome/ff`` a feed-forward, ``vidtome/resnet`` a
ResnetBlock2D.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.core import merge as merge_ops
from vidtome_torch.logging_utils import span
from vidtome_torch.models.tome import ToMeCall
from vidtome_torch.ops import quant as quant_ops
from vidtome_torch.ops.attention import attention
from vidtome_torch.ops.geglu import geglu
from vidtome_torch.ops.groupnorm import group_norm
from vidtome_torch.ops.resnet import fused_resnet, fused_resnet_w8a8
from vidtome_torch.ops.sublayer import fused_cross_sublayer
from vidtome_torch.parallel.mesh import take_rows

RESNET_MODES = ("off", "fused")
SUBLAYER_MODES = ("off", "fused")


def inject_lane0(x: torch.Tensor, num_lanes: int, flag: bool = True,
                 rows=None) -> torch.Tensor:
    """Every lane's rows replaced by lane 0's when ``flag`` is true.  The
    batch is lane-major, ``num_lanes`` blocks of equal size (reference
    utils/pnp_utils.py:62-70,146-155); under the data axis ``x`` is this
    rank's ``rows`` of it, and lane 0's come from the whole batch."""
    if not flag or num_lanes < 2:
        return x
    if rows is None:
        return _tile_lanes(x[:x.shape[0] // num_lanes], num_lanes)
    return take_rows(rows.gather(x)[:rows.n // num_lanes],
                     rows.lane0(num_lanes))


def _tile_lanes(lane0: torch.Tensor, num_lanes: int) -> torch.Tensor:
    return lane0.repeat(num_lanes, *([1] * (lane0.ndim - 1)))


def timestep_embedding(t, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (flip_sin_to_cos, freq_shift 0):
    t [] or [B] -> [B, dim] fp32."""
    t = torch.as_tensor(t, dtype=torch.float32).reshape(-1)
    half = dim // 2
    log_period = torch.log(torch.tensor(max_period, dtype=torch.float32))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32)
                      / half)
    args = t[:, None] * freqs.to(t.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _bias(y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The int8 paths add the bias after the cast, in the output dtype
    (JAX ``layers.py:60-62``)."""
    return y if bias is None else y + bias.to(y.dtype)


def _fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [N, K]^T accumulated and returned in fp32 (bf16
    operands on the card stay bf16 in the GEMM)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = F.linear(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[0])


class Linear(nn.Linear):
    """nn.Linear whose call takes the int8 product where the call's table
    ``qt`` holds this layer (per-row or static activation scale).  ``tp``
    is its shard on the model axis (``parallel/mesh.TPShard``, None when
    whole); a row-parallel shard sums its partial products over that axis
    in fp32 and adds the bias once, after the sum, rounding to the
    activations' dtype once, as the whole layer's GEMM does."""

    tp = None

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        e = qt.get(self) if qt is not None else None
        tp = self.tp if self.tp is not None and self.tp.row_parallel else None
        if e is None:
            if tp is None:
                return super().forward(x)
            y = tp.reduce(_fp32_product(x, self.weight))
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(x.dtype)
        return _bias(quant_ops.int8_dense(
            x, e.weight, e.scale, self.weight.dtype, e.act_scale,
            reduce=None if tp is None else tp.reduce), self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC activations (OIHW weights, diffusers layout); the
    int8 convolution where the call's table ``qt`` holds this layer."""

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        e = qt.get(self) if qt is not None else None
        if e is None:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return _bias(quant_ops.int8_conv(x, e.weight, e.scale,
                                         self.weight.dtype, e.act_scale,
                                         stride=self.stride[0]), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) over channels-last input with fp32 statistics.  The
    group count halves until it divides the channels (tiny test widths; SD
    widths are multiples of 32)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        while channels % num_groups:
            num_groups //= 2
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, self.silu)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, emb: torch.Tensor, qt=None) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb, qt)), qt)


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> +temb -> GN+SiLU -> conv3x3 (+shortcut).

    ``resnet_mode="fused"`` (config key ``generation.resnet_mode`` /
    ``inversion.resnet_mode``, passed per call) runs the block through
    ``ops/resnet.fused_resnet`` on the same parameters: the kernel on a
    CUDA tensor (bf16; anything else raises), its plain version on a CPU
    tensor.  The time-embedding projection is computed here, in fp32, as
    the JAX package does (``layers.py:321-322``).

    PnP conv injection (``inject``, a bool, or None where the block takes
    none): when true, lanes 1.. take lane 0's features after conv2, before
    the shortcut.  A block given an ``inject`` never takes the fused
    kernel, whatever ``resnet_mode`` says (JAX ``layers.py:262-264``).

    With an int8 table ``qt`` that holds conv1 and conv2, the fused block
    is the W8A8 kernel; the time-embedding projection and the 1x1 shortcut
    stay in the serving dtype (JAX ``layers.py:306-341``).  The TPU's
    rule of fusing int8 blocks only at >= 4096 rows was a v5e measurement
    and is not carried over."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _apply(self, fn, *args, **kwargs):
        # wherever the block takes a device or dtype, conv1 and conv2 keep
        # their OIHW weights as views of packed [O, 3, 3, I] storage
        # (channels_last), which the fused kernels read without a copy
        super()._apply(fn, *args, **kwargs)
        for conv in (self.conv1, self.conv2):
            w = conv.weight
            if not w.is_contiguous(memory_format=torch.channels_last):
                w.data = w.data.contiguous(memory_format=torch.channels_last)
        return self

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                resnet_mode: str = "off", inject: bool | None = None,
                num_lanes: int = 1, qt=None, rows=None) -> torch.Tensor:
        if resnet_mode not in RESNET_MODES:
            raise ValueError(f"resnet_mode must be one of {RESNET_MODES}, "
                             f"got {resnet_mode!r}")
        with span("resnet"):
            if resnet_mode == "fused" and inject is None:
                return self._fused(x, temb, qt)
            h = self.conv1(self.norm1(x), qt)
            h = h + self.time_emb_proj(F.silu(temb), qt)[:, None, None, :]
            h = self.conv2(self.norm2(h), qt)
            if inject:
                h = inject_lane0(h, num_lanes, rows=rows)
            if self.conv_shortcut is not None:
                x = self.conv_shortcut(x, qt)
            return x + h

    def _fused(self, x: torch.Tensor, temb: torch.Tensor,
               qt) -> torch.Tensor:
        q1, q2 = (None, None) if qt is None else (qt.get(self.conv1),
                                                  qt.get(self.conv2))
        if (q1 is None) != (q2 is None):
            raise ValueError("the fused resnet needs conv1 and conv2 "
                             "quantized together")
        proj = self.time_emb_proj
        tvec = F.linear(F.silu(temb.float()), proj.weight.float(),
                        proj.bias.float())
        sc = self.conv_shortcut
        kw = dict(ws=None if sc is None else sc.weight[:, :, 0, 0],
                  bs=None if sc is None else sc.bias,
                  num_groups1=self.norm1.num_groups,
                  num_groups2=self.norm2.num_groups, eps=self.norm1.eps)
        n1, n2 = self.norm1, self.norm2
        if q1 is None:
            return fused_resnet(x, tvec, n1.weight, n1.bias, self.conv1.weight,
                                self.conv1.bias, n2.weight, n2.bias,
                                self.conv2.weight, self.conv2.bias, **kw)
        return fused_resnet_w8a8(
            x, tvec, n1.weight, n1.bias, q1.weight, self.conv1.bias,
            n2.weight, n2.bias, q2.weight, self.conv2.bias, w1_scale=q1.scale,
            w2_scale=q2.scale, act_scales=(q1.act_scale, q2.act_scale), **kw)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        return self.conv(x, qt)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], nearest neighbour."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                         mode="nearest").permute(0, 2, 3, 1)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x), qt)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None.

    ``share_qk`` (PnP source-attention injection): q and k come from lane
    0 for every lane, so all lanes reuse the source attention map on their
    own values (reference utils/pnp_utils.py:47-95).  Only lane 0's q and k
    are projected then: ``x[:B / num_lanes]``, or under the data axis
    ``lane0`` = (lane 0's rows of the whole batch, each row of x's place
    among them) (a self-attention's).

    On the model axis (``parallel/mesh.shard_params``) ``heads`` is this
    rank's share of :attr:`total_heads`."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    @property
    def total_heads(self) -> int:
        """The heads of the layer, every model rank's together."""
        tp = self.to_q.tp
        return self.heads if tp is None else sum(tp.sizes) // self.head_dim

    def whole_weights(self) -> tuple[torch.Tensor, ...]:
        """The to_q, to_k, to_v and to_out.0 weights of every head: this
        rank's own where the layer is whole, else gathered over the model
        axis once and kept until a shard changes (a collective: every model
        rank asks at once)."""
        lins = (self.to_q, self.to_k, self.to_v, self.to_out[0])
        if self.to_q.tp is None:
            return tuple(lin.weight for lin in lins)
        key = tuple((lin.weight.data_ptr(), lin.weight._version)
                    for lin in lins)
        cached = self.__dict__.get("_whole")
        if cached is None or cached[0] != key:
            cached = self.__dict__["_whole"] = (
                key, tuple(lin.tp.gather(lin.weight) for lin in lins))
        return cached[1]

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                share_qk: bool = False, num_lanes: int = 1,
                qt=None, lane0=None) -> torch.Tensor:
        ctx = x if context is None else context
        B, S, _ = x.shape

        def heads(t):  # [B, s, H*D] -> [B, H, s, D] view
            return t.view(B, t.shape[1], self.heads,
                          self.head_dim).transpose(1, 2)

        with span("attn", "self" if context is None else "cross"):
            if share_qk and num_lanes > 1 and lane0 is not None:
                src, index = lane0
                q = take_rows(self.to_q(src, qt), index)
                k = take_rows(self.to_k(src, qt), index)
            elif share_qk and num_lanes > 1:
                q = _tile_lanes(self.to_q(x[:B // num_lanes], qt), num_lanes)
                k = _tile_lanes(
                    self.to_k(ctx[:ctx.shape[0] // num_lanes], qt), num_lanes)
            else:
                q, k = self.to_q(x, qt), self.to_k(ctx, qt)
            out = attention(heads(q), heads(k), heads(self.to_v(ctx, qt)))
            out = out.transpose(1, 2).reshape(B, S,
                                              self.heads * self.head_dim)
            return self.to_out[0](out, qt)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        # h * gelu(gate), exact (erf) gelu as diffusers' GEGLU and the JAX
        # package: one kernel pass over the projection's output on the card
        return geglu(self.proj(x, qt))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor, qt=None) -> torch.Tensor:
        with span("ff"):
            return self.net[2](self.net[0](x, qt), qt)


class TransformerBlock(nn.Module):
    """Transformer block with cross-frame token merging around attn1
    (reference patch.py:148-169): norm1 -> [join frames -> local merge ->
    global merge against the bank] -> attn1 -> unmerge -> residual ->
    norm2 -> attn2 -> residual -> norm3 -> ff -> residual.  The merges
    follow ``ToMeConfig.merge_mode``; a mode other than "replace" builds
    every plan with its sorted indices (JAX ``layers.py:561-615``).

    LDM variant (``merge_crossattn`` / ``merge_ff``, the reference's
    LDM-path block, patch.py:104-114; JAX ``layers.py:670-712``): attn2
    and / or ff run on the norm2 / norm3 tokens merged by the block's local
    plans and are unmerged through them; the global plan stays attn1's.
    The merged cross-attention reads ``context[::frames]``, one context row
    per joined row (lane contexts are repeated per frame).

    ``attn_inject`` (PnP) shares lane 0's q and k in attn1, merged or not.
    ``sublayer_mode="fused"`` (config key ``generation.sublayer_mode`` /
    ``inversion.sublayer_mode``, passed per call) runs residual + norm2 +
    attn2 + residual + norm3 as one ``ops/sublayer.fused_cross_sublayer``
    call on the same parameters, where the JAX package would
    (``layers.py:526-537``): bf16 weights and ``heads * head_dim == dim``;
    the K/V projections of the text context stay two matmuls outside it
    (``layers.py:665-667``).  It reads the bf16 projections, so a call with
    an int8 table ``qt`` refuses it.  On the model axis it runs on attn2's
    whole weights (:meth:`CrossAttention.whole_weights`), as GSPMD gives an
    opaque kernel call whole operands.

    ``rows`` (the data axis): ``x`` and ``context`` are this rank's rows of
    the batch; a merging block gathers the batch's norm1 tokens, matches
    and merges them whole (the banks and plans are the batch's on every
    rank) and runs attn1 on the joined rows that hold its rows."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 downsample: int):
        super().__init__()
        self.downsample = downsample
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                tome_call: ToMeCall | None = None,
                attn_inject: bool = False, num_lanes: int = 1,
                sublayer_mode: str = "off", qt=None,
                rows=None) -> torch.Tensor:
        if sublayer_mode not in SUBLAYER_MODES:
            raise ValueError(f"sublayer_mode must be one of "
                             f"{SUBLAYER_MODES}, got {sublayer_mode!r}")
        if sublayer_mode == "fused" and qt is not None:
            raise ValueError("sublayer_mode='fused' needs the bf16 attention "
                             "projections; this call has an int8 table")
        norm_x = self.norm1(x)
        cfg = tome_call.cfg if tome_call is not None else None
        do_merge = (cfg is not None and self.downsample <= cfg.max_downsample
                    and cfg.frames > 1)
        plans = []
        if do_merge:
            a1, plans = self._merged_attn1(norm_x, tome_call, attn_inject,
                                           num_lanes, qt, rows)
        else:
            lane0 = None
            if rows is not None and attn_inject and num_lanes > 1:
                lane0 = (rows.gather(norm_x)[:rows.n // num_lanes],
                         rows.lane0(num_lanes))
            a1 = self.attn1(norm_x, share_qk=attn_inject, num_lanes=num_lanes,
                            qt=qt, lane0=lane0)
        if self._fused_sublayer_ok(sublayer_mode, cfg, do_merge):
            x3, y3 = self._fused_sublayer(x, a1, context)
            return x3 + self.ff(y3)
        x = x + a1

        def merged(fn, h, *args):  # fn on the locally merged tokens
            F_ = cfg.frames
            j = merge_ops.join_frames(h if rows is None else rows.gather(h),
                                      F_)
            for p in plans:
                j = merge_ops.merge(j, p, cfg.merge_mode)
            if rows is None:
                return merge_ops.split_frames(
                    merge_ops.unmerge_all(fn(j, *args), plans), F_)
            sl, local = rows.joined(F_)
            own = [merge_ops.plan_rows(p, sl) for p in plans]
            out = merge_ops.unmerge_all(fn(j[sl], *(a[sl] for a in args)),
                                        own)
            return take_rows(merge_ops.split_frames(out, F_), local)

        h = self.norm2(x)
        if do_merge and cfg.merge_crossattn and plans:
            ctx = context if rows is None else rows.gather(context)
            x = x + merged(lambda t, c: self.attn2(t, c, qt=qt), h,
                           ctx[::cfg.frames])
        else:
            x = x + self.attn2(h, context, qt=qt)
        h = self.norm3(x)
        if do_merge and cfg.merge_ff and plans:
            return x + merged(lambda t: self.ff(t, qt), h)
        return x + self.ff(h, qt)

    def _fused_sublayer_ok(self, sublayer_mode: str, cfg,
                           do_merge: bool) -> bool:
        """Whether the norm2 -> attn2 -> norm3 chain takes the fused
        sublayer: ``sublayer_mode`` "fused", bf16 weights, ``heads *
        head_dim == dim``, and not a merging block of the LDM variant,
        whose attn2 / ff run merged (JAX ``layers.py:526-537``)."""
        attn = self.attn2
        if sublayer_mode != "fused" or attn.to_q.weight.dtype != torch.bfloat16:
            return False
        if attn.total_heads * attn.head_dim != self.norm2.weight.shape[0]:
            return False
        return not (do_merge and (cfg.merge_crossattn or cfg.merge_ff))

    def _fused_sublayer(self, x, a1, context):
        attn = self.attn2
        with span("attn", "cross"):
            wq, wk, wv, wout = attn.whole_weights()
            ctx = context.to(wk.dtype)
            return fused_cross_sublayer(
                x.contiguous(), a1.contiguous(), F.linear(ctx, wk),
                F.linear(ctx, wv), wq, wout, attn.to_out[0].bias,
                self.norm2.weight, self.norm2.bias, self.norm3.weight,
                self.norm3.bias, heads=attn.total_heads,
                kv_len=context.shape[1], eps=self.norm2.eps)

    def _merged_attn1(self, norm_x: torch.Tensor, call: ToMeCall,
                      attn_inject: bool, num_lanes: int, qt, rows=None):
        """attn1 on the merged tokens, unmerged; returns it with the local
        plans (the whole batch's)."""
        cfg = call.cfg
        mode = cfg.merge_mode
        F_ = cfg.frames
        if rows is not None:
            norm_x = rows.gather(norm_x)
        joined = merge_ops.join_frames(norm_x, F_)
        # share_match: the first block at a resolution level matches; the
        # others reuse its plans (layers.py:561-624 of the JAX package)
        cache = call.plan_cache if cfg.share_match else None
        key = (self.downsample, joined.shape[1], joined.shape[2])
        cached = cache.get(key) if cache is not None else None
        if cached is not None:
            plans = cached["plans"]
            tokens = joined
            for p in plans:
                tokens = merge_ops.merge(tokens, p, mode)
        else:
            tokens, plans = merge_ops.compute_local_merge(
                joined, F_, cfg.local_merge_ratio, call.local_draws,
                target_stride=cfg.target_stride, align_batch=cfg.align_batch,
                mode=mode, len_quantum=cfg.len_quantum)
        local = tokens
        L = local.shape[1]
        global_plan = None
        side = 0  # the partition of the local tokens in the global merge
        if cfg.merge_global and call.bank_mode == "init":
            call.banks[self] = local
        elif cfg.merge_global and call.bank_mode == "merge":
            # coin flip: which side plays src (reference patch.py:59-75)
            side = 0 if call.coin > cfg.global_rand else 1
            bank = call.banks[self].to(local.dtype)
            tokens_cat = torch.cat([local, bank] if side == 0
                                   else [bank, local], dim=1)
            if cached is not None and "global_plan" in cached:
                global_plan = cached["global_plan"]
            else:
                global_plan = merge_ops.two_set_matching(
                    tokens_cat, src_len=L, ratio=cfg.global_merge_ratio,
                    align_batch=cfg.align_batch,
                    keep_sorted_indices=mode != "replace",
                    len_quantum=cfg.len_quantum)
                if cache is not None:
                    cache.setdefault(key, {})["global_plan"] = global_plan
            tokens = merge_ops.merge(tokens_cat, global_plan, mode)
            # the new bank: the local partition of the merged tokens,
            # unmerged (reference patch.py:80)
            call.banks[self] = merge_ops.partition(
                merge_ops.unmerge(tokens, global_plan), L, side)
        if cache is not None and cached is None:
            cache.setdefault(key, {})["plans"] = plans
        if cfg.collect_stats:
            call.stats[self] = {
                "seq_len": norm_x.shape[0] * norm_x.shape[1],
                "merged_len": tokens.shape[0] * tokens.shape[1]}

        own, lane0 = plans, None
        if rows is not None:
            # attn1 on the joined rows that hold this rank's rows
            sl, picks = rows.joined(F_)
            J = tokens.shape[0]
            if attn_inject and num_lanes > 1:
                lane0 = (tokens[:J // num_lanes],
                         [j % (J // num_lanes) for j in range(J)[sl]])
            tokens = tokens[sl]
            own = [merge_ops.plan_rows(p, sl) for p in plans]
            if global_plan is not None:
                global_plan = merge_ops.plan_rows(global_plan, sl)
        out = self.attn1(tokens, share_qk=attn_inject, num_lanes=num_lanes,
                         qt=qt, lane0=lane0)
        if global_plan is not None:
            out = merge_ops.partition(merge_ops.unmerge(out, global_plan), L,
                                      side)
        out = merge_ops.split_frames(merge_ops.unmerge_all(out, own), F_)
        return (out if rows is None else take_rows(out, picks)), plans


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out
    (+residual).  ``linear``: SD2.x projects with dense layers on the
    [B, H*W, C] tokens, SD1.x with 1x1 convolutions."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, downsample: int, depth: int = 1,
                 linear: bool = False):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6)
        proj = Linear if linear else (
            lambda c_in, c_out: Conv2d(c_in, c_out, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, heads, head_dim, context_dim,
                             downsample) for _ in range(depth)])
        self.proj_out = proj(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                tome_call: ToMeCall | None = None, attn_inject: bool = False,
                num_lanes: int = 1, sublayer_mode: str = "off",
                qt=None, rows=None) -> torch.Tensor:
        B, H, W, C = x.shape
        with span("transformer", lambda: f"rows={B} tokens={H * W}"):
            # a 1x1 convolution on NHWC is the dense layer on the tokens,
            # so both projections run on [B, H, W, C] and the reshapes are
            # views
            h = self.proj_in(self.norm(x), qt).reshape(B, H * W, C)
            for blk in self.transformer_blocks:
                h = blk(h, context, tome_call, attn_inject, num_lanes,
                        sublayer_mode, qt, rows)
            return self.proj_out(h.reshape(B, H, W, C), qt) + x
