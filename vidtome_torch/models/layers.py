"""Building blocks of the Stable Diffusion UNet, NHWC at every boundary.

Counterpart of ``vidtome_tpu/models/layers.py`` (no int8, no fused
sublayer, no PnP injection).  Activations are
[B, H, W, C] (or [B, S, C] tokens) as in the JAX package; a contiguous NHWC
tensor permuted to NCHW is already ``channels_last``, so ``F.conv2d`` takes
it without a copy.  Parameter names follow the diffusers layout
(``to_out.0``, ``ff.net.0.proj``, ``downsamplers.0.conv``), so a diffusers
checkpoint loads with few renames (``models/convert.py``).

On CUDA every GroupNorm runs the Triton kernel (``ops/groupnorm.py``) and
every attention the flash kernel (``ops/attention.py``); with
``resnet_mode="fused"`` every ResnetBlock2D runs the fused resnet kernel
(``ops/resnet.py``).  LayerNorm, the other convs and dense layers stay
PyTorch's, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.core import merge as merge_ops
from vidtome_torch.models.tome import ToMeCall
from vidtome_torch.ops.attention import flash_attention
from vidtome_torch.ops.groupnorm import group_norm
from vidtome_torch.ops.resnet import fused_resnet

RESNET_MODES = ("off", "fused")


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


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC activations (OIHW weights, diffusers layout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> +temb -> GN+SiLU -> conv3x3 (+shortcut).

    ``resnet_mode="fused"`` (config key ``generation.resnet_mode`` /
    ``inversion.resnet_mode``, passed per call) runs the block through
    ``ops/resnet.fused_resnet`` on the same parameters: the kernel on a
    CUDA tensor (bf16; anything else raises), its plain version on a CPU
    tensor.  The time-embedding projection is computed here, in fp32, as
    the JAX package does (``layers.py:321-322``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                resnet_mode: str = "off") -> torch.Tensor:
        if resnet_mode == "fused":
            return self._fused(x, temb)
        if resnet_mode != "off":
            raise ValueError(f"resnet_mode must be one of {RESNET_MODES}, "
                             f"got {resnet_mode!r}")
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _fused(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        proj = self.time_emb_proj
        tvec = F.linear(F.silu(temb.float()), proj.weight.float(),
                        proj.bias.float())
        sc = self.conv_shortcut
        return fused_resnet(
            x, tvec, self.norm1.weight, self.norm1.bias, self.conv1.weight,
            self.conv1.bias, self.norm2.weight, self.norm2.bias,
            self.conv2.weight, self.conv2.bias,
            None if sc is None else sc.weight[:, :, 0, 0],
            None if sc is None else sc.bias,
            self.norm1.num_groups, self.norm2.num_groups, self.norm1.eps)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], nearest neighbour."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                         mode="nearest").permute(0, 2, 3, 1)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when ``context`` is None."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, S, _ = x.shape

        def heads(t):  # [B, s, H*D] -> [B, H, s, D] view
            return t.view(B, t.shape[1], self.heads,
                          self.head_dim).transpose(1, 2)

        out = flash_attention(heads(self.to_q(x)), heads(self.to_k(ctx)),
                              heads(self.to_v(ctx)))
        out = out.transpose(1, 2).reshape(B, S, self.heads * self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # exact (erf) gelu, as diffusers' GEGLU and the JAX package
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """Transformer block with cross-frame token merging around attn1
    (reference patch.py:148-169): norm1 -> [join frames -> local merge ->
    global merge against the bank] -> attn1 -> unmerge -> residual ->
    norm2 -> attn2 -> residual -> norm3 -> ff -> residual."""

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
                tome_call: ToMeCall | None = None) -> torch.Tensor:
        norm_x = self.norm1(x)
        cfg = tome_call.cfg if tome_call is not None else None
        if (cfg is not None and self.downsample <= cfg.max_downsample
                and cfg.frames > 1):
            x = x + self._merged_attn1(norm_x, tome_call)
        else:
            x = x + self.attn1(norm_x)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    def _merged_attn1(self, norm_x: torch.Tensor,
                      call: ToMeCall) -> torch.Tensor:
        cfg = call.cfg
        F_ = cfg.frames
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
                tokens = merge_ops.merge(tokens, p)
        else:
            tokens, plans = merge_ops.compute_local_merge(
                joined, F_, cfg.local_merge_ratio, call.local_draws,
                target_stride=cfg.target_stride, align_batch=cfg.align_batch,
                len_quantum=cfg.len_quantum)
        local = tokens
        L = local.shape[1]
        global_plan = None
        local_is_src = True
        if cfg.merge_global and call.bank_mode == "init":
            call.banks[self] = local
        elif cfg.merge_global and call.bank_mode == "merge":
            # coin flip: which side plays src (reference patch.py:59-75)
            local_is_src = call.coin > cfg.global_rand
            bank = call.banks[self].to(local.dtype)
            tokens_cat = torch.cat([local, bank] if local_is_src
                                   else [bank, local], dim=1)
            if cached is not None and "global_plan" in cached:
                global_plan = cached["global_plan"]
            else:
                global_plan = merge_ops.two_set_matching(
                    tokens_cat, src_len=L, ratio=cfg.global_merge_ratio,
                    align_batch=cfg.align_batch, len_quantum=cfg.len_quantum)
                if cache is not None:
                    cache.setdefault(key, {})["global_plan"] = global_plan
            tokens = merge_ops.merge(tokens_cat, global_plan)
            # the new bank: the local partition of the merged tokens,
            # unmerged (reference patch.py:80)
            full = merge_ops.unmerge(tokens, global_plan)
            call.banks[self] = full[:, :L] if local_is_src else full[:, L:]
        if cache is not None and cached is None:
            cache.setdefault(key, {})["plans"] = plans

        out = self.attn1(tokens)
        if global_plan is not None:
            full = merge_ops.unmerge(out, global_plan)
            out = full[:, :L] if local_is_src else full[:, L:]
        out = merge_ops.unmerge_all(out, plans)
        return merge_ops.split_frames(out, F_)


class Transformer2D(nn.Module):
    """Spatial transformer, conv projections (SD1.x): GN -> proj_in ->
    blocks -> proj_out (+residual)."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, downsample: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, heads, head_dim, context_dim,
                             downsample) for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                tome_call: ToMeCall | None = None) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, tome_call)
        return self.proj_out(h.reshape(B, H, W, C)) + x
