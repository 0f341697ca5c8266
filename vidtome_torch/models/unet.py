"""Conditional UNet of Stable Diffusion 1.x / 2.x, NHWC.

Counterpart of ``vidtome_tpu/models/unet.py``: the exact path, the
deep-feature cache split (``cache_mode``), the PnP injection flags, the
int8 (W8A8) layers of a per-call table and the ControlNet residuals; no
SDXL embeddings.  Module names follow diffusers'
``UNet2DConditionModel`` (``down_blocks.0.resnets.1`` ...), so its state
dict is the diffusers one.  Token merging enters through ``tome_call``
(``models/tome.py``) in every transformer block at downsample <=
``max_downsample``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from vidtome_torch.models.layers import (Conv2d, Downsample2D, GroupNorm,
                                         ResnetBlock2D, TimestepEmbedding,
                                         Transformer2D, Upsample2D,
                                         timestep_embedding)
from vidtome_torch.models.tome import ToMeCall


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int | None = 8           # SD1.x: fixed head count per level
    head_dim: int | None = None         # SD2.x: fixed head dim (64)
    use_linear_projection: bool = False  # SD2.x: dense proj_in / proj_out
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")

    def heads_for(self, channels: int) -> tuple[int, int]:
        """(heads, head_dim) of a transformer at this width."""
        if self.head_dim is not None:
            return channels // self.head_dim, self.head_dim
        return self.num_heads, channels // self.num_heads


SD15_UNET = UNetConfig()
SD21_UNET = UNetConfig(cross_attention_dim=1024, num_heads=None, head_dim=64,
                       use_linear_projection=True)
# SD2-depth: SD2.1 with the depth map concatenated as a fifth input channel
SD2_DEPTH_UNET = dataclasses.replace(SD21_UNET, in_channels=5)
TINY_UNET = UNetConfig(
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    num_heads=2,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))


class _Level(nn.Module):
    """One down/up/mid block: resnets, optional attentions and resampler,
    named as diffusers names them."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig = SD15_UNET):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)

        def transformer(ch: int, level: int) -> Transformer2D:
            return Transformer2D(ch, *cfg.heads_for(ch),
                                 cfg.cross_attention_dim,
                                 downsample=2 ** level,
                                 linear=cfg.use_linear_projection)

        skip_ch = [ch0]
        self.down_blocks = nn.ModuleList()
        h_ch = ch0
        n = len(cfg.block_out_channels)
        for i, (kind, ch) in enumerate(zip(cfg.down_block_types,
                                           cfg.block_out_channels)):
            blk = _Level()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h_ch, ch, temb_ch))
                h_ch = ch
                if kind == "CrossAttnDownBlock2D":
                    blk.attentions.append(transformer(ch, i))
                skip_ch.append(ch)
            if i < n - 1:
                blk.downsamplers.append(Downsample2D(ch))
                skip_ch.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Level()
        self.mid_block.resnets.append(ResnetBlock2D(h_ch, h_ch, temb_ch))
        self.mid_block.attentions.append(transformer(h_ch, n - 1))
        self.mid_block.resnets.append(ResnetBlock2D(h_ch, h_ch, temb_ch))

        self.up_blocks = nn.ModuleList()
        rev = list(cfg.block_out_channels)[::-1]
        for i, (kind, ch) in enumerate(zip(cfg.up_block_types, rev)):
            blk = _Level()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(
                    ResnetBlock2D(h_ch + skip_ch.pop(), ch, temb_ch))
                h_ch = ch
                if kind == "CrossAttnUpBlock2D":
                    blk.attentions.append(transformer(ch, n - 1 - i))
            if i < n - 1:
                blk.upsamplers.append(Upsample2D(ch))
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(ch0, silu=True)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t, context: torch.Tensor,
                tome_call: ToMeCall | None = None, cache_mode: str = "off",
                deep_cache: torch.Tensor | None = None,
                resnet_mode: str = "off", sublayer_mode: str = "off",
                attn_inject: bool | None = None,
                conv_inject: bool | None = None, num_lanes: int = 1,
                qt=None, down_residuals: Sequence[torch.Tensor] | None = None,
                mid_residual: torch.Tensor | None = None):
        """x [B, H, W, Cin], t scalar timestep, context [B, S, Dctx]
        -> eps [B, H, W, Cout] in the weights' dtype.

        ``cache_mode`` (the deep-feature step cache, JAX ``unet.py:
        166-310``): "full" returns ``(eps, deep)``, ``deep`` being the input
        of the last up block after the preceding upsample; "shallow" runs
        only conv_in, down block 0 (without its downsample), the last up
        block and the head around a cached ``deep``.  A shallow call fed
        the ``deep`` of a full call at the same t reproduces its eps.
        ``resnet_mode`` ("off" / "fused") is passed to every
        ResnetBlock2D of this call, ``sublayer_mode`` ("off" / "fused") to
        every TransformerBlock.  ``qt`` is the call's int8 table
        (``ops/quant.QuantTable``, built per stage; None runs the weights'
        dtype), passed to every layer, as ``resnet_mode`` is.

        PnP (JAX ``unet.py:283-298``): the batch holds ``num_lanes``
        lane-major blocks, lane 0 the source.  ``conv_inject`` goes to up
        block 1, resnet 1 only; ``attn_inject`` to up block 1's attentions
        1 and up and to every attention of the later up blocks.  None means
        no PnP (the injected resnet may then take the fused kernel).

        ControlNet (JAX ``unet.py:255-267``): a full call adds
        ``mid_residual`` after the mid block and one of ``down_residuals``
        to every skip (their count must match); a shallow call adds them to
        the level-0 skips it recomputes, pairing the leading residuals with
        them (the deep residuals' effect rides the cache)."""
        if cache_mode not in ("off", "full", "shallow"):
            raise ValueError(f"cache_mode {cache_mode!r}")
        n_up = len(self.up_blocks)
        if cache_mode != "off" and n_up < 2:
            raise ValueError("deep-feature caching needs >= 2 UNet levels")
        run_deep = cache_mode != "shallow"
        if not run_deep and deep_cache is None:
            raise ValueError("cache_mode='shallow' needs deep_cache")
        dtype = self.conv_in.weight.dtype
        B = x.shape[0]
        temb = timestep_embedding(t, self.config.block_out_channels[0])
        temb = self.time_embedding(temb.to(device=x.device, dtype=dtype), qt)
        temb = temb.expand(B, -1)
        context = context.to(dtype)

        h = self.conv_in(x.to(dtype), qt)
        skips = [h]
        blk_kw = dict(num_lanes=num_lanes, sublayer_mode=sublayer_mode,
                      qt=qt)
        for blk in self.down_blocks if run_deep else self.down_blocks[:1]:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb, resnet_mode, qt=qt)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, tome_call, **blk_kw)
                skips.append(h)
            for down in blk.downsamplers if run_deep else ():
                h = down(h, qt)
                skips.append(h)

        if run_deep:
            mid = self.mid_block
            h = mid.resnets[0](h, temb, resnet_mode, qt=qt)
            h = mid.attentions[0](h, context, tome_call, **blk_kw)
            h = mid.resnets[1](h, temb, resnet_mode, qt=qt)
            if mid_residual is not None:
                h = h + mid_residual
            if down_residuals is not None and len(down_residuals) != len(
                    skips):
                raise ValueError(f"expected {len(skips)} down residuals, "
                                 f"got {len(down_residuals)}")
        else:
            h = deep_cache.to(dtype)
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals)]

        deep = None
        for i, blk in enumerate(self.up_blocks):
            if not run_deep and i < n_up - 1:
                continue
            for j, res in enumerate(blk.resnets):
                inj = conv_inject if (i == 1 and j == 1) else None
                h = res(torch.cat([h, skips.pop()], dim=-1), temb, resnet_mode,
                        inject=inj, num_lanes=num_lanes, qt=qt)
                if len(blk.attentions):
                    pnp_here = i >= 2 or (i == 1 and j >= 1)
                    h = blk.attentions[j](
                        h, context, tome_call,
                        attn_inject=bool(attn_inject) and pnp_here, **blk_kw)
            for up in blk.upsamplers:
                h = up(h, qt)
                if i == n_up - 2:
                    deep = h  # input of the last up block: the cache cut

        out = self.conv_out(self.conv_norm_out(h), qt)
        return (out, deep) if cache_mode == "full" else out
