"""Conditional UNet of Stable Diffusion 1.x, NHWC.

Counterpart of ``vidtome_tpu/models/unet.py``: the exact path and the
deep-feature cache split (``cache_mode``); no PnP injection, no ControlNet
residuals, no SDXL embeddings.  Module names follow diffusers'
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
    num_heads: int = 8                  # SD1.x: fixed head count per level
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")


SD15_UNET = UNetConfig()
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
            return Transformer2D(ch, cfg.num_heads, ch // cfg.num_heads,
                                 cfg.cross_attention_dim,
                                 downsample=2 ** level)

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
                resnet_mode: str = "off"):
        """x [B, H, W, Cin], t scalar timestep, context [B, S, Dctx]
        -> eps [B, H, W, Cout] in the weights' dtype.

        ``cache_mode`` (the deep-feature step cache, JAX ``unet.py:
        166-310``): "full" returns ``(eps, deep)``, ``deep`` being the input
        of the last up block after the preceding upsample; "shallow" runs
        only conv_in, down block 0 (without its downsample), the last up
        block and the head around a cached ``deep``.  A shallow call fed
        the ``deep`` of a full call at the same t reproduces its eps.
        ``resnet_mode`` ("off" / "fused") is passed to every
        ResnetBlock2D of this call."""
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
        temb = self.time_embedding(temb.to(device=x.device, dtype=dtype))
        temb = temb.expand(B, -1)
        context = context.to(dtype)

        h = self.conv_in(x.to(dtype))
        skips = [h]
        for blk in self.down_blocks if run_deep else self.down_blocks[:1]:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb, resnet_mode)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, tome_call)
                skips.append(h)
            for down in blk.downsamplers if run_deep else ():
                h = down(h)
                skips.append(h)

        if run_deep:
            mid = self.mid_block
            h = mid.resnets[0](h, temb, resnet_mode)
            h = mid.attentions[0](h, context, tome_call)
            h = mid.resnets[1](h, temb, resnet_mode)
        else:
            h = deep_cache.to(dtype)

        deep = None
        for i, blk in enumerate(self.up_blocks):
            if not run_deep and i < n_up - 1:
                continue
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb, resnet_mode)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, tome_call)
            for up in blk.upsamplers:
                h = up(h)
                if i == n_up - 2:
                    deep = h  # input of the last up block: the cache cut

        out = self.conv_out(self.conv_norm_out(h))
        return (out, deep) if cache_mode == "full" else out
