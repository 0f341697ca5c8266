"""ControlNet: a copy of the UNet's encoder, a hint encoder and zero convs.

Counterpart of ``vidtome_tpu/models/controlnet.py`` (reference
utils/utils.py:47-56, applied through get_controlnet_kwargs,
utils/utils.py:280-295), NHWC.  Module names follow diffusers'
``ControlNetModel`` (``controlnet_cond_embedding.{conv_in,blocks.N,
conv_out}``, ``down_blocks...``, ``mid_block...``,
``controlnet_down_blocks.N``, ``controlnet_mid_block``), so a diffusers
checkpoint loads with ``strict=True``.

The trunk is built from the UNet's blocks without token merging, fused
resnets or the fused sublayer, as the JAX package builds it: on the card
its self-attentions (per frame) take the flash or small-KV kernel, every
GroupNorm the GroupNorm kernel; the hint encoder's convolutions stay
``F.conv2d``.  ``qt`` is the ControlNet's own int8 table
(``ops/quant.quantize_unet`` under ``CONTROLNET_EXCLUDE``).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.models.layers import (Conv2d, Downsample2D, ResnetBlock2D,
                                         TimestepEmbedding, Transformer2D,
                                         timestep_embedding)
from vidtome_torch.models.unet import SD15_UNET, UNetConfig, _Level


class ControlNetConditioningEmbedding(nn.Module):
    """The hint image [B, 8h, 8w, 3] down to latent resolution: 3x3 convs
    with SiLU, three of them stride 2; ``conv_out`` starts at zero."""

    def __init__(self, out_channels: int,
                 block_channels: Sequence[int] = (16, 32, 96, 256),
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = Conv2d(in_channels, block_channels[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(block_channels[:-1], block_channels[1:]):
            self.blocks.append(Conv2d(c_in, c_in, 3, padding=1))
            self.blocks.append(Conv2d(c_in, c_out, 3, padding=1, stride=2))
        self.conv_out = Conv2d(block_channels[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor, qt=None) -> torch.Tensor:
        h = F.silu(self.conv_in(cond, qt))
        for conv in self.blocks:
            h = F.silu(conv(h, qt))
        return self.conv_out(h, qt)


class ControlNetModel(nn.Module):
    def __init__(self, config: UNetConfig = SD15_UNET):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch0)

        def transformer(ch: int, level: int) -> Transformer2D:
            return Transformer2D(ch, *cfg.heads_for(ch),
                                 cfg.cross_attention_dim,
                                 downsample=2 ** level,
                                 linear=cfg.use_linear_projection)

        def zero_conv(ch: int) -> Conv2d:
            return Conv2d(ch, ch, 1)

        zero_convs = [zero_conv(ch0)]
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
                zero_convs.append(zero_conv(ch))
            if i < n - 1:
                blk.downsamplers.append(Downsample2D(ch))
                zero_convs.append(zero_conv(ch))
            self.down_blocks.append(blk)
        self.controlnet_down_blocks = nn.ModuleList(zero_convs)

        self.mid_block = _Level()
        self.mid_block.resnets.append(ResnetBlock2D(h_ch, h_ch, temb_ch))
        self.mid_block.attentions.append(transformer(h_ch, n - 1))
        self.mid_block.resnets.append(ResnetBlock2D(h_ch, h_ch, temb_ch))
        self.controlnet_mid_block = zero_conv(h_ch)

    def zero_init_modules(self) -> Iterator[nn.Module]:
        """The convolutions that start at zero (JAX ``controlnet.py:49-51``,
        ``:114-120``): the hint encoder's ``conv_out`` and every zero
        conv.  While they are zero the ControlNet adds nothing."""
        yield self.controlnet_cond_embedding.conv_out
        yield from self.controlnet_down_blocks
        yield self.controlnet_mid_block

    def forward(self, x: torch.Tensor, t, context: torch.Tensor,
                cond: torch.Tensor, conditioning_scale: float = 1.0,
                qt=None) -> tuple[list[torch.Tensor], torch.Tensor]:
        """x [B, h, w, Cin] (the UNet's input), t scalar timestep, context
        [B, S, Dctx], cond [B, 8h, 8w, 3] in [0, 1] -> (one residual per
        UNet skip, the mid residual), in the weights' dtype, each scaled by
        ``conditioning_scale`` after its zero conv."""
        dtype = self.conv_in.weight.dtype
        B = x.shape[0]
        temb = timestep_embedding(t, self.config.block_out_channels[0])
        temb = self.time_embedding(temb.to(device=x.device, dtype=dtype), qt)
        temb = temb.expand(B, -1)
        context = context.to(dtype)

        h = self.conv_in(x.to(dtype), qt)
        h = h + self.controlnet_cond_embedding(cond.to(dtype), qt)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb, qt=qt)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, qt=qt)
                skips.append(h)
            for down in blk.downsamplers:
                h = down(h, qt)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb, qt=qt)
        h = mid.attentions[0](h, context, qt=qt)
        h = mid.resnets[1](h, temb, qt=qt)

        down = [conv(s, qt) * conditioning_scale
                for conv, s in zip(self.controlnet_down_blocks, skips)]
        return down, self.controlnet_mid_block(h, qt) * conditioning_scale
