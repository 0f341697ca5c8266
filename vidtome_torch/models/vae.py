"""AutoencoderKL (the SD VAE), NHWC: encoder, decoder, 0.18215 scaling.

Counterpart of ``vidtome_tpu/models/vae.py``.  Encode returns the scaled
posterior mean; decode returns images in [0, 1] (fp32).  Module names follow
diffusers' ``AutoencoderKL`` with the modern attention names (``to_q`` ...
``to_out.0``); ``models/convert.py`` renames the legacy ones.  GroupNorm eps
is 1e-5 everywhere, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.models.layers import Conv2d, GroupNorm, upsample_nearest2x
from vidtome_torch.ops.attention import flash_attention

SD_VAE_SCALING = 0.18215


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions (mid block): at a
    64x64 latent this is 4096 tokens with D = C = 512."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        out = flash_attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                              self.to_v(h)[:, None])
        out = self.to_out[0](out[:, 0])
        return x + out.reshape(B, H, W, C)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class _Resample(nn.Module):
    """Holds the resampling conv under diffusers' ``.conv`` name."""

    def __init__(self, channels: int, stride: int, padding: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=stride,
                           padding=padding)


def _mid(ch: int) -> _Level:
    mid = _Level()
    mid.resnets.append(VAEResnetBlock(ch, ch))
    mid.attentions.append(VAEAttentionBlock(ch))
    mid.resnets.append(VAEResnetBlock(ch, ch))
    return mid


def _run_mid(mid: _Level, h: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int = 4):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = Conv2d(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h_ch = chans[0]
        for i, ch in enumerate(chans):
            blk = _Level()
            for _ in range(layers_per_block):
                blk.resnets.append(VAEResnetBlock(h_ch, ch))
                h_ch = ch
            if i < len(chans) - 1:
                # asymmetric pad (0, 1) then a stride-2 conv (SD convention)
                blk.downsamplers.append(_Resample(ch, 2, 0))
            self.down_blocks.append(blk)
        self.mid_block = _mid(h_ch)
        self.conv_norm_out = GroupNorm(h_ch, silu=True)
        self.conv_out = Conv2d(h_ch, 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            for down in blk.downsamplers:
                h = down.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int,
                 latent_channels: int = 4, out_channels: int = 3):
        super().__init__()
        rev = list(block_out_channels)[::-1]
        self.conv_in = Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0])
        self.up_blocks = nn.ModuleList()
        h_ch = rev[0]
        for i, ch in enumerate(rev):
            blk = _Level()
            for _ in range(layers_per_block + 1):
                blk.resnets.append(VAEResnetBlock(h_ch, ch))
                h_ch = ch
            if i < len(rev) - 1:
                blk.upsamplers.append(_Resample(ch, 1, 1))
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(h_ch, silu=True)
        self.conv_out = Conv2d(h_ch, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            for up in blk.upsamplers:
                h = up.conv(upsample_nearest2x(h))
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = SD_VAE_SCALING):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.decoder = Decoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> scaled latent mean [B, H/8, W/8, 4]
        (the posterior mean, reference invert.py:105)."""
        moments = self.quant_conv(self.encoder(images))
        return moments[..., :self.latent_channels] * self.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images [B, H, W, 3] in [0, 1], fp32."""
        imgs = self.decoder(self.post_quant_conv(latents / self.scaling_factor))
        return torch.clamp(imgs.float() / 2 + 0.5, 0.0, 1.0)
