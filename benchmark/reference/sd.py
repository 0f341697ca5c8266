"""Plain PyTorch Stable Diffusion 1.x / 2.x stack with VidToMe merging.

The reference that decides a cell's ``correct``: the CLIP text encoder, the
VAE and the conditional UNet, with cross-frame token merging around every
self-attention at downsample <= ``max_downsample`` and PnP's lane-0
injection.  Activations are NHWC ([B, H, W, C], tokens [B, S, C]), module
and parameter names follow the diffusers layout, so one weight maker
(``benchmark/harness/weights.py``) fills this stack and the program's with
the same tensors.  Everything runs in float32 through ``F.linear``,
``F.conv2d`` and plain softmax attention; nothing here reads a kernel, a
cache or a quantization table.

Written from the published architectures (diffusers' UNet2DConditionModel
and AutoencoderKL, transformers' CLIPTextModel) and VidToMe's merging
(github.com/lixirui142/VidToMe, ``patch.py`` / ``merge.py``), in the token
layout and draw order the edit pipeline defines (see ``merge.py`` here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import merge as M


# --------------------------------------------------------------------------
# configurations (the published widths; see benchmark/configs/*.json)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int | None = 8           # SD1.x: heads per level
    head_dim: int | None = None         # SD2.x: head width
    use_linear_projection: bool = False
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")

    def heads_for(self, ch: int) -> tuple[int, int]:
        if self.head_dim is not None:
            return ch // self.head_dim, self.head_dim
        return self.num_heads, ch // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215


def _tuple(v):
    return tuple(v) if isinstance(v, list) else v


def configs_from(model: dict) -> tuple[UNetConfig, TextConfig, VAEConfig]:
    """The three configurations of a benchmark configuration file's
    ``unet``, ``text_encoder`` and ``vae`` groups."""
    return (UNetConfig(**{k: _tuple(v) for k, v in model["unet"].items()}),
            TextConfig(**model["text_encoder"]),
            VAEConfig(**{k: _tuple(v) for k, v in model["vae"].items()}))


# --------------------------------------------------------------------------
# plain layers
# --------------------------------------------------------------------------


def group_norm(x, weight, bias, groups, eps, silu=False):
    """GroupNorm over channels-last x [B, ..., C] (var = E[x^2] - mean^2)."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.reshape(B, -1, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, -1, C)
    y = (y * weight + bias).reshape(x.shape)
    return F.silu(y) if silu else y


class GroupNorm(nn.Module):
    def __init__(self, channels, groups=32, eps=1e-5, silu=False):
        super().__init__()
        while channels % groups:
            groups //= 2
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps,
                          self.silu)


class Conv2d(nn.Conv2d):
    """Convolution on NHWC activations (OIHW weights)."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def attention(q, k, v, max_scores=2 ** 28):
    """Softmax attention, q, k, v [B, H, S, D], in blocks of batch rows
    that hold at most ``max_scores`` scores."""
    B, H, S, _ = q.shape
    step = max(1, max_scores // (H * S * k.shape[2]))
    out = []
    for i in range(0, B, step):
        s = torch.matmul(q[i:i + step], k[i:i + step].transpose(-1, -2))
        s = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
        out.append(torch.matmul(s, v[i:i + step]))
    return torch.cat(out)


def timestep_embedding(t, dim, max_period=10000.0):
    t = torch.as_tensor(t, dtype=torch.float32).reshape(-1)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32) / half)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def lanes_of_lane0(x, lanes):
    """Every lane's rows replaced by lane 0's (lane-major batch)."""
    return x[:x.shape[0] // lanes].repeat(lanes, *([1] * (x.ndim - 1)))


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, e):
        return self.linear_2(F.silu(self.linear_1(e)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb):
        super().__init__()
        self.norm1 = GroupNorm(cin, silu=True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = GroupNorm(cout, silu=True)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, inject=False, lanes=1):
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if inject and lanes > 1:  # PnP conv features from the source lane
            h = lanes_of_lane0(h, lanes)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


def upsample2x(x):
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                         mode="nearest").permute(0, 2, 3, 1)


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample2x(x))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None, share_qk=False, lanes=1):
        ctx = x if context is None else context
        B, S, _ = x.shape

        def heads(t):
            return t.view(B, t.shape[1], self.heads,
                          self.head_dim).transpose(1, 2)

        if share_qk and lanes > 1:  # PnP: the source lane's q and k
            q = self.to_q(x[:B // lanes]).repeat(lanes, 1, 1)
            k = self.to_k(ctx[:B // lanes]).repeat(lanes, 1, 1)
        else:
            q, k = self.to_q(x), self.to_k(ctx)
        out = attention(heads(q), heads(k), heads(self.to_v(ctx)))
        return self.to_out[0](out.transpose(1, 2).reshape(B, S, -1))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """norm1 -> [join the chunk's frames -> local merge -> global merge
    against the bank] -> attn1 -> unmerge -> residual -> norm2 -> attn2 ->
    residual -> norm3 -> ff -> residual (VidToMe ``patch.py``)."""

    def __init__(self, dim, heads, head_dim, context_dim, downsample):
        super().__init__()
        self.downsample = downsample
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, tome=None, inject=False, lanes=1):
        n = self.norm1(x)
        if tome is not None and self.downsample <= tome.cfg.max_downsample:
            a1 = self._merged_attn1(n, tome, inject, lanes)
        else:
            a1 = self.attn1(n, share_qk=inject, lanes=lanes)
        x = x + a1
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    def _merged_attn1(self, n, call, inject, lanes):
        cfg = call.cfg
        F_ = cfg.frames
        joined = M.join_frames(n, F_)
        key = (self.downsample, joined.shape[1], joined.shape[2])
        cached = call.plans.get(key)  # one matching per level (share_match)
        if cached is not None:
            tokens = joined
            for p in cached["local"]:
                tokens = M.merge(tokens, p)
            plans = cached["local"]
        else:
            tokens, plans = M.local_merge(
                joined, F_, cfg.local_merge_ratio, call.local_draws,
                cfg.target_stride, cfg.align_batch, cfg.len_quantum)
            cached = call.plans[key] = {"local": plans}
        L = tokens.shape[1]
        gplan, side = None, 0
        if call.bank_mode == "init":
            call.banks[self] = tokens
        elif call.bank_mode == "merge":
            side = 0 if call.coin > cfg.global_rand else 1
            bank = call.banks[self]
            cat = torch.cat([tokens, bank] if side == 0 else [bank, tokens],
                            dim=1)
            gplan = cached.get("global")
            if gplan is None:
                gplan = cached["global"] = M.two_set_matching(
                    cat, L, cfg.global_merge_ratio, cfg.align_batch,
                    cfg.len_quantum)
            tokens = M.merge(cat, gplan)
            call.banks[self] = M.partition(M.unmerge(tokens, gplan), L, side)
        out = self.attn1(tokens, share_qk=inject, lanes=lanes)
        if gplan is not None:
            out = M.partition(M.unmerge(out, gplan), L, side)
        return M.split_frames(M.unmerge_all(out, plans), F_)


class Transformer2D(nn.Module):
    def __init__(self, ch, heads, head_dim, context_dim, downsample,
                 linear):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        proj = (lambda a, b: nn.Linear(a, b)) if linear else (
            lambda a, b: Conv2d(a, b, 1))
        self.proj_in = proj(ch, ch)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            ch, heads, head_dim, context_dim, downsample)])
        self.proj_out = proj(ch, ch)

    def forward(self, x, context, tome=None, inject=False, lanes=1):
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, tome, inject, lanes)
        return self.proj_out(h.reshape(B, H, W, C)) + x


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        ch0 = cfg.block_out_channels[0]
        temb = 4 * ch0
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)

        def tr(ch, level):
            return Transformer2D(ch, *cfg.heads_for(ch),
                                 cfg.cross_attention_dim, 2 ** level,
                                 cfg.use_linear_projection)

        skips, h = [ch0], ch0
        n = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList()
        for i, (kind, ch) in enumerate(zip(cfg.down_block_types,
                                           cfg.block_out_channels)):
            blk = _Level()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h, ch, temb))
                h = ch
                if kind == "CrossAttnDownBlock2D":
                    blk.attentions.append(tr(ch, i))
                skips.append(ch)
            if i < n - 1:
                blk.downsamplers.append(Downsample2D(ch))
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = _Level()
        self.mid_block.resnets.append(ResnetBlock2D(h, h, temb))
        self.mid_block.attentions.append(tr(h, n - 1))
        self.mid_block.resnets.append(ResnetBlock2D(h, h, temb))
        self.up_blocks = nn.ModuleList()
        rev = list(cfg.block_out_channels)[::-1]
        for i, (kind, ch) in enumerate(zip(cfg.up_block_types, rev)):
            blk = _Level()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(h + skips.pop(), ch, temb))
                h = ch
                if kind == "CrossAttnUpBlock2D":
                    blk.attentions.append(tr(ch, n - 1 - i))
            if i < n - 1:
                blk.upsamplers.append(Upsample2D(ch))
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(ch0, silu=True)
        self.conv_out = Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, x, t, context, tome=None, attn_inject=False,
                conv_inject=False, lanes=1):
        """x [B, h, w, 4], t a timestep, context [B, 77, D] -> eps.  PnP
        (``lanes`` 3, lane 0 the source): up block 1's resnet 1 takes the
        source's conv features under ``conv_inject``; up block 1's
        attentions from the second on and every attention of the later up
        blocks take its q and k under ``attn_inject``."""
        B = x.shape[0]
        temb = self.time_embedding(timestep_embedding(
            t, self.config.block_out_channels[0]).to(x.device)).expand(B, -1)
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, tome)
                skips.append(h)
            for down in blk.downsamplers:
                h = down(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb),
                                             context, tome), temb)
        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb,
                        inject=conv_inject and i == 1 and j == 1, lanes=lanes)
                if len(blk.attentions):
                    here = i >= 2 or (i == 1 and j >= 1)
                    h = blk.attentions[j](h, context, tome,
                                          attn_inject and here, lanes)
            for up in blk.upsamplers:
                h = up(h)
        return self.conv_out(self.conv_norm_out(h))


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------


class VAEResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(cin, silu=True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout, silu=True)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.group_norm = GroupNorm(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        out = attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                        self.to_v(h)[:, None])[:, 0]
        return x + self.to_out[0](out).reshape(B, H, W, C)


class _Resample(nn.Module):
    def __init__(self, ch, stride, padding):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=stride, padding=padding)


def _mid(ch):
    mid = _Level()
    mid.resnets.append(VAEResnetBlock(ch, ch))
    mid.attentions.append(VAEAttentionBlock(ch))
    mid.resnets.append(VAEResnetBlock(ch, ch))
    return mid


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, chans, layers, latent):
        super().__init__()
        self.conv_in = Conv2d(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h = chans[0]
        for i, ch in enumerate(chans):
            blk = _Level()
            for _ in range(layers):
                blk.resnets.append(VAEResnetBlock(h, ch))
                h = ch
            if i < len(chans) - 1:
                blk.downsamplers.append(_Resample(ch, 2, 0))
            self.down_blocks.append(blk)
        self.mid_block = _mid(h)
        self.conv_norm_out = GroupNorm(h, silu=True)
        self.conv_out = Conv2d(h, 2 * latent, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            for down in blk.downsamplers:  # pad (0, 1) below and right
                h = down.conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return self.conv_out(self.conv_norm_out(_run_mid(self.mid_block, h)))


class Decoder(nn.Module):
    def __init__(self, chans, layers, latent):
        super().__init__()
        rev = list(chans)[::-1]
        self.conv_in = Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0])
        self.up_blocks = nn.ModuleList()
        h = rev[0]
        for i, ch in enumerate(rev):
            blk = _Level()
            for _ in range(layers + 1):
                blk.resnets.append(VAEResnetBlock(h, ch))
                h = ch
            if i < len(rev) - 1:
                blk.upsamplers.append(_Resample(ch, 1, 1))
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(h, silu=True)
        self.conv_out = Conv2d(h, 3, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            for up in blk.upsamplers:
                h = up.conv(upsample2x(h))
        return self.conv_out(self.conv_norm_out(h))


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans, layers = list(cfg.block_out_channels), cfg.layers_per_block
        lat = cfg.latent_channels
        self.encoder = Encoder(chans, layers, lat)
        self.decoder = Decoder(chans, layers, lat)
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def encode(self, images):
        """[B, H, W, 3] in [0, 1] -> scaled posterior mean [B, h, w, 4]."""
        m = self.quant_conv(self.encoder(images * 2 - 1))
        return m[..., :self.cfg.latent_channels] * self.cfg.scaling_factor

    def decode(self, z):
        """Scaled latents -> images [B, H, W, 3] in [0, 1]."""
        x = self.decoder(self.post_quant_conv(z / self.cfg.scaling_factor))
        return torch.clamp(x / 2 + 0.5, 0.0, 1.0)


# --------------------------------------------------------------------------
# CLIP text encoder
# --------------------------------------------------------------------------


class CLIPAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x):
        B, S, C = x.shape

        def split(t):
            return t.reshape(B, S, self.heads, -1).transpose(1, 2)

        s = torch.matmul(split(self.q_proj(x)),
                         split(self.k_proj(x)).transpose(-1, -2))
        s = s / math.sqrt(C // self.heads)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, torch.finfo(s.dtype).min)
        out = torch.matmul(torch.softmax(s, dim=-1), split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(B, S, C))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.quick = cfg.hidden_act == "quick_gelu"
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick
                        else F.gelu(h))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class TextEncoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, ids):
        """[B, S] token ids -> the final LayerNorm'd states [B, S, C]."""
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding(pos)[None])
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)
