"""CLIP text encoder (SD1.x: ViT-L/14, 12 layers, quick-gelu, 768 wide;
SD2.x: OpenCLIP ViT-H, 23 layers, exact gelu, 1024 wide; SDXL: ViT-L and
OpenCLIP bigG, 32 layers, 1280 wide, with a pooled projection).

Counterpart of ``vidtome_tpu/models/clip_text.py``: a pre-LayerNorm
transformer with causal masking whose final LayerNorm'd hidden state feeds
the UNet's cross-attention; SDXL's encoders give the penultimate layer's
state instead (``clip_skip``) and bigG also the EOS-pooled projection
(``projection_dim``).  Module names follow transformers'
``CLIPTextModel`` (``CLIPTextModelWithProjection``: ``text_projection``).
The causal attention is plain PyTorch in fp32, as the JAX package
computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"   # SD2.x OpenCLIP: "gelu"
    layer_norm_eps: float = 1e-5
    # SDXL: the hidden state clip_skip layers before the end, without the
    # final LayerNorm (SDXL takes the penultimate layer's, clip_skip=1)
    clip_skip: int = 0
    # > 0: also the EOS-pooled, final-LayerNorm'd state through a bias-free
    # projection (SDXL's text_encoder_2)
    projection_dim: int = 0


SD15_TEXT = CLIPTextConfig()
SD21_TEXT = CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                           intermediate_size=4096, hidden_act="gelu")
# SDXL's pair: CLIP ViT-L (penultimate states) and OpenCLIP bigG
# (penultimate states and the pooled projection)
SDXL_TEXT_1 = CLIPTextConfig(clip_skip=1)
SDXL_TEXT_2 = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                             intermediate_size=5120, hidden_act="gelu",
                             clip_skip=1, projection_dim=1280)
TINY_TEXT = CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_positions=16)
TINY_TEXT_2 = CLIPTextConfig(vocab_size=1000, hidden_size=16, num_layers=2,
                             num_heads=2, intermediate_size=32,
                             max_positions=16, clip_skip=1,
                             projection_dim=16)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, S, C = x.shape
        D = C // self.heads

        def split(t):
            return t.reshape(B, S, self.heads, D).transpose(1, 2)

        q = split(self.q_proj(x)) * (D ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(B, S, C)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"hidden_act {cfg.hidden_act!r}")
        self.quick = cfg.hidden_act == "quick_gelu"
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        # gelu: the exact (erf) form, transformers' ACT2FN["gelu"]
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick
                        else F.gelu(h))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        self.text_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.projection_dim else None)

    def forward(self, input_ids: torch.Tensor):
        """[B, S] ids -> [B, S, hidden]: the final LayerNorm'd states, or
        with ``clip_skip`` k the states k layers before the end without
        it.  With ``projection_dim`` returns (states, pooled [B, proj]):
        the final LayerNorm'd state at the first EOS through
        ``text_projection``."""
        tm = self.text_model
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + \
            tm.embeddings.position_embedding(pos)[None]
        mask = torch.ones(S, S, dtype=torch.bool,
                          device=input_ids.device).tril()[None, None]
        states = []
        for layer in tm.encoder.layers:
            x = layer(x, mask)
            states.append(x)
        final = tm.final_layer_norm(x)
        out = states[-1 - self.cfg.clip_skip] if self.cfg.clip_skip else final
        if self.text_projection is None:
            return out
        # CLIP's EOS id is the last of the vocabulary; argmax takes the
        # first maximum: the first EOS, as the JAX model
        eos = (input_ids == self.cfg.vocab_size - 1).int().argmax(dim=1)
        pooled = final[torch.arange(input_ids.shape[0],
                                    device=input_ids.device), eos]
        return out, self.text_projection(pooled)

