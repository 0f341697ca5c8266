"""CLIP text encoder (SD1.x: ViT-L/14, 12 layers, quick-gelu, 768 wide).

Counterpart of ``vidtome_tpu/models/clip_text.py`` for ``SD15_TEXT`` and
``TINY_TEXT``: a pre-LayerNorm transformer with causal masking whose final
LayerNorm'd hidden state feeds the UNet's cross-attention.  Module names
follow transformers' ``CLIPTextModel``.  The causal attention is plain
PyTorch in fp32, as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    layer_norm_eps: float = 1e-5


SD15_TEXT = CLIPTextConfig()
TINY_TEXT = CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                           num_heads=2, intermediate_size=64,
                           max_positions=16)


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
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


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

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, S, hidden], the final LayerNorm'd states."""
        tm = self.text_model
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + \
            tm.embeddings.position_embedding(pos)[None]
        mask = torch.ones(S, S, dtype=torch.bool,
                          device=input_ids.device).tril()[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)

