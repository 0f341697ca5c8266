"""The Hopper kernels of vidtome_torch against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA device
(the kernels have no CPU mode).  This file imports no JAX, so it also runs
on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Each kernel runs in bf16 and is held against its plain version in fp32 on
the same bf16 inputs.  Tolerances: attention, 2e-2 absolute on O(1)
outputs (bf16 probabilities and bf16 output, 2^-8 relative each);
GroupNorm, 3e-2 relative to max(1, |y|) (one bf16 ulp of values up to 4 is
2^-6, plus fp32 sums in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vidtome_torch.ops import attention as t_attn
from vidtome_torch.ops import groupnorm as t_gn

torch.set_num_threads(2)

ATTN_TOL = 2e-2
GN_TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, shape, cuda, scale=1.0, shift=0.0):
    a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(cuda, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Skv,D,kv_valid", [
    (2, 8, 5120, 5120, 40, None),    # merged L0 self-attention
    (2, 8, 1536, 1536, 80, None),    # merged L1 self-attention
    (8, 8, 256, 256, 160, None),     # L2 per frame
    (2, 8, 300, 300, 40, 211),       # ragged length + caller padding mask
    (8, 8, 4096, 77, 40, None),      # cross-attention vs 77 text tokens
    (2, 1, 1024, 1024, 512, None),   # VAE mid block, one head
    (2, 2, 100, 64, 16, None),       # tiny test widths
])
def test_flash_kernel_matches_plain(cuda, B, H, Sq, Skv, D, kv_valid):
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, (B, H, s, D), cuda) for s in (Sq, Skv, Skv))
    before = t_attn.flash_attention.launches
    got = t_attn.flash_attention(q, k, v, kv_valid_len=kv_valid)
    torch.cuda.synchronize()
    assert t_attn.flash_attention.launches == before + 1
    want = t_attn.reference_attention(q.float(), k.float(), v.float(),
                                      kv_valid_len=kv_valid)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() < ATTN_TOL


@pytest.mark.cuda
def test_flash_kernel_takes_head_views(cuda):
    """[B, S, H*D] projections viewed as [B, H, S, D] need no copy."""
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 333, 8, 40
    x = [_bf16(rng, (B, S, H * D), cuda) for _ in range(3)]
    q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in x)
    got = t_attn.flash_attention(q, k, v)
    want = t_attn.reference_attention(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() < ATTN_TOL


@pytest.mark.cuda
def test_flash_kernel_rejects_fp32(cuda):
    q = torch.zeros(1, 1, 64, 40, device=cuda)
    with pytest.raises(TypeError):
        t_attn.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("B,rows,C,silu,eps", [
    (8, 4096, 320, True, 1e-5),
    (8, 64, 2560, True, 1e-5),
    (2, 1000, 96, False, 1e-6),
    (8, 16384, 128, True, 1e-5),
])
def test_group_norm_kernel_matches_plain(cuda, B, rows, C, silu, eps):
    rng = np.random.default_rng(3)
    x = _bf16(rng, (B, rows, C), cuda, scale=2.0, shift=0.5)
    w = torch.from_numpy(rng.normal(size=C).astype(np.float32) + 1).to(cuda)
    b = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(cuda)
    before = t_gn.group_norm.launches
    got = t_gn.group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert t_gn.group_norm.launches == before + 1
    want = t_gn.reference_group_norm(x.float(), w, b, 32, eps, silu)
    assert got.dtype == torch.bfloat16
    err = ((got.float() - want).abs() / want.abs().clamp_min(1.0)).max()
    assert err.item() < GN_TOL
