"""Port kernels' plain versions vs the JAX package, in fp32 on the CPU.

The port's plain attention is held against the Pallas flash kernel in
interpret mode and against ``reference_attention``; its plain
GroupNorm(+SiLU) against ``fused_group_norm`` in interpret mode.  atol 1e-5:
fp32 summation-order noise on O(1) values.  The Hopper kernels themselves
are checked on the card by ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vidtome_torch.ops import attention as t_attn
from vidtome_torch.ops import groupnorm as t_gn
from vidtome_tpu.ops import attention as j_attn
from vidtome_tpu.ops import groupnorm as j_gn

torch.set_num_threads(2)


def _qkv(seed, B, H, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, s, D)).astype(np.float32)
                 for s in (Sq, Skv, Skv))


@pytest.mark.parametrize("Sq,Skv,D,kv_valid", [
    (128, 128, 16, None),
    (300, 300, 40, None),     # unaligned merged length, SD1.5 L0 head dim
    (300, 300, 40, 211),      # KV padding mask
    (256, 77, 40, None),      # cross-attention against 77 text tokens
    (128, 256, 80, None),     # SD1.5 L1 head dim
    (128, 256, 80, 130),
])
def test_plain_attention_matches_jax(Sq, Skv, D, kv_valid):
    q, k, v = _qkv(0, 2, 2, Sq, Skv, D)
    got = t_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_valid_len=kv_valid)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_ref = j_attn.reference_attention(jq, jk, jv, kv_valid_len=kv_valid)
    want_flash = j_attn.flash_attention(jq, jk, jv, kv_valid_len=kv_valid,
                                        block_q=128, block_k=128,
                                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_flash), atol=1e-5,
                               rtol=0)
    assert t_attn.flash_attention.launches == 0  # CPU tensors: plain path


@pytest.mark.parametrize("B,rows,C,G,silu,eps", [
    (2, 64, 320, 32, True, 1e-5),
    (2, 256, 128, 32, True, 1e-5),
    (1, 128, 640, 32, False, 1e-6),
    (3, 16, 64, 32, False, 1e-5),
])
def test_plain_group_norm_matches_jax(B, rows, C, G, silu, eps):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(B, rows, C)) * 2 + 0.5).astype(np.float32)
    w = (rng.normal(size=C) + 1).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    got = t_gn.group_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), G, eps, silu)
    want = j_gn.fused_group_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), G, eps, silu, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert t_gn.group_norm.launches == 0
