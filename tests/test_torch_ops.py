"""Port kernels' plain versions vs the JAX package, in fp32 on the CPU.

The port's plain attention is held against the Pallas flash kernel in
interpret mode and against ``reference_attention``; its plain
GroupNorm(+SiLU) against ``fused_group_norm`` in interpret mode.  atol 1e-5:
fp32 summation-order noise on O(1) values.  The plain fused resnet block is
held against the Pallas ``fused_resnet`` in interpret mode on bf16 inputs
(2e-2 of max |ref|: both round activations and h to bf16, at different
points of an fp32 sum order) and against the port's unfused block in fp32
(1e-5); the plain best match against the Pallas ``best_match`` in
interpret mode and ``best_match_reference`` (max to 1e-6, argmax equal).
The Hopper kernels themselves are checked on the card by
``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vidtome_torch.models.layers import ResnetBlock2D
from vidtome_torch.ops import attention as t_attn
from vidtome_torch.ops import groupnorm as t_gn
from vidtome_torch.ops import matching as t_match
from vidtome_torch.ops import resnet as t_res
from vidtome_tpu.ops import attention as j_attn
from vidtome_tpu.ops import groupnorm as j_gn
from vidtome_tpu.ops import matching as j_match
from vidtome_tpu.ops import resnet as j_res

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


def _resnet_params(rng, B, H, W, Ci, Co):
    """Inputs of a resnet block in the JAX layout (HWIO convs, [Ci, Co]
    shortcut), fp32 numpy."""
    n = lambda *shape, s=1.0, m=0.0: (  # noqa: E731
        rng.normal(size=shape) * s + m).astype(np.float32)
    p = dict(x=n(B, H, W, Ci), tvec=n(B, Co, s=0.3), n1s=n(Ci, s=0.2, m=1),
             n1b=n(Ci, s=0.1), w1=n(3, 3, Ci, Co, s=0.15), b1=n(Co, s=0.1),
             n2s=n(Co, s=0.2, m=1), n2b=n(Co, s=0.1),
             w2=n(3, 3, Co, Co, s=0.15), b2=n(Co, s=0.1))
    if Ci != Co:
        p.update(ws=n(Ci, Co, s=0.3), bs=n(Co, s=0.1))
    return p


def _port_resnet_args(p, dtype):
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    oihw = lambda w: t(w.transpose(3, 2, 0, 1).copy())  # noqa: E731
    ws = t(p["ws"].T.copy()) if "ws" in p else None
    bs = t(p["bs"]) if "bs" in p else None
    return (t(p["x"]).to(dtype), t(p["tvec"]), t(p["n1s"]), t(p["n1b"]),
            oihw(p["w1"]), t(p["b1"]), t(p["n2s"]), t(p["n2b"]),
            oihw(p["w2"]), t(p["b2"]), ws, bs)


@pytest.mark.parametrize("B,H,W,Ci,Co", [
    (2, 8, 8, 32, 32),       # identity shortcut, tiny width
    (2, 8, 8, 64, 32),       # 1x1 projection shortcut
    (1, 8, 16, 256, 256),    # two 128-lane channel chunks in the TPU kernel
    (1, 8, 8, 320, 320),     # SD1.5 level-0 width (ragged vs 128 lanes)
])
def test_plain_fused_resnet_matches_jax_kernel(B, H, W, Ci, Co):
    p = _resnet_params(np.random.default_rng(2), B, H, W, Ci, Co)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["x"] = jp["x"].astype(jnp.bfloat16)
    want = np.asarray(j_res.fused_resnet(
        jp["x"], jp["tvec"], jp["n1s"], jp["n1b"], jp["w1"], jp["b1"],
        jp["n2s"], jp["n2b"], jp["w2"], jp["b2"], jp.get("ws"), jp.get("bs"),
        num_groups=32, interpret=True), np.float32)
    got = t_res.fused_resnet(*_port_resnet_args(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, Co)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 2e-2
    assert t_res.fused_resnet.launches == 0  # CPU tensors: plain path


@pytest.mark.parametrize("Ci,Co", [(32, 32), (96, 32), (64, 64)])
def test_plain_fused_resnet_is_the_unfused_block_in_fp32(Ci, Co):
    torch.manual_seed(0)
    block = ResnetBlock2D(Ci, Co, 128)
    with torch.no_grad():
        for prm in block.parameters():  # non-trivial norms and biases
            prm.add_(0.1 * torch.randn_like(prm))
        x = torch.randn(2, 8, 8, Ci)
        temb = torch.randn(2, 128)
        want = block(x, temb)
        got = block(x, temb, resnet_mode="fused")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        block(x, temb, resnet_mode="measured")


def _unit(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.mark.parametrize("B,S,D,C,dup", [
    (2, 300, 211, 64, False),    # D not a multiple of 128
    (2, 256, 384, 32, True),     # exact duplicate dst rows
    (1, 130, 1000, 320, True),   # SD1.5 level-0 width, ragged D
])
def test_plain_best_match_matches_jax(B, S, D, C, dup):
    rng = np.random.default_rng(3)
    src, dst = _unit(rng, (B, S, C)), _unit(rng, (B, D, C))
    if dup:  # the second half repeats the first: ties go to the lower index
        dst[:, D // 2:2 * (D // 2)] = dst[:, :D // 2]
    sj, dj = (jnp.asarray(a, jnp.bfloat16) for a in (src, dst))
    st, dt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (sj, dj))
    got_max, got_idx = t_match.best_match(st, dt)
    assert got_idx.dtype == torch.long
    for mx, ix in (j_match.best_match(sj, dj, block_s=128, block_d=128,
                                      interpret=True),
                   j_match.best_match_reference(sj, dj)):
        np.testing.assert_allclose(got_max.numpy(), np.asarray(mx),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ix))
    if dup:
        copy = (got_idx >= D // 2) & (got_idx < 2 * (D // 2))
        assert not copy.any()
    assert t_match.best_match.launches == 0
