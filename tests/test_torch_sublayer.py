"""The plain versions of the port's single-pass attention and fused
cross-attention sublayer against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both packages.  Tolerances:

* fp32: 1e-5 (the same arithmetic; the sublayer folds the softmax scale
  times log2(e) into Wq and takes exp2, the JAX oracle divides the scores
  by sqrt(D) and takes exp: equal up to fp32 rounding);
* bf16 against the Pallas kernels in interpret mode: 5e-2 absolute on the
  O(1) outputs (both round y2, q, p, a and x3 to bf16, 2^-9 relative each,
  at slightly different points; ``tests/test_sublayer.py`` holds the JAX
  kernel to its oracle at the same bar).

Shapes cover kv_len below the key count, C not a multiple of 128 and head
dims 40, 64, 80 and 160 (every head dim the main paths send to the
single-pass kernel, at reduced Sq).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import to_np
from vidtome_torch.ops import attention as t_attn
from vidtome_torch.ops import sublayer as t_sub
from vidtome_tpu.ops import attention as j_attn
from vidtome_tpu.ops import sublayer as j_sub

torch.set_num_threads(2)

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2


@pytest.mark.parametrize("B,H,Sq,Skv,D,kv_valid", [
    (2, 3, 100, 77, 40, None),     # SD1.5 cross-attention head dim
    (2, 2, 64, 80, 64, 77),        # SD2.1 head dim, 77 of 80 keys valid
    (1, 2, 256, 256, 64, 200),     # 16x16 self-attention, masked tail
    (2, 2, 128, 77, 80, None),     # SD1.5 L1 cross-attention head dim
    (2, 2, 64, 77, 160, None),     # SD1.5 L2 / mid cross-attention
    (1, 2, 64, 256, 160, None),    # SD1.5 16x16 self-attention (Sq cut)
    (1, 2, 64, 64, 160, 50),       # SD1.5 mid self-attention, masked tail
])
def test_small_kv_plain_matches_jax(B, H, Sq, Skv, D, kv_valid):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, H, s, D)).astype(np.float32)
               for s in (Sq, Skv, Skv))
    got = to_np(t_attn.small_kv_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_valid_len=kv_valid))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = j_attn.small_kv_attention(jq, jk, jv, kv_valid_len=kv_valid,
                                       interpret=True)
    oracle = j_attn.reference_attention(jq, jk, jv, kv_valid_len=kv_valid)
    np.testing.assert_allclose(got, np.asarray(kernel), **FP32_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **FP32_TOL)


def test_attention_dispatch_by_kv_length():
    """Short KV goes to the single-pass wrapper, long KV and head dims it
    is not built for to flash: both plain on the CPU, so the choice is
    checked by the predicate the dispatch reads."""
    assert t_attn.small_kv_takes(64, 77) and t_attn.small_kv_takes(160, 256)
    assert not t_attn.small_kv_takes(40, 257)
    assert not t_attn.small_kv_takes(512, 64)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 300, 40)).astype(
        np.float32)) for _ in range(3))
    np.testing.assert_allclose(
        to_np(t_attn.attention(q, k, v)),
        to_np(t_attn.reference_attention(q, k, v)), **FP32_TOL)


def _sublayer_inputs(seed, B, S, C, skv):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, m=0.0):
        return (rng.normal(size=shape) * s + m).astype(np.float32)

    return dict(x=n(B, S, C), a1=n(B, S, C, s=0.5), k=n(B, skv, C),
                v=n(B, skv, C), wq=n(C, C, s=C ** -0.5),
                wout=n(C, C, s=C ** -0.5), bout=n(C, s=0.1),
                g2=n(C, s=0.1, m=1.0), b2=n(C, s=0.1), g3=n(C, s=0.1, m=1.0),
                b3=n(C, s=0.1))


def _port(inp, dtype, heads, kv_len):
    """The port's call: weights as nn.Linear ([out, in]) in ``dtype``."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("x", "a1", "k", "v", "wq", "wout"):
        t[k] = t[k].to(dtype)
    t["wq"], t["wout"] = t["wq"].t(), t["wout"].t()
    return t_sub.fused_cross_sublayer(**t, heads=heads, kv_len=kv_len)


# (B, S, C, heads, keys, kv_len)
SUBLAYER_SHAPES = [
    (2, 64, 320, 8, 77, 77),     # SD1.5 level 0: D = 40, C % 128 != 0
    (2, 40, 128, 2, 80, 77),     # D = 64, masked key tail, ragged S
    (1, 48, 160, 4, 77, 60),     # D = 40, C % 128 != 0, kv_len < keys
]


@pytest.mark.parametrize("B,S,C,heads,skv,kv_len", SUBLAYER_SHAPES)
def test_sublayer_plain_matches_jax_oracle_fp32(B, S, C, heads, skv, kv_len):
    inp = _sublayer_inputs(0, B, S, C, skv)
    x3, y3 = _port(inp, torch.float32, heads, kv_len)
    jx3, jy3 = j_sub.reference_cross_sublayer(
        **{k: jnp.asarray(v) for k, v in inp.items()}, heads=heads,
        kv_len=kv_len)
    np.testing.assert_allclose(to_np(x3), np.asarray(jx3), **FP32_TOL)
    np.testing.assert_allclose(to_np(y3), np.asarray(jy3), **FP32_TOL)


@pytest.mark.parametrize("B,S,C,heads,skv,kv_len", SUBLAYER_SHAPES)
def test_sublayer_plain_matches_pallas_kernel_bf16(B, S, C, heads, skv,
                                                   kv_len):
    inp = _sublayer_inputs(1, B, S, C, skv)
    x3, y3 = _port(inp, torch.bfloat16, heads, kv_len)
    assert x3.dtype == y3.dtype == torch.bfloat16
    bf = {k: (jnp.asarray(v, jnp.bfloat16) if k in ("x", "a1", "k", "v",
                                                      "wq", "wout")
              else jnp.asarray(v)) for k, v in inp.items()}
    jx3, jy3 = j_sub.fused_cross_sublayer(**bf, heads=heads, kv_len=kv_len,
                                          interpret=True)
    for got, want in ((x3, jx3), (y3, jy3)):
        err = np.abs(to_np(got) - np.asarray(want, np.float32)).max()
        assert err < BF16_ATOL, err


def test_sublayer_plain_masks_keys_past_kv_len():
    """Garbage rows past kv_len change nothing."""
    inp = _sublayer_inputs(2, 1, 32, 64, 77)
    want = _port(inp, torch.float32, 4, 77)
    inp["k"] = np.concatenate([inp["k"], np.full((1, 19, 64), 37.0,
                                                 np.float32)], 1)
    inp["v"] = np.concatenate([inp["v"], np.full((1, 19, 64), -5.0,
                                                 np.float32)], 1)
    got = _port(inp, torch.float32, 4, 77)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_block_rows_by_width():
    """A block takes 64 rows at every width; wider rows spread over more
    blocks of a cluster (320 columns a rank at most) instead of fewer rows
    a block."""
    plans = [t_sub.plan(2, 4096, c, c // 64, 77, 77)
             for c in (128, 320, 640, 1280, 2560)]
    assert [p.cluster for p in plans] == [1, 1, 2, 4, 8]
    assert [p.width for p in plans] == [128, 320, 320, 320, 320]
    assert all(p.grid == (64 * p.cluster, 2) for p in plans)
    with pytest.raises(ValueError):
        t_sub.plan(2, 4096, 5120, 80, 77, 77)
