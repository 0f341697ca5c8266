"""Fused cross-attention sublayer: a hand-written Hopper kernel and its
plain version.

Counterpart of ``vidtome_tpu/ops/sublayer.py``.  :func:`fused_cross_sublayer`
replaces the Pallas ``fused_cross_sublayer`` (``_sublayer_kernel``): one
call per transformer block computes

    h  = x + a1                    (attn1 residual)
    y2 = LayerNorm(h; g2, b2)      (norm2)
    q  = y2 Wq                     (to_q; softmax scale * log2(e) folded in)
    a  = softmax_per_head(q k^T) v (cross-attention over the text tokens)
    x3 = h + a Wout + bout         (to_out, attn2 residual)
    y3 = LayerNorm(x3; g3, b3)     (norm3, of the bf16-rounded x3)

and returns (x3, y3).  On a CUDA tensor it launches ``csrc/sublayer.cu``
(see the source note there for what bounds it and how the design
answers); on a CPU tensor it runs :func:`reference_cross_sublayer`.  K and
V come precomputed from the text context, as in the JAX package.

Contract details kept from the JAX kernel: LayerNorm statistics in fp32
with the one-pass variance ``max(E[h^2] - mu^2, 0)``; the softmax scale
times log2(e) folded into Wq and rounded to the working dtype, the softmax
in base 2; keys at or past ``kv_len`` masked; p normalised before the
product with v; norm3 reads the rounded x3.  Weights are in the port's
``torch.nn.Linear`` layout, [out, in].
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vidtome_torch.ops.cuda_build import build_library

_LOG2E = math.log2(math.e)
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may take
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 160)  # D rounded up to 16
_MAX_KV = 128                 # padded text tokens a launch may carry


def _layer_norm(h: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """Row LayerNorm in fp32 with the one-pass variance."""
    mu = h.mean(-1, keepdim=True)
    var = ((h * h).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (h - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _scaled_wq(wq: torch.Tensor, heads: int, dtype: torch.dtype):
    """Wq with the softmax scale * log2(e) folded in, in ``dtype``."""
    scale = _LOG2E / math.sqrt(wq.shape[0] // heads)
    return (wq.float() * scale).to(dtype)


def reference_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3,
                             heads: int, kv_len: int, eps: float = 1e-5):
    """Plain version of the kernel's arithmetic in x's dtype: products of
    values in that dtype summed in fp32, results rounded to it where the
    kernel rounds (y2, q, p, a, x3, y3).  In fp32 it is the JAX package's
    ``reference_cross_sublayer``.  x, a1: [B, S, C]; k, v: [B, Skv, C]
    (the first ``kv_len`` rows valid); wq, wout: [C, C] as nn.Linear
    weights; bout, g2, b2, g3, b3: [C]."""
    dt = x.dtype
    B, S, C = x.shape
    D = C // heads
    h = x.float() + a1.float()
    y2 = _layer_norm(h, g2, b2, eps).to(dt)
    q = (y2.float() @ _scaled_wq(wq, heads, dt).float().t()).to(dt)

    def split(t, s):  # [B, s, C] -> [B, heads, s, D] fp32
        return t.float().reshape(B, s, heads, D).transpose(1, 2)

    s = split(q, S) @ split(k[:, :kv_len], kv_len).transpose(-1, -2)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(dt)
    att = (p.float() @ split(v[:, :kv_len], kv_len)).to(dt)
    att = att.transpose(1, 2).reshape(B, S, C)
    x3 = (h + att.float() @ wout.float().t() + bout.float()).to(dt)
    return x3, _layer_norm(x3.float(), g3, b3, eps).to(dt)


@functools.cache
def _library():
    lib = build_library("vidtome_sublayer", ("sublayer.cu",))
    fn = lib.vidtome_fused_cross_sublayer
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_rows(C: int) -> int:
    """Rows per block, chosen by C so that two [rows, C] bf16 tiles fill
    shared memory: 128 up to C = 320, 64 up to 640, 32 up to 1280."""
    for rows, widest in ((128, 320), (64, 640), (32, 1280)):
        if C <= widest:
            return rows
    raise ValueError(f"fused sublayer kernel: C={C} wider than 1280")


def _launch(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3, heads: int,
            kv_len: int, eps: float):
    B, S, C = x.shape
    Skv = k.shape[1]
    D = C // heads
    dp = -(-D // 16) * 16
    kvp = -(-Skv // 16) * 16
    if heads * D != C or D % 8 or dp not in _HEAD_DIMS or C % 32:
        raise ValueError(f"fused sublayer kernel: unsupported C={C}, "
                         f"heads={heads} (C a multiple of 32, D = C / heads "
                         f"a multiple of 8 up to 160)")
    if kvp > _MAX_KV or not (0 < kv_len <= Skv):
        raise ValueError(f"fused sublayer kernel: {Skv} keys, kv_len "
                         f"{kv_len} (at most {_MAX_KV} keys)")
    for name, t, shape in (("x", x, (B, S, C)), ("a1", a1, (B, S, C)),
                           ("k", k, (B, Skv, C)), ("v", v, (B, Skv, C)),
                           ("wq", wq, (C, C)), ("wout", wout, (C, C))):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused sublayer kernel takes bf16, got "
                            f"{name}.dtype={t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: not on {x.device} or not 16-byte "
                             f"aligned")
    vecs = [t.to(x.device, torch.float32).contiguous()
            for t in (bout, g2, b2, g3, b3)]
    if any(t.shape != (C,) for t in vecs):
        raise ValueError("bout, g2, b2, g3, b3 must be [C]")
    rows = block_rows(C)
    smem = 2 * (2 * rows * (C + 8) + 2 * kvp * (dp + 8))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused sublayer kernel: {smem} bytes of shared "
                         f"memory at C={C}, D={D}, {Skv} keys")
    x3, y3 = torch.empty_like(x), torch.empty_like(x)
    wq_s = _scaled_wq(wq, heads, torch.bfloat16)
    ptrs = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in (
        x, a1, k, v, wq_s, wout, *vecs, x3, y3)))
    err = _library()(ptrs, B, S, C, heads, dp, rows // 16, Skv, kvp, kv_len,
                     eps, smem, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused sublayer launch failed: error {err} "
                           f"(x{tuple(x.shape)}, heads={heads}, Skv={Skv})")
    return x3, y3


def fused_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3,
                         heads: int, kv_len: int, eps: float = 1e-5):
    """(x3, y3), each [B, S, C] in x's dtype; see the module docstring.

    CUDA tensors launch the Hopper kernel (bf16 activations and weights;
    anything it cannot take raises); CPU tensors run
    :func:`reference_cross_sublayer`."""
    if not x.is_cuda:
        return reference_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2,
                                        g3, b3, heads, kv_len, eps)
    out = _launch(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3, heads, kv_len,
                  eps)
    fused_cross_sublayer.launches += 1
    return out


fused_cross_sublayer.launches = 0
