"""Attention: the hand-written Hopper flash kernel and its plain version.

Counterpart of ``vidtome_tpu/ops/attention.py``.  ``flash_attention``
replaces the Pallas ``flash_attention`` (``_flash_kernel``): on a CUDA
tensor it launches ``csrc/flash_attention.cu`` (mma.sync bf16 tensor-core
tiles, fp32 online softmax; see the source note there for what bounds it
and how the design answers), on a CPU tensor it runs
:func:`reference_attention`.  The TPU package routed short KV (<= 256) to
XLA by a v5e measurement; here every attention of the UNet and the VAE,
cross-attention over 77 text tokens included, goes through the kernel on
the card.  Routing by H100 numbers is later work.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vidtome_torch.ops.cuda_build import build_library

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_LOG2E = math.log2(math.e)
# head dims the library is built for: D is zero-padded to the next one
_PADDED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 160, 512)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid_len: int | None = None,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention, scores in fp32. q,k,v: [B, H, S, D]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if kv_valid_len is not None and kv_valid_len < k.shape[2]:
        mask = torch.arange(k.shape[2], device=k.device) < kv_valid_len
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


@functools.cache
def _library():
    lib = build_library("vidtome_flash", ("flash_attention.cu",))
    fn = lib.vidtome_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bf16, got {name}.dtype={t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name}: innermost dim must be contiguous and all "
                         f"strides multiples of 8, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _launch(q, k, v, kv_len: int, sm_scale: float) -> torch.Tensor:
    B, H, Sq, D = q.shape
    if D % 8 or -(-D // 16) * 16 not in _PADDED_HEAD_DIMS:
        raise ValueError(f"flash kernel: unsupported head dim {D}")
    if k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if not (0 < kv_len <= k.shape[2]):
        raise ValueError(f"kv_valid_len {kv_len} outside (0, {k.shape[2]}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        _check_operand(name, t)
    # [B, Sq, H, D] storage seen as [B, H, Sq, D]: the caller's merge of the
    # heads back into channels is then free.
    out = torch.empty(B, Sq, H, D, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    err = _library()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, H, Sq, kv_len, D, strides,
                     sm_scale * _LOG2E,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: error {err} "
                           f"(q{tuple(q.shape)}, kv_len={kv_len})")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid_len: int | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over the first ``kv_valid_len`` keys.
    q: [B, H, Sq, D]; k, v: [B, H, Skv, D] -> [B, H, Sq, D].

    CUDA tensors launch the Hopper kernel (bf16 only; anything it cannot
    take raises); CPU tensors run :func:`reference_attention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return reference_attention(q, k, v, kv_valid_len, sm_scale)
    kv_len = k.shape[2] if kv_valid_len is None else kv_valid_len
    out = _launch(q, k, v, kv_len, sm_scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
