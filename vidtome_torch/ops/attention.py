"""Attention: the hand-written Hopper kernels and their plain version.

Counterpart of ``vidtome_tpu/ops/attention.py``.  Two kernels, each on a
CUDA tensor launching its ``csrc/`` source (see the source notes for what
bounds them and how the designs answer) and on a CPU tensor running
:func:`reference_attention`:

* ``flash_attention`` replaces the Pallas ``flash_attention``
  (``_flash_kernel``, ``csrc/flash_attention.cu``): K/V tiles streamed by
  TMA through a 2-stage ring, both products on ``wgmma``, fp32 online
  softmax; :func:`tma_geometry` is the view TMA reads each operand through;
* ``small_kv_attention`` replaces the Pallas ``small_kv_attention``
  (``_small_kv_kernel``, ``csrc/small_kv_attention.cu``): the whole KV of
  at most 256 keys in one tile, staged by TMA once per head, Q tiles
  through a 2-stage TMA ring, both products on ``wgmma``, a single softmax
  pass, O out by TMA store.

Both wrappers run the checks that depend only on the signature of q, k, v
(shapes, strides, dtypes, devices, ``kv_valid_len``) once per signature
(:func:`launch_plan`); per call they check the data pointers' alignment,
allocate the output and make one ctypes call.

:func:`attention` dispatches as the JAX package's does (``_SMALL_KV_XLA``):
KV of at most 256 tokens (cross-attention over the 77 text tokens, the
unmerged self-attention at 16x16 and 8x8 latents) takes the single-pass
kernel, longer KV the flash kernel.  On the TPU that short branch went to
XLA by a v5e measurement; on the card it is the hand-written kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from vidtome_torch.ops.cuda_build import build_library

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_LOG2E = math.log2(math.e)
# bf16 columns of one 128-byte swizzle atom: the flash kernel holds D padded
# up to a multiple of it in shared memory (TMA zero-fills the padding)
_TMA_ATOM = 64
# the flash kernel's padded head dims (csrc/flash_attention.cu's dispatch)
_FLASH_PADDED_HEAD_DIMS = (64, 128, 192, 512)
# the single-pass kernel: head dims (D padded to a multiple of 16) and key
# counts (padded up to the next entry) it is built for
_SMALL_KV_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 160)
_SMALL_KV_LENS = (64, 80, 128, 256)
# KV lengths at or below this take the single-pass kernel (the JAX
# package's short-KV branch, ``_SMALL_KV_XLA``)
SMALL_KV = _SMALL_KV_LENS[-1]


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


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernels take bf16, got {name}.dtype="
                        f"{t.dtype}")
    if t.stride(-1) != 1 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name}: innermost dim must be contiguous and the "
                         f"other strides positive multiples of 8 elements "
                         f"(16 bytes), got {t.stride()}")


def _aligned_pointers(*ts: torch.Tensor) -> list[int]:
    """The tensors' data pointers; raises unless each is 16-byte aligned
    (TMA's rule for a base address)."""
    ptrs = [t.data_ptr() for t in ts]
    if any(p % 16 for p in ptrs):
        raise ValueError(f"data pointer not 16-byte aligned: {ptrs}")
    return ptrs


def _check_qkv(q, k, v, kv_len: int) -> None:
    """What a launch needs of q, k, v beyond their data pointers: shapes,
    ``kv_len``, devices, dtype and strides."""
    B, H, Sq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if not (0 < kv_len <= k.shape[2]):
        raise ValueError(f"kv_valid_len {kv_len} outside (0, {k.shape[2]}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        _check_layout(name, t)


class LaunchPlan(NamedTuple):
    """What every launch with one signature of q, k, v and ``kv_len``
    shares: the output's shape and strides ([B, H, Sq, D] over [B, Sq, H, D]
    storage, so the caller's merge of the heads back into channels is
    free), the C entry's integer arguments (B, H, Sq, kv_len, D, then what
    the kernel's check adds) and the (b, h, s) strides of q, k, v and the
    output, as the C entries take them."""
    out_shape: tuple[int, int, int, int]
    out_strides: tuple[int, int, int, int]
    ints: tuple[int, ...]
    strides: ctypes.Array


# signature -> LaunchPlan: the checks that depend only on shapes, strides,
# dtypes, devices and kv_len run once per signature
_PLANS: dict[tuple, LaunchPlan] = {}


def launch_plan(q, k, v, kv_len: int, check) -> LaunchPlan:
    """The :class:`LaunchPlan` of q, k, v at ``kv_len``, made (after
    ``check(q, k, v)``, which returns the kernel's own integer arguments,
    and the shape, dtype and stride checks, which raise what a launch cannot
    take) at the first call with its signature and looked up after.  The
    data pointers' alignment is not part of it: the wrappers check it every
    call."""
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, kv_len,
           check)
    plan = _PLANS.get(key)
    if plan is None:
        extra = check(q, k, v)
        _check_qkv(q, k, v, kv_len)
        B, H, Sq, D = q.shape
        out_strides = (Sq * H * D, D, H * D, 1)
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *out_strides[:3])
        plan = _PLANS[key] = LaunchPlan((B, H, Sq, D), out_strides,
                                        (B, H, Sq, kv_len, D, *extra),
                                        strides)
    return plan


def _launch(fn, what: str, q, k, v, kv_len: int, sm_scale: float,
            check) -> torch.Tensor:
    """One launch of the C entry ``fn``: the plan, the per-call pointer
    check, the output, one ctypes call on the current stream; raises on a
    nonzero return."""
    plan = launch_plan(q, k, v, kv_len, check)
    ptrs = _aligned_pointers(q, k, v)
    out = q.new_empty_strided(plan.out_shape, plan.out_strides)
    # the current stream's raw handle, as torch.cuda.current_stream(
    # q.device).cuda_stream gives it without making a Stream object
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    err = fn(*ptrs, out.data_ptr(), *plan.ints, plan.strides,
             sm_scale * _LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err} "
                           f"(q{tuple(q.shape)}, k{tuple(k.shape)}, "
                           f"kv_len={kv_len})")
    return out


class TmaGeometry(NamedTuple):
    """How TMA reads one [B, H, S, D] operand of the flash kernel."""
    dims: tuple[int, int, int, int]     # (D, rows, H, B), innermost first
    strides: tuple[int, int, int]       # bytes between rows, heads, batches
    padded_d: int                       # D in shared memory


def flash_padded_head_dim(D: int) -> int:
    """D padded up to a whole number of swizzle atoms, for the head dims
    the flash kernel is built for (a multiple of 8 up to 192, or 512 after
    padding); raises for any other."""
    dp = -(-D // _TMA_ATOM) * _TMA_ATOM
    if D <= 0 or D % 8 or dp not in _FLASH_PADDED_HEAD_DIMS:
        raise ValueError(f"flash kernel: unsupported head dim {D}")
    return dp


def tma_geometry(t: torch.Tensor, rows: int) -> TmaGeometry:
    """The TMA view of a bf16 [B, H, S, D] operand, as the kernel's
    ``encode`` builds it (a strided view is read in place): dims
    (D, rows, H, B) with ``rows`` of S (the keys past ``kv_valid_len`` read
    as zero), the byte strides of rows, heads and batches, and D padded in
    shared memory.  Raises what the wrapper raises before a launch: on a
    head dim the kernel is not built for, an inner dim that is not
    contiguous, a stride that is not a positive multiple of 16 bytes, a
    base that is not 16-byte aligned."""
    B, H, S, D = t.shape
    dp = flash_padded_head_dim(D)
    _check_layout("TMA operand", t)
    _aligned_pointers(t)
    strides = tuple(t.stride(i) * t.element_size() for i in (2, 1, 0))
    return TmaGeometry((D, rows, H, B), strides, dp)


def _check_flash_head_dim(q, k, v) -> tuple:
    flash_padded_head_dim(q.shape[-1])
    return ()


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
    out = _launch(_library(), "flash attention", q, k, v, kv_len, sm_scale,
                  _check_flash_head_dim)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.cache
def _small_kv_library():
    lib = build_library("vidtome_small_kv", ("small_kv_attention.cu",))
    fn = lib.vidtome_small_kv_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def small_kv_takes(D: int, Skv: int) -> bool:
    """Whether the single-pass kernel is built for head dim ``D`` and
    ``Skv`` keys."""
    return (D % 8 == 0 and -(-D // 16) * 16 in _SMALL_KV_HEAD_DIMS
            and 0 < Skv <= SMALL_KV)


def _small_kv_keys(Skv: int) -> int:
    """The padded key count of the kernel instance that takes Skv keys."""
    return next(n for n in _SMALL_KV_LENS if n >= Skv)


def _check_small_kv_dims(q, k, v) -> tuple[int, int]:
    """Raises unless the kernel is built for q's head dim and k's key
    count; returns the C entry's dp (D padded to 16) and kvp (the padded
    key count)."""
    D, Skv = q.shape[-1], k.shape[2]
    if not small_kv_takes(D, Skv):
        raise ValueError(f"small-KV kernel: unsupported head dim {D} or "
                         f"{Skv} keys (at most {SMALL_KV})")
    return -(-D // 16) * 16, _small_kv_keys(Skv)


def small_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_valid_len: int | None = None,
                       sm_scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with the whole KV (at most 256 keys) in one
    tile.  q: [B, H, Sq, D]; k, v: [B, H, Skv, D] -> [B, H, Sq, D].

    CUDA tensors launch the Hopper kernel (bf16 only; anything it cannot
    take raises); CPU tensors run :func:`reference_attention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return reference_attention(q, k, v, kv_valid_len, sm_scale)
    kv_len = k.shape[2] if kv_valid_len is None else kv_valid_len
    out = _launch(_small_kv_library(), "small-KV attention", q, k, v, kv_len,
                  sm_scale, _check_small_kv_dims)
    small_kv_attention.launches += 1
    return out


small_kv_attention.launches = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid_len: int | None = None,
              sm_scale: float | None = None) -> torch.Tensor:
    """Dispatch (JAX ``ops/attention.py:304-323``): KV of at most
    :data:`SMALL_KV` tokens to :func:`small_kv_attention`, longer KV (and
    head dims it is not built for) to :func:`flash_attention`.
    q, k, v: [B, H, S, D]."""
    if small_kv_takes(q.shape[-1], k.shape[2]):
        return small_kv_attention(q, k, v, kv_valid_len, sm_scale)
    return flash_attention(q, k, v, kv_valid_len, sm_scale)
