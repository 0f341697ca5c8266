"""GroupNorm(+SiLU): a Triton kernel for Hopper and its plain version.

Counterpart of ``vidtome_tpu/ops/groupnorm.py``.  :func:`group_norm`
replaces the Pallas ``group_norm_stats`` (``_stats_kernel``) with the
normalize pass of ``fused_group_norm``: on a CUDA tensor it launches the
Triton kernels below, on a CPU tensor it runs
:func:`reference_group_norm`.  Every GroupNorm of the UNet and the VAE goes
through it on the card; the TPU row/channel thresholds were v5e
measurements and are not carried over.

What bounds it on the H100: memory bandwidth.  The work is a reduction
followed by one elementwise pass, two reads and one write of the
activation; the largest slab on the main path is [8, 512*512, 128] bf16
(512 MiB read twice).  The design:

  * pass 1 (``_partial_kernel``) reads whole contiguous NHWC rows of one
    batch element and accumulates per-channel fp32 sums and sums of
    squares over a span of rows, one program per (batch, span), into a
    [B, n_spans, C] buffer: coalesced loads, no atomics, so the sum order
    is fixed and the result is the same run to run;
  * pass 2 (``_stats_kernel``) reduces the spans and the channels of one
    (batch, group) into mean and rsqrt(max(E[x^2] - mean^2, 0) + eps),
    the clamp the Pallas kernel and flax apply;
  * pass 3 (``_apply_kernel``) folds mean, rstd, scale and bias into one
    multiply-add per element, optionally applies SiLU, and writes the
    input dtype.

The TPU kernel's [C, G] / [G, C] collapse matmuls are a layout trick for
its lanes and are not used.  Triton is imported, and the kernels compiled,
on the first CUDA call; importing this module needs no Triton.

:func:`full_group_norm` replaces the Pallas ``full_group_norm``, the
single-call two-phase GroupNorm: one cooperative launch of
``csrc/group_norm_full.cu`` (its source note says what bounds it and how
the design answers).  ``VIDTOME_GN_MODE`` picks the route of every CUDA
GroupNorm, as it does in the JAX package (``groupnorm.py:293-301``):
``auto`` and ``stats`` (the default) take the three Triton passes,
``full`` the single-launch kernel.  ``xla`` (and
``VIDTOME_DISABLE_PALLAS_GN``) would run the plain version on the card,
which hides the kernels, so a CUDA tensor raises under it; the TPU's
row and element thresholds are not carried over.  CPU tensors always take
:func:`reference_group_norm`.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from vidtome_torch.ops.cuda_build import BUILD_DIR, build_library

# Triton resolves ``tl`` in this module's globals when it compiles the
# kernels below; _kernels() binds it on the first CUDA call.
tl = None
_JIT = None
_MAX_SPANS = 64          # spans per batch element in pass 1 (pass 2 tile)
_TILE_ELEMS = 8192       # elements of one [BLOCK_R, BLOCK_C] tile
# least elements a block of the single-launch kernel streams: smaller slabs
# take fewer blocks, so the partials every block re-reduces stay few
_SPAN_ELEMS = 32768
GN_MODES = ("auto", "stats", "full")


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain GroupNorm over x [B, ..., C] (channels last), statistics in
    fp32 with var = max(E[x^2] - mean^2, 0) as flax computes it."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.reshape(B, -1, num_groups, C // num_groups).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, -1, C) * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def _partial_kernel(x_ptr, sum_ptr, sq_ptr, rows, C, span,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    s = tl.program_id(1)
    n_spans = tl.num_programs(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + b.to(tl.int64) * rows * C
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    r_lo = s * span
    r_hi = tl.minimum(r_lo + span, rows)
    for r0 in range(r_lo, r_hi, BLOCK_R):
        rr = r0 + tl.arange(0, BLOCK_R)
        m = (rr < r_hi)[:, None] & cmask[None, :]
        xv = tl.load(base + rr.to(tl.int64)[:, None] * C + cols[None, :],
                     mask=m, other=0.0).to(tl.float32)
        acc += tl.sum(xv, axis=0)
        acc2 += tl.sum(xv * xv, axis=0)
    out = (b * n_spans + s) * C + cols
    tl.store(sum_ptr + out, acc, mask=cmask)
    tl.store(sq_ptr + out, acc2, mask=cmask)


def _stats_kernel(sum_ptr, sq_ptr, mean_ptr, rstd_ptr, n_spans, C, G,
                  group_size, inv_count, eps,
                  BLOCK_S: tl.constexpr, BLOCK_G: tl.constexpr):
    b = tl.program_id(0)
    g = tl.program_id(1)
    ss = tl.arange(0, BLOCK_S)
    cc = tl.arange(0, BLOCK_G)
    m = (ss < n_spans)[:, None] & (cc < group_size)[None, :]
    offs = (b * n_spans + ss)[:, None] * C + g * group_size + cc[None, :]
    tot = tl.sum(tl.sum(tl.load(sum_ptr + offs, mask=m, other=0.0), axis=1),
                 axis=0)
    tot2 = tl.sum(tl.sum(tl.load(sq_ptr + offs, mask=m, other=0.0), axis=1),
                  axis=0)
    mean = tot * inv_count
    var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
    tl.store(mean_ptr + b * G + g, mean)
    tl.store(rstd_ptr + b * G + g, 1.0 / tl.sqrt(var + eps))


def _apply_kernel(x_ptr, y_ptr, w_ptr, bias_ptr, mean_ptr, rstd_ptr, rows, C,
                  G, group_size, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                  SILU: tl.constexpr):
    b = tl.program_id(0)
    rb = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    grp = cols // group_size
    mean = tl.load(mean_ptr + b * G + grp, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + b * G + grp, mask=cmask, other=0.0)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    bb = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    mul = rstd * w
    add = bb - mean * mul
    rr = rb * BLOCK_R + tl.arange(0, BLOCK_R)
    m = (rr < rows)[:, None] & cmask[None, :]
    offs = (b.to(tl.int64) * rows + rr.to(tl.int64))[:, None] * C + cols[None, :]
    xv = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
    y = xv * mul[None, :] + add[None, :]
    if SILU:
        y = y * tl.sigmoid(y)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)


def _kernels():
    global tl, _JIT
    if _JIT is None:
        # Triton's compile cache goes under build/ with the other kernels,
        # not under $HOME
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        import triton
        import triton.language as tl  # noqa: F811  (binds the module global)

        _JIT = tuple(triton.jit(f) for f in
                     (_partial_kernel, _stats_kernel, _apply_kernel))
    return _JIT


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def stats_from_partials(sums: torch.Tensor, sqs: torch.Tensor,
                         num_groups: int, count: int,
                         eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: per-span channel sums and sums of squares [B, n_spans, C]
    (fp32) over ``count`` rows -> group mean and rstd [B, G], reduced in a
    fixed order."""
    _, stats, _ = _kernels()
    B, n_spans, C = sums.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    gsize = C // num_groups
    mean = torch.empty(B, num_groups, dtype=torch.float32, device=sums.device)
    rstd = torch.empty_like(mean)
    stats[(B, num_groups)](sums, sqs, mean, rstd, n_spans, C, num_groups,
                           gsize, 1.0 / (count * gsize), eps,
                           BLOCK_S=_next_pow2(n_spans),
                           BLOCK_G=_next_pow2(gsize), num_warps=4)
    return mean, rstd


def _tiling(rows: int, C: int) -> tuple[int, int, int]:
    """(block_r, block_c, span) of passes 1 and 3."""
    block_c = _next_pow2(C)
    block_r = max(1, _TILE_ELEMS // block_c)
    n_spans = max(1, min(_MAX_SPANS, -(-rows // block_r)))
    span = -(-rows // n_spans)
    return block_r, block_c, -(-span // block_r) * block_r


def group_stats(x: torch.Tensor, num_groups: int,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm statistics of a contiguous CUDA x [B, ..., C]: mean and
    rstd [B, G] in fp32 (passes 1 and 2).  The fused resnet block
    (``ops/resnet.py``) takes its GN1 statistics from here."""
    partial, _, _ = _kernels()
    B, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (B * C)
    block_r, block_c, span = _tiling(rows, C)
    n_spans = -(-rows // span)
    sums = torch.empty(B, n_spans, C, dtype=torch.float32, device=x.device)
    sqs = torch.empty_like(sums)
    partial[(B, n_spans)](x, sums, sqs, rows, C, span,
                          BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8)
    return stats_from_partials(sums, sqs, num_groups, rows, eps)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    _, _, apply = _kernels()
    B, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (B * C)
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (C,) or t.device != x.device:
            raise ValueError(f"{name}: expected [{C}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    x = x.contiguous()
    mean, rstd = group_stats(x, num_groups, eps)
    block_r, block_c, _ = _tiling(rows, C)
    y = torch.empty_like(x)
    apply[(B, -(-rows // block_r))](x, y, weight, bias, mean, rstd, rows, C,
                                    num_groups, C // num_groups,
                                    BLOCK_R=block_r, BLOCK_C=block_c,
                                    SILU=silu, num_warps=8)
    return y


def _gn_mode() -> str:
    """The GroupNorm route of CUDA tensors, from the environment as the
    JAX package reads it."""
    if os.environ.get("VIDTOME_DISABLE_PALLAS_GN"):
        return "xla"
    return os.environ.get("VIDTOME_GN_MODE", "auto").lower()


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over x [B, ..., C] (channels last) with fp32
    statistics; returns x's dtype.  CUDA tensors launch the Triton kernels
    (``VIDTOME_GN_MODE`` auto / stats) or :func:`full_group_norm` (full);
    CPU tensors run :func:`reference_group_norm`."""
    if not x.is_cuda:
        return reference_group_norm(x, weight, bias, num_groups, eps, silu)
    mode = _gn_mode()
    if mode == "full":
        return full_group_norm(x, weight, bias, num_groups, eps, silu)
    if mode not in GN_MODES:
        raise ValueError(f"GroupNorm mode {mode!r} (VIDTOME_GN_MODE / "
                         f"VIDTOME_DISABLE_PALLAS_GN) would run the plain "
                         f"version on the card; the port takes {GN_MODES}")
    y = _launch(x, weight, bias, num_groups, eps, silu)
    group_norm.launches += 1
    return y


@functools.cache
def _full_library():
    lib = build_library("vidtome_group_norm_full", ("group_norm_full.cu",))
    cap = lib.vidtome_group_norm_full_capacity
    cap.argtypes = [ctypes.c_int] * 3
    cap.restype = ctypes.c_int
    fn = lib.vidtome_group_norm_full
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return cap, fn


@functools.cache
def _full_capacity(device: int, C: int, G: int, dtype: int) -> int:
    """Blocks the cooperative grid may have on ``device`` (all resident)."""
    with torch.cuda.device(device):
        return _full_library()[0](C, G, dtype)


def _launch_full(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"single-launch GroupNorm takes bf16 or fp32, got "
                        f"{x.dtype}")
    B, C = x.shape[0], x.shape[-1]
    rows = x.numel() // (B * C)
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (C,) or t.device != x.device:
            raise ValueError(f"{name}: expected [{C}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    x = x.contiguous()
    dtype = 0 if x.dtype == torch.bfloat16 else 1
    cap = _full_capacity(x.device.index, C, num_groups, dtype)
    if cap < B or x.data_ptr() % 16:
        raise ValueError(f"single-launch GroupNorm cannot take x "
                         f"{tuple(x.shape)} {x.dtype} in {num_groups} groups "
                         f"(resident blocks {cap}, address {x.data_ptr()})")
    spans = max(1, min(cap // B, rows, -(-rows * C // _SPAN_ELEMS)))
    psum = torch.empty(B, spans, C, dtype=torch.float32, device=x.device)
    psq = torch.empty_like(psum)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    y = torch.empty_like(x)
    err = _full_library()[1](
        x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(),
        psum.data_ptr(), psq.data_ptr(), B, rows, C, num_groups, spans, eps,
        int(silu), dtype, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"single-launch GroupNorm failed: error {err} "
                           f"(x{tuple(x.shape)}, {spans} spans a batch "
                           f"element)")
    return y


def full_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over x [B, ..., C] in one launch of the CUDA kernel
    (two reads and one write of x); replaces Pallas ``full_group_norm``.
    CPU tensors run :func:`reference_group_norm`."""
    if not x.is_cuda:
        return reference_group_norm(x, weight, bias, num_groups, eps, silu)
    y = _launch_full(x, weight, bias, num_groups, eps, silu)
    full_group_norm.launches += 1
    return y


group_norm.launches = 0
full_group_norm.launches = 0
