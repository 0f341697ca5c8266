"""GEGLU's gate, h * gelu(gate): a hand-written Hopper kernel and its plain
version.

:func:`geglu` takes the [..., 2 * inner] output of the feed-forward's first
projection, [h | gate], and returns h * gelu(gate) (exact erf gelu) in one
pass over it: ``csrc/geglu.cu`` on a CUDA tensor (bf16 or fp32; anything it
cannot take raises), :func:`geglu_plain` on a CPU tensor.  It replaces no
Pallas kernel (XLA fused this on the TPU, ``vidtome_tpu/models/layers.py``
``GEGLUFeedForward``); eager PyTorch's gelu and product take two passes and
an [..., inner] intermediate.  The kernel rounds as the eager path does, so
its output equals :func:`geglu_plain`'s on the card to the bit.

The checks that depend only on the input's shape, strides, dtype and device
run once per signature (:func:`launch_plan`); per call the wrapper checks
the data pointer's alignment, allocates the output and makes one ctypes
call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vidtome_torch.ops.cuda_build import build_library

# csrc/geglu.cu: rows a thread (kRows) and threads a block (kMaxThreads)
_ROWS = 4
_MAX_THREADS = 512
_ACCESS = 16  # bytes a vector access moves


def geglu_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version: y = [h | gate] on the last dim -> h * gelu(gate)."""
    h, gate = y.chunk(2, dim=-1)
    return h * F.gelu(gate)


class ThreadShape(NamedTuple):
    """How the kernel covers a row of ``inner`` outputs: ``vec`` elements an
    access (16 bytes' worth, or 1 where a row is not 16-byte aligned),
    ``threads_x`` accesses a block row (whole warps), ``col_blocks`` blocks
    across a row, ``threads_y`` rows of threads a block (each thread takes
    ``_ROWS`` rows)."""
    vec: int
    threads_x: int
    threads_y: int
    col_blocks: int


def thread_shape(inner: int, element_size: int) -> ThreadShape:
    """The kernel's block shape for rows of ``inner`` outputs of
    ``element_size`` bytes.  A row's accesses are split over the fewest
    column blocks of at most 256 threads that leave the fewest spare
    threads (whole warps each): 160 accesses (SD1.5's level 0 in bf16) one
    block row of 160, 640 four of 160 rather than three of 224.  Then as
    many rows of threads as fit in a block of :data:`_MAX_THREADS`."""
    vec = _ACCESS // element_size
    if inner % vec:
        vec = 1  # rows are not 16-byte aligned: one element an access
    accesses = inner // vec

    def threads(blocks: int) -> int:  # a block row's accesses, whole warps
        return -(-accesses // (32 * blocks)) * 32

    fewest = -(-accesses // 256)
    blocks = min(range(fewest, fewest + 4), key=lambda b: b * threads(b))
    tx = threads(blocks)
    return ThreadShape(vec, tx, max(1, _MAX_THREADS // tx), blocks)


class LaunchPlan(NamedTuple):
    """What every launch with one signature of y shares: the output's shape
    and the C entry's integer arguments (rows, inner, fp32, then the
    :class:`ThreadShape`)."""
    out_shape: tuple[int, ...]
    ints: tuple[int, ...]


def check_input(y: torch.Tensor) -> None:
    """Raises on what a launch cannot take: a dtype other than bf16 or fp32,
    an odd or empty last dim, no rows, a layout other than contiguous."""
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"geglu kernel takes bf16 or fp32, got {y.dtype}")
    if y.dim() < 1 or y.shape[-1] == 0 or y.shape[-1] % 2:
        raise ValueError(f"geglu takes [..., 2 * inner], got "
                         f"{tuple(y.shape)}")
    if y.numel() == 0:
        raise ValueError(f"geglu kernel: no rows in {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError(f"geglu kernel: y must be contiguous, got strides "
                         f"{y.stride()} for {tuple(y.shape)}")


def check_pointer(y: torch.Tensor) -> int:
    """y's data pointer; raises unless it is 16-byte aligned."""
    ptr = y.data_ptr()
    if ptr % _ACCESS:
        raise ValueError(f"geglu kernel: y must start on 16 bytes, got "
                         f"address {ptr:#x}")
    return ptr


# signature -> LaunchPlan: the checks that depend only on shape, strides,
# dtype and device run once per signature
_PLANS: dict[tuple, LaunchPlan] = {}


def launch_plan(y: torch.Tensor) -> LaunchPlan:
    """The :class:`LaunchPlan` of y, made (after :func:`check_input`) at the
    first call with its signature and looked up after."""
    key = (y.shape, y.stride(), y.dtype, y.device)
    plan = _PLANS.get(key)
    if plan is None:
        check_input(y)
        inner = y.shape[-1] // 2
        shape = thread_shape(inner, y.element_size())
        plan = _PLANS[key] = LaunchPlan(
            (*y.shape[:-1], inner),
            (y.numel() // (2 * inner), inner, int(y.dtype == torch.float32),
             *shape))
    return plan


@functools.cache
def _library():
    lib = build_library("vidtome_geglu", ("geglu.cu",))
    fn = lib.vidtome_geglu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def geglu(y: torch.Tensor) -> torch.Tensor:
    """y = [h | gate] on the last dim ([..., 2 * inner]) -> h * gelu(gate)
    ([..., inner]), gelu the exact (erf) form.

    CUDA tensors launch the Hopper kernel (contiguous bf16 or fp32 from a
    16-byte aligned base; anything else raises); CPU tensors run
    :func:`geglu_plain`."""
    if not y.is_cuda:
        return geglu_plain(y)
    plan = launch_plan(y)
    ptr = check_pointer(y)
    out = y.new_empty(plan.out_shape)
    err = _library()(ptr, out.data_ptr(), *plan.ints,
                     torch._C._cuda_getCurrentRawStream(y.get_device()))
    if err != 0:
        raise RuntimeError(f"geglu launch failed: error {err} "
                           f"(y{tuple(y.shape)}, {y.dtype})")
    geglu.launches += 1
    return out


geglu.launches = 0
