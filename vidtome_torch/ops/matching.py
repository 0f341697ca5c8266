"""Best match of cosine scores: a hand-written Hopper kernel and its plain
version.

Counterpart of ``vidtome_tpu/ops/matching.py``.  :func:`best_match`
replaces the Pallas ``best_match`` (``_match_kernel``): for every src token
its best dst score and the lowest dst index reaching it, without storing
the [S, D] score matrix.  On a CUDA tensor it launches
``csrc/matching.cu`` (TMA-fed ``wgmma`` scores against a src tile held in
shared memory, a running max/argmax per row in registers; see the source
note) with the launch of :func:`match_plan`; on a CPU tensor it runs
:func:`reference_best_match`.  The JAX package kept this kernel behind
``use_fused`` by a v5e measurement; here the merge engine always launches
it on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vidtome_torch.ops.cuda_build import build_library
from vidtome_torch.ops.resnet import H100_SMS, _sm_count

MAX_C = 1728
SMEM_MAX = 232_448  # a block's shared memory on Hopper
# csrc/matching.cu: src rows a block (64 a consumer warpgroup, 1 to 3 of
# them), the bytes of a ring stage's dst box (128 rows x 64 bf16
# channels), the ring's stages
_BLOCK_ROWS = (64, 128, 192)
_DST_BOX = 128 * 128
_STAGES = 4


def reference_best_match(src: torch.Tensor, dst: torch.Tensor):
    """Plain version: fp32 scores of src [B, S, C] x dst [B, D, C] ->
    (max [B, S] fp32, argmax [B, S] int64, the lowest index on ties)."""
    scores = torch.bmm(src.float(), dst.float().transpose(1, 2))
    return scores.max(dim=-1)


class MatchPlan(NamedTuple):
    """One launch of the kernel: ``rows`` src rows a block (64 a consumer
    warpgroup), whether the src tile stays in shared memory for the whole
    sweep over dst (``resident``) or rides the ring beside each dst box,
    the grid (row tiles, batch) and the dynamic shared memory of a block
    (the resident src tile, the ring, its barriers, 1024 bytes of
    alignment slack)."""
    rows: int
    resident: bool
    grid: tuple[int, int]
    smem: int


def _smem(rows: int, atoms: int, resident: bool) -> int:
    """A block's dynamic shared memory, as ``Tiles::smem`` of the source:
    the src tile (``atoms`` boxes of 64 channels x ``rows``, 128 bytes a
    row) if resident, the ring's stages (a dst box, and the src box when
    not resident), 2 * stages + 1 barriers, the alignment slack."""
    src_box = rows * 128
    stage = _DST_BOX + (0 if resident else src_box)
    return ((atoms * src_box if resident else 0) + _STAGES * stage
            + 8 * (2 * _STAGES + 1) + 1024)


@functools.lru_cache(maxsize=256)
def match_plan(B: int, S: int, D: int, C: int,
               sms: int = H100_SMS) -> MatchPlan:
    """The launch of the kernel for src [B, S, C] x dst [B, D, C] on a card
    of ``sms`` SMs.  Every block sweeps all of dst, so its time is its src
    rows', and the card's is the busiest SM's: ceil(blocks / sms) blocks of
    ``rows`` rows each.  Among 64, 128 and 192 rows a block, the src tile
    resident first (streamed, it is read again per dst tile), then the
    least busiest-SM rows, then the most rows a block (each dst tile is
    read from L2 once per block).  At the level-0 round, [2, 12288] rows:
    128 blocks of 192 (one wave), not 192 of 128 (1.45 waves)."""
    atoms = -(-C // 64)
    plans = []
    for rows in _BLOCK_ROWS:
        resident = _smem(rows, atoms, True) <= SMEM_MAX
        blocks = -(-S // rows) * B
        busiest = -(-blocks // sms) * rows
        plans.append((not resident, busiest, -rows, MatchPlan(
            rows, resident, (-(-S // rows), B), _smem(rows, atoms, resident))))
    return min(plans, key=lambda p: p[:3])[3]


def check_operands(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Raises on what a launch cannot take: dtype, shapes, devices, and
    the layout TMA reads (contiguous, bases on 16 bytes)."""
    if src.dtype != torch.bfloat16 or dst.dtype != torch.bfloat16:
        raise TypeError(f"best_match kernel takes bf16, got {src.dtype} and "
                        f"{dst.dtype}")
    if src.dim() != 3 or dst.dim() != 3:
        raise ValueError(f"best_match takes [B, S, C] and [B, D, C], got src"
                         f"{tuple(src.shape)} dst{tuple(dst.shape)}")
    B, S, C = src.shape
    if dst.shape[0] != B or dst.shape[2] != C:
        raise ValueError(f"shape mismatch src{tuple(src.shape)} "
                         f"dst{tuple(dst.shape)}")
    if (C % 8 or not 0 < C <= MAX_C or S == 0 or dst.shape[1] == 0
            or not 0 < B < 65536):
        raise ValueError(f"best_match kernel: unsupported shape src"
                         f"{tuple(src.shape)} dst{tuple(dst.shape)} (C a "
                         f"multiple of 8 up to {MAX_C}, S, D >= 1)")
    if dst.device != src.device:
        raise ValueError(f"dst on {dst.device}, src on {src.device}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("best_match kernel: src and dst must be contiguous")
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("best_match kernel: src and dst must start on 16 "
                         "bytes (TMA)")


@functools.cache
def _library():
    lib = build_library("vidtome_matching", ("matching.cu",))
    fn = lib.vidtome_best_match
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(src: torch.Tensor, dst: torch.Tensor):
    check_operands(src, dst)
    B, S, C = src.shape
    D = dst.shape[1]
    plan = match_plan(B, S, D, C, _sm_count(src.get_device()))
    out_max = torch.empty(B, S, dtype=torch.float32, device=src.device)
    out_idx = torch.empty(B, S, dtype=torch.long, device=src.device)
    err = _library()(src.data_ptr(), dst.data_ptr(), out_max.data_ptr(),
                     out_idx.data_ptr(), B, S, D, C, plan.rows,
                     int(plan.resident),
                     torch._C._cuda_getCurrentRawStream(src.get_device()))
    if err != 0:
        raise RuntimeError(f"best_match launch failed: error {err} "
                           f"(src{tuple(src.shape)}, dst{tuple(dst.shape)})")
    return out_max, out_idx


def best_match(src: torch.Tensor, dst: torch.Tensor):
    """Per-src best dst of the scores src [B, S, C] x dst [B, D, C]:
    (max [B, S] fp32, argmax [B, S] int64), ties to the lowest dst index.

    CUDA tensors launch the Hopper kernel (bf16 only; anything it cannot
    take raises); CPU tensors run :func:`reference_best_match`."""
    if not src.is_cuda:
        return reference_best_match(src, dst)
    out = _launch(src, dst)
    best_match.launches += 1
    return out


best_match.launches = 0
