"""Best match of cosine scores: a hand-written Hopper kernel and its plain
version.

Counterpart of ``vidtome_tpu/ops/matching.py``.  :func:`best_match`
replaces the Pallas ``best_match`` (``_match_kernel``): for every src token
its best dst score and the lowest dst index reaching it, without storing
the [S, D] score matrix.  On a CUDA tensor it launches
``csrc/matching.cu`` (mma.sync bf16 tiles, fp32 accumulation, a running
max/argmax per row; see the source note), on a CPU tensor it runs
:func:`reference_best_match`.  The JAX package kept this kernel behind
``use_fused`` by a v5e measurement; here the merge engine always launches
it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vidtome_torch.ops.cuda_build import build_library

_MAX_C = 1728  # the src tile of 64 rows x C channels lives in shared memory


def reference_best_match(src: torch.Tensor, dst: torch.Tensor):
    """Plain version: fp32 scores of src [B, S, C] x dst [B, D, C] ->
    (max [B, S] fp32, argmax [B, S] int64, the lowest index on ties)."""
    scores = torch.bmm(src.float(), dst.float().transpose(1, 2))
    return scores.max(dim=-1)


@functools.cache
def _library():
    lib = build_library("vidtome_matching", ("matching.cu",))
    fn = lib.vidtome_best_match
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(src: torch.Tensor, dst: torch.Tensor):
    if src.dtype != torch.bfloat16 or dst.dtype != torch.bfloat16:
        raise TypeError(f"best_match kernel takes bf16, got {src.dtype} and "
                        f"{dst.dtype}")
    B, S, C = src.shape
    if dst.dim() != 3 or dst.shape[0] != B or dst.shape[2] != C:
        raise ValueError(f"shape mismatch src{tuple(src.shape)} "
                         f"dst{tuple(dst.shape)}")
    if C % 8 or C > _MAX_C or S == 0 or dst.shape[1] == 0:
        raise ValueError(f"best_match kernel: unsupported shape src"
                         f"{tuple(src.shape)} dst{tuple(dst.shape)} (C a "
                         f"multiple of 8 up to {_MAX_C})")
    if dst.device != src.device:
        raise ValueError(f"dst on {dst.device}, src on {src.device}")
    src, dst = src.contiguous(), dst.contiguous()
    out_max = torch.empty(B, S, dtype=torch.float32, device=src.device)
    out_idx = torch.empty(B, S, dtype=torch.long, device=src.device)
    err = _library()(src.data_ptr(), dst.data_ptr(), out_max.data_ptr(),
                     out_idx.data_ptr(), B, S, dst.shape[1], C,
                     torch.cuda.current_stream(src.device).cuda_stream)
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
