"""Cross-frame token merging as gather plans (replace mode).

Counterpart of ``vidtome_tpu/core/merge.py``.  A matching produces a
:class:`MergePlan` of index tensors; ``merge`` keeps ``[unmerged src | dst]``
and ``unmerge`` is one gather back to the original positions.  Token layout
is the reference's: a "joined" sequence is ``[unm_pre prefix | frame_0 |
frame_1 | ...]``, and a merge keeps ``[new_unmerged | dst frames | previous
prefix]``.

The random choices (which frame of each stride window is dst) are plain
integers drawn by the caller from its draw source, so the dst token runs are
host-side Python ints and ``merge`` slices them instead of gathering.

Semantics kept from the JAX package: the metric is cosine-normalised in
fp32 and cast to bf16 before scoring (scores accumulate in fp32); every src
token's best dst comes from ``ops/matching.best_match`` (the Hopper kernel
on the card, the plain score product plus max/argmax on the CPU, ties to
the lowest dst index either way); the kept set
is the ``S - r`` lowest best-scores (ties broken by position); and
``len_quantum`` rounds ``r`` up so merged lengths land on tile multiples,
which changes ``r`` and so is part of the semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from vidtome_torch.ops.matching import best_match


@dataclasses.dataclass
class MergePlan:
    """One bipartite matching over batch ``B``: ``S`` src tokens, ``D`` dst
    tokens, ``r`` merged, ``U = S - r`` kept, sequence length ``N = S + D``.

      merge_gather:   [B, U + D]  merged[i] = x[merge_gather[i]]
      unmerge_gather: [B, N]      restored[n] = merged[unmerge_gather[n]]
      unm_num:        U
      dst_starts / dst_run_len / dst_prefix: the dst set as contiguous
        runs ``x[:, s:s + run_len]`` for s in dst_starts, then
        ``x[:, :dst_prefix]``.
    """

    merge_gather: torch.Tensor
    unmerge_gather: torch.Tensor
    unm_num: int
    dst_starts: list[int]
    dst_run_len: int
    dst_prefix: int


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the token axis: x [B, N, C], idx [B, K] -> [B, K, C]."""
    B, N, C = x.shape
    flat = idx + torch.arange(B, device=idx.device)[:, None] * N
    return x.reshape(B * N, C).index_select(0, flat.reshape(-1)).reshape(
        B, idx.shape[1], C)


def _build_plan(metric: torch.Tensor, a_idx: torch.Tensor,
                b_idx: torch.Tensor, r: int, align_batch: bool,
                dst_starts: list[int], dst_run_len: int,
                dst_prefix: int) -> MergePlan:
    """Cosine scores src->dst, greedy top-r by best-match score, then the
    gather maps (reference merge.py:83-117).  a_idx/b_idx: [B, S] / [B, D]."""
    B, N, _ = metric.shape
    S, D = a_idx.shape[-1], b_idx.shape[-1]
    U = S - r

    mnorm = metric / metric.float().norm(dim=-1, keepdim=True).clamp_min(1e-6)
    src_m = _take(mnorm, a_idx).to(torch.bfloat16)
    dst_m = _take(mnorm, b_idx).to(torch.bfloat16)
    node_max, node_idx = best_match(src_m, dst_m)  # [B, S] each

    if align_batch:
        # one matching shared by every lane: each src token takes its best
        # lane's score and dst (reference merge.py:93-108)
        node_max, lane = node_max.max(dim=0, keepdim=True)
        node_idx = node_idx.gather(0, lane)

    # the U lowest best-scores, lowest first, ties by position (top_k of
    # the negated scores)
    unm_idx = torch.sort(node_max, dim=-1, stable=True).indices[:, :U]
    if align_batch:
        unm_idx = unm_idx.expand(B, U)
        node_idx = node_idx.expand(B, S)

    kept = a_idx.gather(1, unm_idx)
    merge_gather = torch.cat([kept, b_idx], dim=1)

    # every original position reads one merged position: dst j <- U + j,
    # src <- U + its best dst, then the kept src overwrite with their slot
    ar = lambda n: torch.arange(n, device=metric.device).expand(B, n)  # noqa: E731
    inv = torch.zeros(B, N, dtype=torch.long, device=metric.device)
    inv.scatter_(1, b_idx, U + ar(D))
    inv.scatter_(1, a_idx, U + node_idx)
    inv.scatter_(1, kept, ar(U))
    return MergePlan(merge_gather=merge_gather, unmerge_gather=inv,
                     unm_num=U, dst_starts=dst_starts,
                     dst_run_len=dst_run_len, dst_prefix=dst_prefix)


def merge(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Replace-mode merge: [B, N, C] -> [B, U + D, C], a gather of the kept
    src rows plus contiguous slices of the dst runs."""
    parts = [_take(x, plan.merge_gather[:, :plan.unm_num])]
    parts += [x[:, s:s + plan.dst_run_len] for s in plan.dst_starts]
    if plan.dst_prefix:
        parts.append(x[:, :plan.dst_prefix])
    return torch.cat(parts, dim=1)


def unmerge(y: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Invert a merge: [B, U + D, C] -> [B, N, C]; merged src positions read
    their matched dst token (reference merge.py:135-155)."""
    return _take(y, plan.unmerge_gather)


def unmerge_all(y: torch.Tensor, plans: Sequence[MergePlan]) -> torch.Tensor:
    for plan in reversed(plans):
        y = unmerge(y, plan)
    return y


# ---------------------------------------------------------------------------
# Local (intra-chunk, cross-frame) matching — reference merge.py:20-159.
# ---------------------------------------------------------------------------


def quantize_r(S: int, r: int, D: int, quantum: int | None,
               min_len: int = 1024) -> int:
    """Round the merge count ``r`` up so the merged length ``(S - r) + D``
    lands on a multiple of ``quantum`` (``quantum // 4``, at least 256,
    below ``4 * quantum``), never dropping more than half the kept set and
    never for merged lengths under ``min_len``.  ``None`` keeps
    ``r = int(S * ratio)``."""
    if not quantum:
        return r
    U = S - r
    M = U + D
    if M < min_len:
        return r
    q = quantum if M >= 4 * quantum else max(quantum // 4, 256)
    slack = M % q
    if slack == 0 or U - slack < 0 or (U - slack) * 2 < U:
        return r
    return r + slack


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1


def round_stride(F: int, target_stride: int) -> int:
    """Dst stride of a round over F frames: the largest divisor of F that is
    <= target_stride, or F itself (one dst frame) when none >= 2 fits."""
    s = _largest_divisor_leq(F, min(max(1, target_stride), F))
    return s if s >= 2 else F


def local_merge_rounds(F: int, target_stride: int) -> list[int]:
    """Frame counts at the start of each matching round
    (reference patch.py:44-54)."""
    rounds = []
    curF = F
    while curF > 1:
        rounds.append(curF)
        curF = curF // round_stride(curF, target_stride)
    return rounds


def local_matching(metric: torch.Tensor, F: int, ratio: float, unm_pre: int,
                   draw: int, target_stride: int = 4,
                   align_batch: bool = False,
                   len_quantum: int | None = None) -> MergePlan | None:
    """One round over F joined frames: frame ``draw`` of every ``stride``
    window is dst (with the previous prefix), the other frames are src.
    ``draw`` in [0, stride).  None for ratio <= 0 or F < 2."""
    B, N, _ = metric.shape
    if ratio <= 0 or F < 2:
        return None
    tnum = (N - unm_pre) // F
    stride = round_stride(F, target_stride)
    if not 0 <= draw < stride:
        raise ValueError(f"dst draw {draw} outside [0, {stride})")
    dst_frames = [f for f in range(F) if f % stride == draw]
    src_frames = [f for f in range(F) if f % stride != draw]

    dev = metric.device
    tok = torch.arange(tnum, device=dev)
    a_idx = (unm_pre + torch.tensor(src_frames, device=dev)[:, None] * tnum
             + tok).reshape(-1)
    b_idx = torch.cat([
        (unm_pre + torch.tensor(dst_frames, device=dev)[:, None] * tnum
         + tok).reshape(-1),
        torch.arange(unm_pre, device=dev)])

    S = len(src_frames) * tnum
    r = min(S, int(S * ratio))
    r = quantize_r(S, r, b_idx.shape[0], len_quantum)
    return _build_plan(metric, a_idx.expand(B, S),
                       b_idx.expand(B, b_idx.shape[0]), r, align_batch,
                       dst_starts=[unm_pre + f * tnum for f in dst_frames],
                       dst_run_len=tnum, dst_prefix=unm_pre)


def compute_local_merge(tokens: torch.Tensor, F: int, ratio: float,
                        draws: Sequence[int], target_stride: int = 4,
                        align_batch: bool = False,
                        len_quantum: int | None = None):
    """Merge F joined frames down to one set, one round per entry of
    :func:`local_merge_rounds` with ``draws[i]`` as round i's dst frame
    (reference patch.py:44-56).  Returns (merged_tokens, plans); undo with
    :func:`unmerge_all`."""
    plans: list[MergePlan] = []
    unm = 0
    for draw, curF in zip(draws, local_merge_rounds(F, target_stride)):
        plan = local_matching(tokens, curF, ratio, unm, int(draw),
                              target_stride=target_stride,
                              align_batch=align_batch,
                              len_quantum=len_quantum)
        if plan is None:
            break
        tokens = merge(tokens, plan)
        unm += plan.unm_num
        plans.append(plan)
    return tokens, plans


# ---------------------------------------------------------------------------
# Global (inter-chunk, vs token bank) matching — reference merge.py:343-463.
# ---------------------------------------------------------------------------


def two_set_matching(metric: torch.Tensor, src_len: int, ratio: float,
                     align_batch: bool = False,
                     len_quantum: int | None = None) -> MergePlan | None:
    """Match the first ``src_len`` tokens (src) against the rest (dst)."""
    B, N, _ = metric.shape
    if ratio <= 0:
        return None
    S, D = src_len, N - src_len
    r = min(S, int(S * ratio))
    r = quantize_r(S, r, D, len_quantum)
    dev = metric.device
    return _build_plan(metric, torch.arange(S, device=dev).expand(B, S),
                       (S + torch.arange(D, device=dev)).expand(B, D), r,
                       align_batch, dst_starts=[S], dst_run_len=D,
                       dst_prefix=0)


def join_frames(x: torch.Tensor, F: int) -> torch.Tensor:
    """(B*F, N, C) -> (B, F*N, C)."""
    BF, N, C = x.shape
    return x.reshape(BF // F, F * N, C)


def split_frames(x: torch.Tensor, F: int) -> torch.Tensor:
    """(B, F*N, C) -> (B*F, N, C)."""
    B, FN, C = x.shape
    return x.reshape(B * F, FN // F, C)
