"""Cross-frame token merging as gather plans.

Counterpart of ``vidtome_tpu/core/merge.py``.  A matching produces a
:class:`MergePlan` of index tensors; ``merge`` keeps ``[unmerged src | dst]``
(``"replace"``, the reference's default, or ``"mean"``: each dst token
averaged with the src tokens matched to it) and ``unmerge`` is one gather
back to the original positions.  Token layout is the reference's: a
"joined" sequence is ``[unm_pre prefix | frame_0 | frame_1 | ...]``, and a
merge keeps ``[new_unmerged | dst frames | previous prefix]``.

The random choices (which frame of each stride window is dst) are plain
integers drawn by the caller from its draw source, so the dst token runs are
host-side Python ints and ``merge`` slices them instead of gathering.

Semantics kept from the JAX package: the metric is cosine-normalised in
fp32 and cast to bf16 before scoring (scores accumulate in fp32); every src
token's best dst comes from ``ops/matching.best_match`` (the Hopper kernel
on the card, the plain score product plus max/argmax on the CPU, ties to
the lowest dst index either way); the kept set
is the ``S - r`` lowest best-scores (ties broken by position; under
``keep_sorted_indices`` all src tokens are ordered by descending score, the
first ``r`` merged and the rest kept in that order, as the JAX package's
sorted plans have them); and
``len_quantum`` rounds ``r`` up so merged lengths land on tile multiples,
which changes ``r`` and so is part of the semantics.

In a profiler's trace the matchings (index builds, scores, sorts, plan
gathers and scatters) run in ``vidtome/merge_plan`` spans and the plans'
application (``merge``, ``unmerge``, ``unmerge_all`` and a computed
``partition``) in ``vidtome/merge_apply`` spans; neither nests in the
other, so a kernel belongs to one side.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from vidtome_torch.logging_utils import span
from vidtome_torch.ops.matching import best_match


@dataclasses.dataclass
class MergePlan:
    """One bipartite matching over batch ``B``: ``S`` src tokens, ``D`` dst
    tokens, ``r`` merged, ``U = S - r`` kept, sequence length ``N = S + D``.

      merge_gather:   [B, U + D]  merged[i] = x[merge_gather[i]]
      unmerge_gather: [B, N]      restored[n] = merged[unmerge_gather[n]]
      a_idx, b_idx:   [B, S] / [B, D] src / dst token positions in x
      unm_idx:        [B, U] kept tokens, positions within a_idx
      src_idx:        [B, r] merged tokens, positions within a_idx, by
                      descending score (``keep_sorted_indices`` only: mean
                      mode needs them, replace mode does not)
      dst_idx:        [B, r] the matched dst of each, positions within
                      b_idx (``keep_sorted_indices`` only)
      dst_starts / dst_run_len / dst_prefix: the dst set as contiguous
        runs ``x[:, s:s + run_len]`` for s in dst_starts, then
        ``x[:, :dst_prefix]`` (None where the dst set is scattered, as in
        :func:`spatial_matching_2d`: merge gathers it then).
    """

    merge_gather: torch.Tensor
    unmerge_gather: torch.Tensor
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    unm_idx: torch.Tensor
    src_idx: torch.Tensor | None = None
    dst_idx: torch.Tensor | None = None
    dst_starts: list[int] | None = None
    dst_run_len: int | None = None
    dst_prefix: int = 0

    @property
    def unm_num(self) -> int:
        return self.unm_idx.shape[-1]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the token axis: x [B, N, C], idx [B, K] -> [B, K, C]."""
    B, N, C = x.shape
    flat = idx + torch.arange(B, device=idx.device)[:, None] * N
    return x.reshape(B * N, C).index_select(0, flat.reshape(-1)).reshape(
        B, idx.shape[1], C)


def _build_plan(metric: torch.Tensor, a_idx: torch.Tensor,
                b_idx: torch.Tensor, r: int, align_batch: bool,
                keep_sorted_indices: bool = False,
                dst_starts: list[int] | None = None,
                dst_run_len: int | None = None,
                dst_prefix: int = 0) -> MergePlan:
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

    src_idx = dst_idx = None
    if keep_sorted_indices:
        # every src token by descending score, ties by position (JAX's
        # stable argsort of the negated scores): the first r merge
        order = torch.sort(-node_max, dim=-1, stable=True).indices
        src_idx, unm_idx = order[:, :r], order[:, r:]
        dst_idx = node_idx.gather(1, src_idx)
    else:
        # the U lowest best-scores, lowest first, ties by position (top_k
        # of the negated scores)
        unm_idx = torch.sort(node_max, dim=-1, stable=True).indices[:, :U]
    if align_batch:
        unm_idx = unm_idx.expand(B, U)
        node_idx = node_idx.expand(B, S)
        if keep_sorted_indices:
            src_idx, dst_idx = src_idx.expand(B, r), dst_idx.expand(B, r)

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
                     a_idx=a_idx, b_idx=b_idx, unm_idx=unm_idx,
                     src_idx=src_idx, dst_idx=dst_idx, dst_starts=dst_starts,
                     dst_run_len=dst_run_len, dst_prefix=dst_prefix)


def plan_rows(plan: MergePlan, rows: slice) -> MergePlan:
    """The plan of the batch rows ``rows`` of ``plan`` (a rank's joined
    rows under the data axis of a mesh)."""
    fields = ("merge_gather", "unmerge_gather", "a_idx", "b_idx", "unm_idx",
              "src_idx", "dst_idx")
    return dataclasses.replace(plan, **{
        f: getattr(plan, f)[rows] for f in fields
        if getattr(plan, f) is not None})


MERGE_MODES = ("replace", "mean")


def merge(x: torch.Tensor, plan: MergePlan,
          mode: str = "replace") -> torch.Tensor:
    """Apply a merge plan: [B, N, C] -> [B, U + D, C].

    ``replace``: the kept src rows then the dst rows; a plan with dst runs
    gathers only the kept rows and slices the runs.  ``mean``: each dst
    row averaged with every src row matched to it, itself included
    (reference merge.py:127-131, scatter_reduce 'mean' include_self): a
    scatter-add of the merged src rows onto ``U + dst_idx`` over the
    replace-mode rows, divided by the counts, in ``x.dtype``; it needs a
    plan built with ``keep_sorted_indices``."""
    if mode not in MERGE_MODES:
        raise ValueError(f"unknown merge mode: {mode}")
    with span("merge_apply"):
        return _merge(x, plan, mode)


def _merge(x: torch.Tensor, plan: MergePlan, mode: str) -> torch.Tensor:
    if mode == "replace" and plan.dst_starts is not None:
        parts = [_take(x, plan.merge_gather[:, :plan.unm_num])]
        parts += [x[:, s:s + plan.dst_run_len] for s in plan.dst_starts]
        if plan.dst_prefix:
            parts.append(x[:, :plan.dst_prefix])
        return torch.cat(parts, dim=1)
    out = _take(x, plan.merge_gather)
    if mode == "replace":
        return out
    if plan.src_idx is None:
        raise ValueError("mean-mode merging needs sorted indices: build the "
                         "plan with keep_sorted_indices=True")
    U = plan.unm_num
    src_vals = _take(x, plan.a_idx.gather(1, plan.src_idx))
    idx = U + plan.dst_idx
    acc = out.scatter_add(1, idx[..., None].expand_as(src_vals), src_vals)
    counts = torch.ones(out.shape[:2], dtype=x.dtype, device=x.device)
    counts = counts.scatter_add(1, idx, torch.ones_like(idx, dtype=x.dtype))
    return acc / counts[..., None]


def unmerge(y: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Invert a merge: [B, U + D, C] -> [B, N, C]; merged src positions read
    their matched dst token (reference merge.py:135-155)."""
    with span("merge_apply"):
        return _take(y, plan.unmerge_gather)


def unmerge_all(y: torch.Tensor, plans: Sequence[MergePlan]) -> torch.Tensor:
    """:func:`unmerge` through ``plans``, the last first, in one span."""
    with span("merge_apply"):
        for plan in reversed(plans):
            y = _take(y, plan.unmerge_gather)
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
                   keep_sorted_indices: bool = False,
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

    with span("merge_plan", lambda: f"tokens={N}"):
        dev = metric.device
        tok = torch.arange(tnum, device=dev)
        a_idx = (unm_pre + torch.tensor(src_frames, device=dev)[:, None]
                 * tnum + tok).reshape(-1)
        b_idx = torch.cat([
            (unm_pre + torch.tensor(dst_frames, device=dev)[:, None] * tnum
             + tok).reshape(-1),
            torch.arange(unm_pre, device=dev)])

        S = len(src_frames) * tnum
        r = min(S, int(S * ratio))
        r = quantize_r(S, r, b_idx.shape[0], len_quantum)
        return _build_plan(metric, a_idx.expand(B, S),
                           b_idx.expand(B, b_idx.shape[0]), r, align_batch,
                           keep_sorted_indices=keep_sorted_indices,
                           dst_starts=[unm_pre + f * tnum
                                       for f in dst_frames],
                           dst_run_len=tnum, dst_prefix=unm_pre)


def compute_local_merge(tokens: torch.Tensor, F: int, ratio: float,
                        draws: Sequence[int], target_stride: int = 4,
                        align_batch: bool = False, mode: str = "replace",
                        len_quantum: int | None = None):
    """Merge F joined frames down to one set, one round per entry of
    :func:`local_merge_rounds` with ``draws[i]`` as round i's dst frame
    (reference patch.py:44-56), each round's tokens merged by ``mode``.
    Returns (merged_tokens, plans); undo with :func:`unmerge_all`."""
    plans: list[MergePlan] = []
    unm = 0
    for draw, curF in zip(draws, local_merge_rounds(F, target_stride)):
        plan = local_matching(tokens, curF, ratio, unm, int(draw),
                              target_stride=target_stride,
                              align_batch=align_batch,
                              keep_sorted_indices=mode != "replace",
                              len_quantum=len_quantum)
        if plan is None:
            break
        tokens = merge(tokens, plan, mode)
        unm += plan.unm_num
        plans.append(plan)
    return tokens, plans


# ---------------------------------------------------------------------------
# Global (inter-chunk, vs token bank) matching — reference merge.py:343-463.
# ---------------------------------------------------------------------------


def two_set_matching(metric: torch.Tensor, src_len: int, ratio: float,
                     align_batch: bool = False,
                     keep_sorted_indices: bool = False,
                     len_quantum: int | None = None) -> MergePlan | None:
    """Match the first ``src_len`` tokens (src) against the rest (dst).
    Unmerging restores the whole concatenated sequence; :func:`partition`
    takes the half wanted."""
    B, N, _ = metric.shape
    if ratio <= 0:
        return None
    S, D = src_len, N - src_len
    r = min(S, int(S * ratio))
    r = quantize_r(S, r, D, len_quantum)
    dev = metric.device
    with span("merge_plan", lambda: f"tokens={N}"):
        return _build_plan(metric, torch.arange(S, device=dev).expand(B, S),
                           (S + torch.arange(D, device=dev)).expand(B, D),
                           r, align_batch,
                           keep_sorted_indices=keep_sorted_indices,
                           dst_starts=[S], dst_run_len=D)


def partition(x_full: torch.Tensor, src_len: int, chunk) -> torch.Tensor:
    """Partition 0 (``[:src_len]``) or 1 (``[src_len:]``) of an unmerged
    two-set sequence.  ``chunk`` is an int, or a 0-d tensor when both
    partitions have ``src_len`` tokens.  An int selector takes a view
    (no device work, no span)."""
    if not isinstance(chunk, torch.Tensor):
        return x_full[:, :src_len] if chunk == 0 else x_full[:, src_len:]
    if x_full.shape[1] != 2 * src_len:
        raise ValueError("a tensor selector needs equal-size partitions")
    with span("merge_apply"):
        return torch.where(chunk == 0, x_full[:, :src_len],
                           x_full[:, src_len:])


# ---------------------------------------------------------------------------
# ToMeSD's spatial matching -- reference merge.py:467-579
# (bipartite_soft_matching_random2d, for image-mode merging; the video
# pipeline does not call it).
# ---------------------------------------------------------------------------


def spatial_matching_2d(metric: torch.Tensor, w: int, h: int, sx: int,
                        sy: int, r: int, rand: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        no_rand: bool = False,
                        keep_sorted_indices: bool = False
                        ) -> MergePlan | None:
    """Single-image matching: one dst token in every (sy, sx) window, the
    rest src; the r most similar src tokens merge.

    ``metric``: [B, h*w, C] in row-major spatial order, with sy | h and
    sx | w.  The dst position inside each window, [h/sy, w/sx] ints in
    [0, sy*sx), is ``rand`` if given, else drawn from ``generator``; with
    ``no_rand`` (or neither) every window takes its corner."""
    B, N, _ = metric.shape
    if N != h * w or h % sy or w % sx:
        raise ValueError(f"spatial matching needs N = h*w with sy | h and "
                         f"sx | w (N={N}, h={h}, w={w}, sy={sy}, sx={sx})")
    if r <= 0:
        return None
    hsy, wsx = h // sy, w // sx
    num_dst = hsy * wsx
    dev = metric.device
    if no_rand or (rand is None and generator is None):
        rand = torch.zeros(hsy, wsx, dtype=torch.long)
    elif rand is None:
        rand = torch.randint(0, sy * sx, (hsy, wsx), generator=generator)
    with span("merge_plan", lambda: f"tokens={N}"):
        rand = torch.as_tensor(rand, dtype=torch.long, device=dev)
        wy, wx = torch.meshgrid(torch.arange(hsy, device=dev),
                                torch.arange(wsx, device=dev), indexing="ij")
        b_idx = ((wy * sy + rand // sx) * w + wx * sx
                 + rand % sx).reshape(-1)
        # src = every other token, in order (stable sort of the dst mask)
        is_dst = torch.zeros(N, dtype=torch.long, device=dev)
        is_dst[b_idx] = 1
        a_idx = torch.sort(is_dst, stable=True).indices[:N - num_dst]
        r = min(r, N - num_dst)
        return _build_plan(metric, a_idx.expand(B, N - num_dst),
                           b_idx.expand(B, num_dst), r, align_batch=False,
                           keep_sorted_indices=keep_sorted_indices)


def join_frames(x: torch.Tensor, F: int) -> torch.Tensor:
    """(B*F, N, C) -> (B, F*N, C)."""
    BF, N, C = x.shape
    return x.reshape(BF // F, F * N, C)


def split_frames(x: torch.Tensor, F: int) -> torch.Tensor:
    """(B, F*N, C) -> (B*F, N, C)."""
    B, FN, C = x.shape
    return x.reshape(B * F, FN // F, C)
