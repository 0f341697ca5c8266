"""VidToMe's token merging, plainly: bipartite matchings as gather plans.

A "joined" sequence is ``[kept prefix | frame_0 | frame_1 | ...]`` (the
chunk's frames side by side); a local round makes frame ``draw`` of every
stride window dst and the other frames src, and merges the ``r`` src tokens
whose best cosine match is highest into their dst; the merged sequence is
``[kept src | dst frames | previous prefix]``.  A global round matches the
chunk's locally merged tokens against the bank of the step's first chunk.

The rules that make the merged lengths and choices what the edit pipeline
defines (the VidToMe reference's, with the TPU port's length rounding):
the metric is normalised in float32 and rounded to bfloat16 before it is
scored, scores in float32; each src token's best dst is the lowest index
reaching its maximum; the kept set is the ``S - r`` lowest best-scores,
ties by position; under ``align_batch`` one matching serves every row of
the batch, each src token taking its best row's score and dst; and ``r`` is
rounded up (:func:`quantize_r`) so merged lengths land on multiples of the
length quantum.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Plan:
    merge_gather: torch.Tensor    # [B, U + D] positions kept, in order
    unmerge_gather: torch.Tensor  # [B, N] merged position of each token
    unm: int                      # U, the src tokens kept


def _take(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _plan(metric, a_idx, b_idx, r, align_batch):
    B, N, _ = metric.shape
    S, D = a_idx.shape[1], b_idx.shape[1]
    U = S - r
    m = metric.float()
    m = (m / m.norm(dim=-1, keepdim=True).clamp_min(1e-6)).to(torch.bfloat16)
    scores = torch.bmm(_take(m, a_idx).float(),
                       _take(m, b_idx).float().transpose(1, 2))
    best, best_idx = scores.max(dim=-1)  # [B, S]
    if align_batch:
        best, row = best.max(dim=0, keepdim=True)
        best_idx = best_idx.gather(0, row)
    unm_idx = torch.sort(best, dim=-1, stable=True).indices[:, :U]
    if align_batch:
        unm_idx, best_idx = unm_idx.expand(B, U), best_idx.expand(B, S)
    kept = a_idx.gather(1, unm_idx)
    ar = torch.arange(max(U, D), device=metric.device)
    inv = torch.zeros(B, N, dtype=torch.long, device=metric.device)
    inv.scatter_(1, b_idx, (U + ar[:D]).expand(B, D))
    inv.scatter_(1, a_idx, U + best_idx)
    inv.scatter_(1, kept, ar[:U].expand(B, U))
    return Plan(torch.cat([kept, b_idx], dim=1), inv, U)


def merge(x, plan: Plan):
    return _take(x, plan.merge_gather)


def unmerge(y, plan: Plan):
    return _take(y, plan.unmerge_gather)


def unmerge_all(y, plans):
    for p in reversed(plans):
        y = unmerge(y, p)
    return y


def quantize_r(S, r, D, quantum, min_len=1024):
    """``r`` rounded up so the merged length ``S - r + D`` is a multiple of
    the quantum (``quantum // 4``, at least 256, below ``4 * quantum``);
    never for merged lengths under ``min_len``, and never dropping more
    than half the kept set."""
    if not quantum:
        return r
    U = S - r
    L = U + D
    if L < min_len:
        return r
    q = quantum if L >= 4 * quantum else max(quantum // 4, 256)
    slack = L % q
    if slack == 0 or U - slack < 0 or (U - slack) * 2 < U:
        return r
    return r + slack


def round_stride(F, target):
    """The largest divisor of F that is at most ``target``, or F itself
    when no divisor of 2 or more fits."""
    for d in range(min(F, max(1, target)), 0, -1):
        if F % d == 0:
            return d if d >= 2 else F
    return F


def local_rounds(F, target):
    """Frame counts at the start of each local round."""
    out, cur = [], F
    while cur > 1:
        out.append(cur)
        cur //= round_stride(cur, target)
    return out


def local_merge(tokens, F, ratio, draws, target, align_batch, quantum):
    """Merge F joined frames down, one round a draw; returns (merged,
    plans)."""
    plans, pre = [], 0
    for draw, cur in zip(draws, local_rounds(F, target)):
        if ratio <= 0:
            break
        B, N, _ = tokens.shape
        tnum = (N - pre) // cur
        stride = round_stride(cur, target)
        dst = [f for f in range(cur) if f % stride == draw]
        src = [f for f in range(cur) if f % stride != draw]
        dev = tokens.device
        tok = torch.arange(tnum, device=dev)
        a_idx = (pre + torch.tensor(src, device=dev)[:, None] * tnum
                 + tok).reshape(-1)
        b_idx = torch.cat([(pre + torch.tensor(dst, device=dev)[:, None]
                            * tnum + tok).reshape(-1),
                           torch.arange(pre, device=dev)])
        S = a_idx.numel()
        r = quantize_r(S, min(S, int(S * ratio)), b_idx.numel(), quantum)
        plan = _plan(tokens, a_idx.expand(B, -1), b_idx.expand(B, -1), r,
                     align_batch)
        tokens = merge(tokens, plan)
        pre += plan.unm
        plans.append(plan)
    return tokens, plans


def two_set_matching(tokens, src_len, ratio, align_batch, quantum):
    """The first ``src_len`` tokens (src) against the rest (dst)."""
    B, N, _ = tokens.shape
    S, D = src_len, N - src_len
    r = quantize_r(S, min(S, int(S * ratio)), D, quantum)
    dev = tokens.device
    return _plan(tokens, torch.arange(S, device=dev).expand(B, S),
                 (S + torch.arange(D, device=dev)).expand(B, D), r,
                 align_batch)


def partition(x, src_len, side):
    return x[:, :src_len] if side == 0 else x[:, src_len:]


def join_frames(x, F):
    BF, N, C = x.shape
    return x.reshape(BF // F, F * N, C)


def split_frames(x, F):
    B, FN, C = x.shape
    return x.reshape(B * F, FN // F, C)
