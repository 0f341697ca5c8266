"""Token-merging configuration, per-call state and the draw source.

Counterpart of ``vidtome_tpu/models/tome.py``.  :class:`ToMeConfig` is a
static attribute of the UNet; :class:`ToMeCall` carries one UNet call's
random draws, bank mode, the global token banks and the ``share_match``
plan cache.  The JAX package derives the draws inside the call from a PRNG
key; here they come from a :class:`DrawSource` table, which production fills
from a seeded ``torch.Generator`` and the parity tests fill with the values
the JAX key chain produces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vidtome_torch.core.merge import (local_merge_rounds, quantize_r,
                                      round_stride)


@dataclasses.dataclass(frozen=True)
class ToMeConfig:
    """Static token-merging configuration (reference: patch.py apply_patch
    args)."""

    frames: int                      # frames per chunk joined for merging
    local_merge_ratio: float = 0.9
    merge_global: bool = False
    global_merge_ratio: float = 0.8
    global_rand: float = 0.5         # the bank plays src when coin <= this
    max_downsample: int = 2          # merge only at downsample <= this
    target_stride: int = 4
    align_batch: bool = False
    merge_mode: str = "replace"      # "replace" or "mean" (core/merge.merge)
    collect_stats: bool = False      # each merging block records its
                                     # token counts in ToMeCall.stats
    share_match: bool = False        # one matching per resolution level
    merge_crossattn: bool = False    # cross-attention on the locally
                                     # merged tokens too (the reference's
                                     # LDM-path block, patch.py:104-114)
    merge_ff: bool = False           # the feed-forward likewise
    len_quantum: int | None = 1024   # see core/merge.quantize_r

    def rounds(self) -> list[int]:
        """Frame count at the start of each local merge round."""
        return local_merge_rounds(self.frames, self.target_stride)

    def merged_local_len(self, tokens_per_frame: int) -> int:
        """Length of the locally-merged sequence for one chunk."""
        unm = 0
        cur_tokens = self.frames * tokens_per_frame
        for curF in self.rounds():
            n_dst = curF // round_stride(curF, self.target_stride)
            tnum = (cur_tokens - unm) // curF
            S = (curF - n_dst) * tnum
            r = min(S, int(S * self.local_merge_ratio))
            r = quantize_r(S, r, n_dst * tnum + unm, self.len_quantum)
            cur_tokens = (S - r) + n_dst * tnum + unm
            unm += S - r
        return cur_tokens


class DrawSource:
    """Random draws of the merge path: ``table[step, chunk]`` holds one
    dst-frame index per local round followed by the global coin in [0, 1).
    Every transformer block of one UNet call uses the same row, as in the
    reference (patch.py:215-231)."""

    def __init__(self, table: np.ndarray):
        self.table = np.asarray(table, np.float64)

    @classmethod
    def from_generator(cls, cfg: ToMeConfig, steps: int, chunks: int,
                       generator: torch.Generator) -> "DrawSource":
        cols = [torch.randint(0, round_stride(f, cfg.target_stride),
                              (steps, chunks), generator=generator)
                for f in cfg.rounds()]
        cols.append(torch.rand(steps, chunks, generator=generator,
                               dtype=torch.float64))
        return cls(torch.stack([c.double() for c in cols], -1).numpy())

    def call(self, cfg: ToMeConfig, step: int, chunk: int, bank_mode: str,
             banks: dict) -> "ToMeCall":
        row = self.table[step, chunk]
        return ToMeCall(cfg=cfg, local_draws=[int(d) for d in row[:-1]],
                        coin=float(row[-1]), bank_mode=bank_mode, banks=banks)


@dataclasses.dataclass
class ToMeCall:
    """Per-UNet-call merging state.

    cfg: the static merging configuration (None: no merging).
    local_draws: dst-frame index of each local round (shared by all blocks).
    coin: the global-merge coin; the chunk's tokens play src when
        ``coin > global_rand``, the bank otherwise.
    bank_mode: 'off' (no global merge), 'init' (first chunk of a timestep:
        each block stores its local tokens as its bank) or 'merge' (merge
        against the bank and replace it).
    banks: block -> bank tensor, carried from chunk to chunk by the caller.
    plan_cache: ``share_match`` plans, keyed by (downsample, tokens, width).
    stats: block -> {"seq_len", "merged_len"}, the tokens of its
        self-attention input before and after merging, summed over the
        batch; written by every merging block under ``cfg.collect_stats``
        (``logging_utils.collect_tome_stats`` names the blocks).
    """

    cfg: ToMeConfig | None
    local_draws: list[int] = dataclasses.field(default_factory=list)
    coin: float = 0.0
    bank_mode: str = "off"
    banks: dict = dataclasses.field(default_factory=dict)
    plan_cache: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.bank_mode not in ("off", "init", "merge"):
            raise ValueError(f"bank_mode {self.bank_mode!r}")
