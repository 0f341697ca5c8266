"""Chunk scheduling for the generation sampler (rotate mode).

Numpy-only counterpart of ``vidtome_tpu/core/chunk.py`` (the port does not
import the JAX package); ``tests/test_torch_core.py`` pins identical tables
for the same ``np.random.Generator``.

Every chunk is exactly ``chunk_size`` frames.  Chunk boundaries move from
one timestep to the next by a random cyclic rotation of the frame axis
(plus an optional flip), and the chunks are processed in a per-timestep
order ('seq' / 'rand' / 'mix') that decorrelates the global token bank
(reference: generate.py:172-203 in lixirui142/VidToMe).  The video is
padded once to a chunk multiple by repeating the last frame.
"""

from __future__ import annotations

import numpy as np


def pad_to_chunks(n_frames: int, chunk_size: int) -> tuple[int, np.ndarray]:
    """Return (padded length, source index per padded frame)."""
    n_padded = -(-n_frames // chunk_size) * chunk_size
    src = np.minimum(np.arange(n_padded), n_frames - 1)
    return n_padded, src


def _mix_order(n: int, perm_div: float, rng: np.random.Generator) -> np.ndarray:
    """Partial permutation: ~n/perm_div chunks in random order first, the
    rest sequential, oriented to continue near the last random chunk
    (reference generate.py:189-199)."""
    randord = rng.permutation(n).tolist()
    rand_len = int(n / perm_div)
    seqord = sorted(randord[rand_len:])
    if rand_len > 0:
        randord = randord[:rand_len]
        if abs(seqord[-1] - randord[-1]) < abs(seqord[0] - randord[-1]):
            seqord = seqord[::-1]
        return np.array(randord + seqord)
    return np.array(seqord)


def _chunk_perm(n_chunks: int, chunk_ord: str, perm_div: float,
                merge_global: bool, rng: np.random.Generator) -> np.ndarray:
    if not merge_global or chunk_ord == "seq" or n_chunks == 1:
        return np.arange(n_chunks)
    if chunk_ord == "rand":
        return rng.permutation(n_chunks)
    if chunk_ord == "mix":
        return _mix_order(n_chunks, perm_div, rng)
    raise ValueError(f"unknown chunk_ord: {chunk_ord}")


def build_fidx_table(
    n_padded: int,
    chunk_size: int,
    rng: np.random.Generator,
    steps: int,
    chunk_ord: str = "mix",
    perm_div: float = 3.0,
    merge_global: bool = True,
) -> np.ndarray:
    """Per-timestep chunk schedules: [steps, K, chunk_size, 2] int32
    (gather, scatter) frame indices in processing order; in rotate mode the
    two columns are equal."""
    assert n_padded % chunk_size == 0
    n_chunks = n_padded // chunk_size
    tables = []
    for _ in range(steps):
        offset = int(rng.integers(0, chunk_size))
        order = (np.arange(n_padded) + offset) % n_padded
        if rng.random() > 0.5:
            order = order[::-1].copy()
        perm = _chunk_perm(n_chunks, chunk_ord, perm_div, merge_global, rng)
        fidx = np.stack([order[c * chunk_size:(c + 1) * chunk_size]
                         for c in perm])
        tables.append(np.stack([fidx, fidx], axis=-1))
    return np.stack(tables).astype(np.int32)


def parse_chunk_ord(chunk_ord: str) -> tuple[str, float]:
    """'mix-4' -> ('mix', 4.0); 'seq'/'rand' pass through
    (reference generate.py:86-89)."""
    if chunk_ord.startswith("mix"):
        div = float(chunk_ord.split("-")[-1]) if "-" in chunk_ord else 3.0
        return "mix", div
    return chunk_ord, 3.0
