"""Chunk scheduling for the generation sampler.

Numpy-only counterpart of ``vidtome_tpu/core/chunk.py`` (the port does not
import the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_chunk_modes.py`` pin identical tables for the same
``np.random.Generator``.

Every chunk is exactly ``chunk_size`` slots.  In rotate mode (the default)
chunk boundaries move from one timestep to the next by a random cyclic
rotation of the frame axis (plus an optional flip); the video is padded
once to a chunk multiple by repeating the last frame.  In ragged mode
(``chunk_boundaries: ragged``) the first chunk's length is random and the
frame axis never wraps: a short chunk repeats its last frame on the gather
side and writes those slots to a waste slot past the real frames.  Either
way the chunks are processed in a per-timestep order ('seq' / 'rand' /
'mix') that decorrelates the global token bank (reference:
generate.py:172-203 in lixirui142/VidToMe).
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


def fidx_pair(fidx: np.ndarray) -> np.ndarray:
    """[..., cs] frame indices -> [..., cs, 2] (gather, scatter) pairs with
    gather == scatter (the rotate-mode layout)."""
    return np.stack([fidx, fidx], axis=-1)


def ragged_fidx(
    n_frames: int,
    chunk_size: int,
    rng: np.random.Generator,
    chunk_ord: str = "mix",
    perm_div: float = 3.0,
    merge_global: bool = True,
    waste_slot: int | None = None,
) -> np.ndarray:
    """One timestep of ragged chunk boundaries: [K, chunk_size, 2]
    (gather, scatter) in processing order, K = 1 + ceil((n_frames - 1) /
    chunk_size).

    The first chunk's length r is drawn from [1, chunk_size], redrawn until
    the layout has exactly K chunks; the chunks never wrap past the last
    frame, and the flip reverses the chunk list (frames stay in order
    within a chunk).  A chunk of L < chunk_size frames repeats its last
    frame into its unused gather slots and sends those slots' writes to
    ``waste_slot`` (default ``n_frames``), so no real frame is written
    twice.  The draws are the JAX package's, in its order: the redraws of
    r, the flip, then the chunk order."""
    cs = chunk_size
    if waste_slot is None:
        waste_slot = n_frames
    K = 1 + int(np.ceil(max(n_frames - 1, 1) / cs))
    while True:
        r = int(rng.integers(0, cs)) + 1
        k_r = 1 + (0 if n_frames <= r else int(np.ceil((n_frames - r) / cs)))
        if k_r == K:
            break
    idx = np.arange(n_frames)
    chunks = [idx[:r]] + [idx[i: i + cs] for i in range(r, n_frames, cs)]
    if rng.random() > 0.5:
        chunks = chunks[::-1]
    perm = _chunk_perm(len(chunks), chunk_ord, perm_div, merge_global, rng)
    chunks = [chunks[int(i)] for i in perm]

    out = np.empty((K, cs, 2), np.int64)
    for c, f in enumerate(chunks):
        pad = cs - len(f)
        out[c, :, 0] = np.concatenate([f, np.full(pad, f[-1])])
        out[c, :, 1] = np.concatenate([f, np.full(pad, waste_slot)])
    return out


def build_fidx_table(
    n_padded: int,
    chunk_size: int,
    rng: np.random.Generator,
    steps: int,
    chunk_ord: str = "mix",
    perm_div: float = 3.0,
    merge_global: bool = True,
    ragged: bool = False,
    n_frames: int | None = None,
) -> np.ndarray:
    """Per-timestep chunk schedules: [steps, K, chunk_size, 2] int32
    (gather, scatter) frame indices in processing order.  Rotate mode (the
    default): K = n_padded / chunk_size and the two columns are equal.
    ``ragged``: :func:`ragged_fidx` over the ``n_frames`` real frames, the
    duplicate slots' writes to slot ``n_frames``; K may exceed
    n_padded / chunk_size."""
    tables = []
    if ragged:
        if n_frames is None:
            raise ValueError("ragged chunk boundaries need n_frames")
        for _ in range(steps):
            tables.append(ragged_fidx(
                n_frames, chunk_size, rng, chunk_ord=chunk_ord,
                perm_div=perm_div, merge_global=merge_global,
                waste_slot=n_frames))
        return np.stack(tables).astype(np.int32)
    assert n_padded % chunk_size == 0
    n_chunks = n_padded // chunk_size
    for _ in range(steps):
        offset = int(rng.integers(0, chunk_size))
        order = (np.arange(n_padded) + offset) % n_padded
        if rng.random() > 0.5:
            order = order[::-1].copy()
        perm = _chunk_perm(n_chunks, chunk_ord, perm_div, merge_global, rng)
        tables.append(fidx_pair(np.stack(
            [order[c * chunk_size:(c + 1) * chunk_size] for c in perm])))
    return np.stack(tables).astype(np.int32)


def parse_chunk_ord(chunk_ord: str) -> tuple[str, float]:
    """'mix-4' -> ('mix', 4.0); 'seq'/'rand' pass through
    (reference generate.py:86-89)."""
    if chunk_ord.startswith("mix"):
        div = float(chunk_ord.split("-")[-1]) if "-" in chunk_ord else 3.0
        return "mix", div
    return chunk_ord, 3.0
