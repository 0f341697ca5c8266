"""The edits a run sends: clips and prompts from the run's seed.

One general generator reads a traffic mix's parameters
(``benchmark/traffic/<mix>.json``):

* ``frames``, and the model configuration's ``height`` and ``width``: the
  clip's shape, the same for every edit of every seed;
* ``clip``: a smooth random scene (normals on a ``grid`` x ``grid`` lattice,
  bilinearly upsampled, through a sigmoid) seen by a camera that pans
  ``pan_px`` pixels a frame in a direction drawn per edit, plus
  ``noise`` of fresh pixel noise a frame, so neighbouring frames share most
  of their tokens, as video does;
* ``words`` and the ``source`` / ``edit`` templates: the inversion prompt
  and the edit prompt, words drawn per edit.

Edit ``k`` of seed ``s`` is the same on every run; the clip is made on the
run's device with a ``torch.Generator`` there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def edit_seed(seed: int, k: int) -> int:
    return (int(seed) * 1009 + k) % (2 ** 62)


def clip(traffic: dict, height: int, width: int, seed: int, k: int,
         device) -> torch.Tensor:
    """Frames [T, H, W, 3] in [0, 1], float32, of edit ``k``."""
    p = traffic["clip"]
    T, pan = int(traffic["frames"]), int(p["pan_px"])
    gen = torch.Generator(device=device).manual_seed(edit_seed(seed, k))
    margin = pan * T
    H, W = height + margin, width + margin
    lattice = torch.randn(1, 3, p["grid"], p["grid"], generator=gen,
                          device=device)
    scene = F.interpolate(lattice, size=(H, W), mode="bilinear",
                          align_corners=False)[0]
    angle = float(torch.rand((), generator=gen, device=device)) * 2 * np.pi
    dy, dx = np.sin(angle), np.cos(angle)
    y0 = x0 = margin // 2
    frames = []
    for t in range(T):
        oy = int(round(y0 + dy * pan * (t - T / 2)))
        ox = int(round(x0 + dx * pan * (t - T / 2)))
        oy, ox = min(max(oy, 0), margin), min(max(ox, 0), margin)
        frames.append(scene[:, oy:oy + height, ox:ox + width])
    x = torch.stack(frames)
    x = x + p["noise"] * torch.randn(x.shape, generator=gen, device=device)
    return torch.sigmoid(2.0 * x).permute(0, 2, 3, 1).contiguous()


def prompts(traffic: dict, seed: int, k: int) -> tuple[str, str]:
    """(inversion prompt, edit prompt) of edit ``k``."""
    rng = np.random.default_rng(edit_seed(seed, k))
    pick = {key: words[int(rng.integers(len(words)))]
            for key, words in sorted(traffic["words"].items())}
    return (traffic["source"].format(**pick), traffic["edit"].format(**pick))
