"""Seeding (counterpart of ``vidtome_tpu/utils.py``, reference
utils/utils.py:70-74)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed ``random``, numpy and torch's global generators, and return a
    ``torch.Generator`` seeded with ``seed``.  The port's own randomness
    (merge draws, random weights) flows from explicit generators, so no
    result depends on the global state set here."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
