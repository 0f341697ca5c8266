"""A cell at test size: the tiny SD stack on 8 frames of 64x64, the
traffic keys of a benchmark mix.  The CPU tests drive the harness with it."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

MODEL = {
    "name": "tiny", "sd_version": "1.5", "height": 64, "width": 64,
    "dtype": "bf16",
    "unet": {"in_channels": 4, "out_channels": 4,
             "block_out_channels": [32, 64], "layers_per_block": 1,
             "cross_attention_dim": 32, "num_heads": 2, "head_dim": None,
             "use_linear_projection": False,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]},
    "vae": {"block_out_channels": [8, 8, 8, 8], "layers_per_block": 1,
            "latent_channels": 4, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 1000, "hidden_size": 32, "num_layers": 2,
                     "num_heads": 2, "intermediate_size": 64,
                     "max_positions": 16, "hidden_act": "quick_gelu",
                     "layer_norm_eps": 1e-5},
}


def model(linear: bool = False) -> dict:
    m = copy.deepcopy(MODEL)
    if linear:  # the SD2.x form: heads of a fixed width, dense projections
        m["unet"].update(num_heads=None, head_dim=16,
                         use_linear_projection=True)
    return m


def traffic(mix: str, steps: int = 8) -> dict:
    """A benchmark mix cut to 8 frames and ``steps`` steps a stage."""
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    t.update(frames=8, max_edits=2, check_frames=3, check_steps=2)
    t["clip"]["grid"] = 4
    cfg = t["config"]
    cfg["inversion"].update(steps=steps, save_steps=steps, n_frames=8,
                            batch_size=8)
    cfg["generation"]["n_timesteps"] = steps
    return t
