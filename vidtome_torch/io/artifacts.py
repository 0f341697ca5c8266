"""The inverted-latent cache on disk.

Counterpart of the latent half of ``vidtome_tpu/io/artifacts.py``, with the
same layout, so either package reads what the other wrote:

  <latents_path>/<model name>/noisy_latents_<t>.npy   one per saved timestep

The depth and control-image caches of the JAX package belong to the
ControlNet / depth paths, which the port does not run yet.
"""

from __future__ import annotations

import os

import numpy as np


def get_latents_dir(latents_path: str, model_key: str) -> str:
    """The latents of one checkpoint live in a directory named after it."""
    return os.path.join(latents_path,
                        os.path.basename(str(model_key).rstrip("/")))


def latent_path(latents_dir: str, t: int) -> str:
    return os.path.join(latents_dir, f"noisy_latents_{int(t)}.npy")


def save_latent(latents_dir: str, t: int, latent: np.ndarray) -> str:
    os.makedirs(latents_dir, exist_ok=True)
    path = latent_path(latents_dir, t)
    np.save(path, np.asarray(latent))
    return path


def load_latent(latents_dir: str, t: int,
                frame_ids: list[int] | None = None) -> np.ndarray:
    path = latent_path(latents_dir, t)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Latent at timestep {int(t)} not found in "
                                f"{latents_dir}.")
    lat = np.load(path)
    return lat if frame_ids is None else lat[frame_ids]


def check_latents_exist(latents_dir: str, timesteps) -> bool:
    return all(os.path.exists(latent_path(latents_dir, t)) for t in timesteps)
