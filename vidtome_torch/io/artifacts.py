"""Artifact caches on disk: inverted latents, depth maps, control images.

Counterpart of ``vidtome_tpu/io/artifacts.py``, with the same layout, so
either package reads what the other wrote:

  <latents_path>/<model name>/noisy_latents_<t>.npy   one per saved timestep
  <work_dir>/depth/<frame:04>.npy (+ .png preview)
  <work_dir>/<control>_image/<frame:04>.png
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


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


def depth_cache_dir(work_dir: str) -> str:
    return os.path.join(work_dir, "depth")


def load_or_compute_depth(work_dir: str, frames: np.ndarray,
                          frame_ids: list[int], compute_fn) -> np.ndarray:
    """Per-frame depth maps through the disk cache (reference
    utils/utils.py:186-213).  ``compute_fn(frame[H,W,3]) -> [h,w]``."""
    ddir = depth_cache_dir(work_dir)
    os.makedirs(ddir, exist_ok=True)
    out = []
    for frame, fid in zip(frames, frame_ids):
        path = os.path.join(ddir, f"{fid:04}.npy")
        if os.path.exists(path):
            depth = np.load(path)
        else:
            depth = np.asarray(compute_fn(frame), dtype=np.float32)
            np.save(path, depth)
            preview = ((depth - depth.min())
                       / max(depth.max() - depth.min(), 1e-8) * 255)
            Image.fromarray(preview.astype(np.uint8)).save(
                path.replace(".npy", ".png"))
        out.append(depth)
    return np.stack(out)


def control_image_dir(work_dir: str, control: str) -> str:
    return os.path.join(work_dir, f"{control}_image")


def load_or_compute_control(work_dir: str, control: str, frames: np.ndarray,
                            frame_ids: list[int], compute_fn) -> np.ndarray:
    """Control images through the png cache (reference
    utils/utils.py:312-343): read back when every frame's png exists, else
    ``compute_fn(frames[T,H,W,3]) -> [T,H,W,3]`` in [0,1], written out and
    returned as computed."""
    cdir = control_image_dir(work_dir, control)
    paths = [os.path.join(cdir, f"{fid:04}.png") for fid in frame_ids]
    if os.path.exists(cdir) and all(os.path.exists(p) for p in paths):
        print(f"[INFO] load control image from {cdir}.")
        return np.concatenate([
            np.asarray(Image.open(p).convert("RGB"), np.float32)[None] / 255.0
            for p in paths])
    print("[INFO] preprocessing control images...")
    images = np.asarray(compute_fn(frames))
    os.makedirs(cdir, exist_ok=True)
    for img, p in zip(images, paths):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(p)
    return images
