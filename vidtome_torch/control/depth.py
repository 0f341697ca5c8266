"""Depth maps for the depth ControlNet (and SD2-depth conditioning).

Counterpart of ``vidtome_tpu/control/depth.py`` (reference
utils/utils.py:186-277):

  * if ``VIDTOME_DEPTH_MODEL`` names a local DPT checkpoint directory,
    transformers runs it on the host (offline preprocessing, cached to disk);
  * otherwise a warned luminance + blur proxy stands in.

Latent depth maps are min-max normalized to [-1, 1] at latent resolution,
as the reference's prepare_depth_map (utils/utils.py:216-272).
"""

from __future__ import annotations

import os

import numpy as np

_dpt_cache: dict[str, object] = {}
_warned = False


def _dpt_model_dir() -> str | None:
    return os.environ.get("VIDTOME_DEPTH_MODEL")


def _compute_dpt(frame: np.ndarray, model_dir: str) -> np.ndarray:
    import torch
    from transformers import AutoImageProcessor, DPTForDepthEstimation

    if model_dir not in _dpt_cache:
        _dpt_cache[model_dir] = (
            AutoImageProcessor.from_pretrained(model_dir),
            DPTForDepthEstimation.from_pretrained(model_dir).eval(),
        )
    proc, model = _dpt_cache[model_dir]
    inputs = proc(images=(frame * 255).astype(np.uint8), return_tensors="pt")
    with torch.no_grad():
        depth = model(**inputs).predicted_depth
    return depth[0].numpy()


def _proxy_depth(frame: np.ndarray) -> np.ndarray:
    """Placeholder depth (no DPT weights): blurred luminance with a
    vertical prior; keeps the pipeline's shapes and flow, not metric
    depth."""
    import cv2

    lum = frame.mean(-1)
    blur = cv2.GaussianBlur(lum, (0, 0), sigmaX=8)
    h = frame.shape[0]
    vertical = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None]
    return blur * 0.5 + vertical * 0.5


def compute_depth(frame: np.ndarray) -> np.ndarray:
    """frame [H, W, 3] in [0,1] -> raw depth [h', w'] (model resolution)."""
    global _warned
    model_dir = _dpt_model_dir()
    if model_dir and os.path.isdir(model_dir):
        return _compute_dpt(frame, model_dir)
    if not _warned:
        print("[WARNING] no DPT checkpoint (set VIDTOME_DEPTH_MODEL) — "
              "using proxy depth (NOT metric; for pipeline testing only)")
        _warned = True
    return _proxy_depth(frame)


def normalize_depth_to_latent(depth: np.ndarray, latent_hw: tuple[int, int]
                              ) -> np.ndarray:
    """Resize to latent resolution (bicubic), then min-max normalize to
    [-1, 1] per frame (reference utils/utils.py:243-260)."""
    import cv2

    d = depth.astype(np.float32)
    # background sentinel (reference: depth == -1 -> min - 10)
    bg = d == -1
    if bg.any():
        d[bg] = d[~bg].min() - 10
    d = cv2.resize(d, (latent_hw[1], latent_hw[0]),
                   interpolation=cv2.INTER_CUBIC)
    dmin, dmax = d.min(), d.max()
    return (2.0 * (d - dmin) / max(dmax - dmin, 1e-8) - 1.0)[..., None]


def prepare_depth_latents(frames: np.ndarray, frame_ids: list[int],
                          work_dir: str) -> np.ndarray:
    """[T, H, W, 3] -> depth maps at latent resolution [T, H/8, W/8, 1] in
    [-1, 1], through the per-frame disk cache."""
    from vidtome_torch.io.artifacts import load_or_compute_depth

    raw = load_or_compute_depth(work_dir, np.asarray(frames), frame_ids,
                                compute_depth)
    latent_hw = (frames.shape[1] // 8, frames.shape[2] // 8)
    return np.stack([normalize_depth_to_latent(d, latent_hw) for d in raw])


def depth_to_control_image(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] -> 3-channel depth image for the depth ControlNet
    (reference utils/controlnet_utils.py:62-75)."""
    import cv2

    out = []
    for f in np.asarray(frames):
        d = compute_depth(f)
        d = (d - d.min()) / max(d.max() - d.min(), 1e-8)
        d = cv2.resize(d, (f.shape[1], f.shape[0]),
                       interpolation=cv2.INTER_LINEAR)
        out.append(np.stack([d, d, d], axis=-1))
    return np.stack(out).astype(np.float32)
