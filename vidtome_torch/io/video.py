"""Video and frame I/O.

Counterpart of ``vidtome_tpu/io/video.py``: mp4 / mov / avi through OpenCV,
gif through PIL, frame folders by glob; frames resized so the short side
covers the target, then centre-cropped to it (both floored to multiples of
64); mp4 and png out.  Arrays are float32 [T, H, W, 3] in [0, 1], channels
last as everywhere in the port.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image

FRAME_EXT = (".jpg", ".png", ".jpeg")


def load_image(path: str) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32)[None] / 255.0


def glob_frame_paths(dir_path: str) -> list[str]:
    paths: list[str] = []
    for ext in FRAME_EXT:
        paths += glob(os.path.join(dir_path, f"*{ext}"))
    return sorted(paths)


def _resize(frames: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    out = []
    for f in frames:
        img = Image.fromarray((f * 255).astype(np.uint8))
        img = img.resize((size[1], size[0]), Image.BILINEAR)
        out.append(np.asarray(img, dtype=np.float32) / 255.0)
    return np.stack(out)


def process_frames(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize keeping the aspect so the frame covers (h, w), then
    centre-crop to (h, w), both floored to multiples of 64."""
    fh, fw = frames.shape[1:3]
    h, w = (h // 64) * 64, (w // 64) * 64
    nw = int(fw / fh * h)
    size = (h, nw) if nw >= w else (int(fh / fw * w), w)
    frames = _resize(frames, size)
    top, left = (size[0] - h) // 2, (size[1] - w) // 2
    return frames[:, top: top + h, left: left + w]


def _decode(path: str) -> np.ndarray:
    """All frames of a video file, a gif or a frame folder, [0, 1]."""
    if path.endswith((".mp4", ".mov", ".avi")):
        import cv2

        cap = cv2.VideoCapture(path)
        frame_ls = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame_ls.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frame_ls:
            raise FileNotFoundError(f"could not decode video: {path}")
        return np.stack(frame_ls).astype(np.float32) / 255.0
    if path.endswith(".gif"):
        from PIL import ImageSequence

        return np.stack([np.asarray(f.convert("RGB"), dtype=np.float32) / 255.0
                         for f in ImageSequence.Iterator(Image.open(path))])
    paths = glob_frame_paths(path)
    if not paths:
        raise FileNotFoundError(f"no frames found at {path}")
    return np.concatenate([load_image(p) for p in paths])


def load_video(path: str, h: int, w: int,
               frame_ids: list[int] | None = None) -> np.ndarray:
    """-> [T, h', w', 3] float32 in [0, 1], h' and w' floored to /64."""
    frames = _decode(path)
    if frame_ids is not None:
        frames = frames[frame_ids]
    print(f"[INFO] loaded video with {len(frames)} frames from: {path}")
    return process_frames(frames, h, w)


def save_frames(frames: np.ndarray, path: str, ext: str = "png",
                frame_ids: list[int] | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    if frame_ids is None:
        frame_ids = list(range(len(frames)))
    for i, frame in zip(frame_ids, frames):
        img = Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8))
        img.save(os.path.join(path, f"{i:04}.{ext}"))


def save_video(frames: np.ndarray, path: str, fps: int = 30,
               frame_ids: list[int] | None = None,
               save_frame: bool = False) -> str:
    """Write ``output.mp4`` under ``path`` (h264 where OpenCV has it, else
    mpeg-4; pngs only if neither opens), and the frames as pngs with
    ``save_frame``; returns the mp4 path."""
    os.makedirs(path, exist_ok=True)
    if frame_ids is None:
        frame_ids = list(range(len(frames)))
    frames = frames[frame_ids]
    out_path = os.path.join(path, "output.mp4")
    data = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    import cv2

    h, w = data.shape[1:3]
    writer = None
    for codec in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*codec),
                                 fps, (w, h))
        if writer.isOpened():
            break
    if writer.isOpened():
        for frame in data:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        print(f"[INFO] save video to {out_path}")
    else:
        print("[WARNING] no usable mp4 codec; saving frames only")
        save_frame = True
    if save_frame:
        save_frames(frames, os.path.join(path, "frames"), frame_ids=frame_ids)
    return out_path
