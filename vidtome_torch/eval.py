"""Frame quality: compare two edited clips frame by frame.

Counterpart of ``vidtome_tpu/eval.py``, in numpy and OpenCV, with frames
read by the port's ``io/video.py``; the same frames give the same numbers.
PSNR, SSIM and temporal warping consistency of two frame directories or
videos:

    python -m vidtome_torch.eval --a out_port/frames --b out_ref/frames

The fidelity bar of the repo is PSNR >= 35 dB against the reference
implementation's frames (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10(max_val ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """SSIM of one frame pair (11x11 Gaussian windows, sigma 1.5), averaged
    over the pixels and then the channels."""
    import cv2

    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def blur(x):
        return cv2.GaussianBlur(x, (11, 11), 1.5)

    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mx, my = blur(x), blur(y)
        vx = blur(x * x) - mx * mx
        vy = blur(y * y) - my * my
        cxy = blur(x * y) - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2))
        vals.append(float(s.mean()))
    return float(np.mean(vals))


def temporal_consistency(frames: np.ndarray) -> float:
    """Mean PSNR of each frame against the next one warped back onto it by
    Farneback optical flow: a proxy for flicker (higher is smoother)."""
    import cv2

    frames8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    vals = []
    for i in range(len(frames) - 1):
        g0 = cv2.cvtColor(frames8[i], cv2.COLOR_RGB2GRAY)
        g1 = cv2.cvtColor(frames8[i + 1], cv2.COLOR_RGB2GRAY)
        flow = cv2.calcOpticalFlowFarneback(g0, g1, None, 0.5, 3, 15, 3, 5,
                                            1.2, 0)
        h, w = g0.shape
        grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1
                        ).astype(np.float32)
        # Farneback: prev(y, x) ~ next(y + fy, x + fx), so the next frame
        # sampled at grid + flow reconstructs the previous one
        remap = grid + flow
        warped_prev = cv2.remap(frames8[i + 1], remap[..., 0],
                                remap[..., 1], cv2.INTER_LINEAR)
        vals.append(psnr(warped_prev / 255.0, frames8[i] / 255.0))
    return float(np.mean(vals)) if vals else float("inf")


def compare(path_a: str, path_b: str, height: int = 512,
            width: int = 512) -> dict:
    """Both clips at height x width, cut to the shorter: per-frame PSNR
    (mean, min), mean SSIM and each clip's temporal consistency."""
    from vidtome_torch.io.video import load_video

    a = load_video(path_a, height, width)
    b = load_video(path_b, height, width)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    per_frame_psnr = [psnr(a[i], b[i]) for i in range(n)]
    return {
        "frames": n,
        "psnr_mean": float(np.mean(per_frame_psnr)),
        "psnr_min": float(np.min(per_frame_psnr)),
        "ssim_mean": float(np.mean([ssim(a[i], b[i]) for i in range(n)])),
        "temporal_consistency_a": temporal_consistency(a),
        "temporal_consistency_b": temporal_consistency(b),
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", required=True, help="frames dir / mp4 (ours)")
    parser.add_argument("--b", required=True, help="frames dir / mp4 (ref)")
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    args = parser.parse_args(argv)
    print(json.dumps(compare(args.a, args.b, args.height, args.width),
                     indent=2))


if __name__ == "__main__":
    main()
