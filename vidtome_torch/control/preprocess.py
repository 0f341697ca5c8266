"""Control-image preprocessors (reference utils/controlnet_utils.py:28-99).

Counterpart of ``vidtome_tpu/control/preprocess.py`` (numpy + cv2, run on
the host once per clip; the pipelines cache the results on disk):

  canny          cv2.Canny edges
  tile           down/up resample blur
  ip2p           identity
  depth          3-channel depth via control/depth.py (DPT from a local
                 VIDTOME_DEPTH_MODEL directory, else the warned proxy)
  softedge       controlnet_aux if importable, else a Sobel-magnitude
                 fallback (warned)
  lineart_anime  controlnet_aux if importable, else inverted Sobel edges
                 (warned)

The model-backed preprocessors of the JAX package (HED for softedge, the
Anime2Sketch lineart net, the pose net) are not ported: where
``VIDTOME_HED_MODEL`` or ``VIDTOME_LINEART_MODEL`` is set, the JAX package
would run that model, so the port refuses rather than give another image;
``openpose`` is refused always.
"""

from __future__ import annotations

import os

import numpy as np

# preprocessors whose model the JAX package runs when this variable is set
_MODEL_ENV = {"softedge": "VIDTOME_HED_MODEL",
              "lineart_anime": "VIDTOME_LINEART_MODEL"}


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def canny_preprocess(images: np.ndarray, low: int = 100, high: int = 200,
                     **_) -> np.ndarray:
    import cv2

    out = []
    for img in images:
        edges = cv2.Canny(_to_uint8(img), low, high)
        out.append(np.stack([edges] * 3, -1).astype(np.float32) / 255.0)
    return np.stack(out)


def tile_preprocess(images: np.ndarray, resample_rate: float = 1.0,
                    **_) -> np.ndarray:
    import cv2

    out = []
    for img in images:
        h, w = img.shape[:2]
        dh, dw = max(1, int(h * resample_rate)), max(1, int(w * resample_rate))
        small = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        out.append(cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST))
    return np.stack(out).astype(np.float32)


def ip2p_preprocess(images: np.ndarray, **_) -> np.ndarray:
    return np.asarray(images, np.float32)


def depth_preprocess(images: np.ndarray, **_) -> np.ndarray:
    from vidtome_torch.control.depth import depth_to_control_image

    return depth_to_control_image(images)


def _sobel_edges(img: np.ndarray) -> np.ndarray:
    import cv2

    gray = cv2.cvtColor(_to_uint8(img), cv2.COLOR_RGB2GRAY)
    gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3)
    mag = np.sqrt(gx ** 2 + gy ** 2)
    mag = mag / max(mag.max(), 1e-8)
    return cv2.GaussianBlur(mag, (0, 0), sigmaX=2)


_aux_warned: set[str] = set()


def _try_aux(processor_id: str, images: np.ndarray) -> np.ndarray | None:
    try:
        import cv2
        from controlnet_aux.processor import Processor
    except ImportError:
        return None
    proc = Processor(processor_id, {"output_type": "numpy"})
    out = []
    H, W = images.shape[1:3]
    for img in images:
        res = proc(_to_uint8(img))
        res = cv2.resize(res, (W, H), interpolation=cv2.INTER_LINEAR)
        out.append(res.astype(np.float32) / 255.0)
    return np.stack(out)


def validate_control_available(control_type: str) -> None:
    """Fail at construction, before minutes of inversion, for a control
    whose preprocessor the port cannot run: openpose, and softedge /
    lineart_anime with their model variable set."""
    if control_type == "openpose":
        raise NotImplementedError("control: openpose is not ported to "
                                  "vidtome_torch yet (ROADMAP.md, queue 1)")
    env = _MODEL_ENV.get(control_type)
    if env and os.environ.get(env):
        raise NotImplementedError(
            f"{env} is set: the {control_type} model preprocessor is not "
            f"ported to vidtome_torch yet (ROADMAP.md, queue 1); unset it "
            f"to run the Sobel fallback")


def softedge_preprocess(images: np.ndarray, proc: str = "pidsafe",
                        **_) -> np.ndarray:
    validate_control_available("softedge")
    aux = _try_aux(f"softedge_{proc}", images)
    if aux is not None:
        return aux
    if "softedge" not in _aux_warned:
        print("[WARNING] no HED checkpoint (set VIDTOME_HED_MODEL) and no "
              "controlnet_aux — softedge falls back to Sobel magnitude "
              "(approximate)")
        _aux_warned.add("softedge")
    return np.stack([np.stack([_sobel_edges(i)] * 3, -1) for i in images])


def lineart_anime_preprocess(images: np.ndarray, proc: str = "anime",
                             **_) -> np.ndarray:
    validate_control_available("lineart_anime")
    aux = _try_aux(f"lineart_{proc}", images)
    if aux is not None:
        return aux
    if "lineart" not in _aux_warned:
        print("[WARNING] no lineart checkpoint (set VIDTOME_LINEART_MODEL) "
              "and no controlnet_aux — lineart falls back to inverted "
              "edges (approximate)")
        _aux_warned.add("lineart")
    return np.stack([
        np.stack([1.0 - _sobel_edges(i)] * 3, -1) for i in images])


def openpose_preprocess(images: np.ndarray, **_) -> np.ndarray:
    validate_control_available("openpose")  # raises: no pose model ported


PREPROCESS_DICT = {
    "tile": tile_preprocess,
    "ip2p": ip2p_preprocess,
    "openpose": openpose_preprocess,
    "softedge": softedge_preprocess,
    "depth": depth_preprocess,
    "lineart_anime": lineart_anime_preprocess,
    "canny": canny_preprocess,
}


def control_preprocess(images: np.ndarray, control_type: str,
                       **kwargs) -> np.ndarray:
    """[T, H, W, 3] in [0,1] -> control images [T, H, W, 3] in [0,1]."""
    if control_type not in PREPROCESS_DICT:
        raise KeyError(f"unknown control type {control_type!r}; "
                       f"choices: {sorted(PREPROCESS_DICT)}")
    return PREPROCESS_DICT[control_type](np.asarray(images), **kwargs)
