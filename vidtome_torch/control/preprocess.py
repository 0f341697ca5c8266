"""Control-image preprocessors (reference utils/controlnet_utils.py:28-99).

Counterpart of ``vidtome_tpu/control/preprocess.py`` (numpy + cv2 on the
host, plus the control nets on a device; the pipelines cache the results on
disk):

  canny          cv2.Canny edges
  tile           down/up resample blur
  ip2p           identity
  depth          3-channel depth via control/depth.py (DPT from a local
                 VIDTOME_DEPTH_MODEL directory, else the warned proxy)
  softedge       the HED net (control/edge_hed.py, VIDTOME_HED_MODEL) >
                 controlnet_aux if importable > Sobel magnitude (warned)
  lineart_anime  the Anime2Sketch net (control/lineart.py,
                 VIDTOME_LINEART_MODEL) > controlnet_aux > inverted Sobel
                 edges (warned)
  openpose       the OpenPose body net (control/pose.py, VIDTOME_POSE_MODEL)
                 > controlnet_aux; no classical fallback:
                 :func:`validate_control_available` fails at construction,
                 before the expensive stages

The nets run on ``device``: the pipelines pass their bundle's (the card),
tests the CPU.  No net runs on a device chosen by what is found.
"""

from __future__ import annotations

import numpy as np


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


def softedge_preprocess(images: np.ndarray, proc: str = "pidsafe",
                        device="cuda", **_) -> np.ndarray:
    from vidtome_torch.control import edge_hed

    hed = edge_hed.hed_model_path()
    if hed is not None:
        # the HED net (as in the JAX package: the reference's default
        # softedge processor is PiDiNet via controlnet_aux; HED is the
        # classic softedge model and feeds the same ControlNet).  The *safe
        # variants quantize the edge map to coarse steps.
        return edge_hed.hed_edges(images, hed, device,
                                  safe=proc.endswith("safe"))
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
                             device="cuda", **_) -> np.ndarray:
    from vidtome_torch.control import lineart

    model = lineart.lineart_model_path()
    if model is not None:
        return lineart.lineart_edges(images, model, device)
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


def openpose_preprocess(images: np.ndarray, device="cuda",
                        **_) -> np.ndarray:
    from vidtome_torch.control.pose import pose_images, pose_model_path

    path = pose_model_path()
    if path is not None:
        return pose_images(images, path, device)
    aux = _try_aux("openpose", images)
    if aux is None:
        raise RuntimeError(
            "openpose preprocessing needs a pose model: set "
            "VIDTOME_POSE_MODEL to a body_pose_model.pth checkpoint "
            "(control/pose.py) or install controlnet_aux; no cv2 fallback "
            "exists")
    return aux


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


def validate_control_available(control_type: str) -> None:
    """Fail FAST for control types whose preprocessor cannot run, instead
    of raising mid-pipeline after minutes of inversion (the pipelines call
    this at construction).  A model variable that names no file fails
    here (:func:`control.loading.model_path`).  Openpose is hard-gated
    besides: it needs a pose model (VIDTOME_POSE_MODEL or controlnet_aux)
    and has no meaningful classical fallback; the other types always
    produce something (exact or warned-approximate)."""
    from vidtome_torch.control import edge_hed, lineart
    from vidtome_torch.control.pose import pose_model_path

    if control_type == "softedge":
        edge_hed.hed_model_path()
    elif control_type == "lineart_anime":
        lineart.lineart_model_path()
    if control_type != "openpose":
        return
    if pose_model_path() is not None:
        return
    try:
        import controlnet_aux  # noqa: F401
        return
    except ImportError:
        pass
    raise RuntimeError(
        "control: openpose needs a pose model and none is available: set "
        "VIDTOME_POSE_MODEL to a body_pose_model.pth checkpoint "
        "(control/pose.py) or install controlnet_aux.  There is no "
        "classical fallback for pose estimation — choose another control "
        "type (canny/softedge/depth/tile/ip2p/lineart_anime) instead.  "
        "Failing now, before inversion, so no compute is wasted.")
