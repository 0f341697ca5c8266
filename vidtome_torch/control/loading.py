"""Checkpoints and running conditions of the model-backed control
preprocessors (HED softedge, Anime2Sketch lineart, the OpenPose body net).

Counterpart of ``vidtome_tpu/control/loading.py``: a ``.pth`` / ``.pt`` /
``.bin`` checkpoint loads through ``torch.load(weights_only=True)``, a
``.safetensors`` one through the port's own reader.  The nets run in fp32
with TF32 off (:func:`exact_fp32`): the JAX package runs them in fp32 on the
CPU, and TF32 convolutions would move HED's ``safe_step`` bands and the
pose net's peaks across their thresholds.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch
from torch import nn

from vidtome_torch.io.safetensors import load_file


def model_path(env: str) -> str | None:
    """The checkpoint named by the variable ``env``, None when it is unset
    or empty.  A set variable whose path does not exist fails here, naming
    the variable: it never falls back to another preprocessor."""
    path = os.environ.get(env)
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"{env}={path}: no such file or directory")
    return path


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """torch/safetensors state dict from a file or a directory containing
    one (first matching checkpoint file wins), on the CPU."""
    if os.path.isdir(path):
        for fn in sorted(os.listdir(path)):
            if fn.endswith((".pth", ".pt", ".bin", ".safetensors")):
                path = os.path.join(path, fn)
                break
        else:
            raise FileNotFoundError(f"no checkpoint file under {path}")
    if path.endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN convolutions and matmuls inside the block; the
    flags are restored on exit."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


_models: dict[tuple, nn.Module] = {}


def cached_model(kind: str, path: str, device,
                 build: Callable[[dict], nn.Module]) -> nn.Module:
    """The fp32 eval-mode net ``build(state dict)`` of checkpoint ``path``
    on ``device``, built once per (kind, path, device)."""
    device = torch.device(device)
    key = (kind, os.path.abspath(path), str(device))
    if key not in _models:
        _models[key] = build(load_state_dict(path)).float().eval().to(device)
    return _models[key]
