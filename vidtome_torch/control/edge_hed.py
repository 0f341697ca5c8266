"""Holistically-nested edge detection (HED) for softedge control images.

Counterpart of ``vidtome_tpu/control/edge_hed.py`` (the reference delegates
softedge to ``controlnet_aux``, ``utils/controlnet_utils.py:28-60`` in
lixirui142/VidToMe).  :class:`HEDNetwork` has the module names of the
``ControlNetHED.pth`` checkpoint (lllyasviel's Annotators release), so it
loads with ``strict=True``:

  norm                      (1, 3, 1, 1) input bias, subtracted from the
                            0..255 RGB input
  blockN.convs.i            3x3 conv + ReLU stacks (64/128/256/512/512
                            channels, 2/2/3/3/3 layers, maxpool-2 between
                            blocks)
  blockN.projection         1x1 conv -> 1-channel side output

The detector's post-processing is the JAX package's, in numpy and cv2:
bilinear-resize the five side outputs to the input resolution, average,
sigmoid, then (the *safe variants) quantize to coarse steps.  Enabled by
``VIDTOME_HED_MODEL`` (a ``.pth`` / ``.safetensors`` file or a directory
holding one); the net runs on the device the caller names, in fp32 with
TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidtome_torch.control.loading import (cached_model, exact_fp32,
                                            model_path)

_BLOCKS = (("block1", 64, 2), ("block2", 128, 2), ("block3", 256, 3),
           ("block4", 512, 3), ("block5", 512, 3))
_BATCH = 8  # frames a forward: VGG16's activations at 512x512 take 0.5 GB


class _DoubleConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int):
        super().__init__()
        self.convs = nn.Sequential(*[
            nn.Conv2d(in_ch if i == 0 else out_ch, out_ch, 3, padding=1)
            for i in range(layers)])
        self.projection = nn.Conv2d(out_ch, 1, 1)

    def forward(self, x: torch.Tensor, down_sampling: bool = False):
        if down_sampling:
            x = F.max_pool2d(x, 2, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class HEDNetwork(nn.Module):
    """x: [B, 3, H, W] float RGB in 0..255 -> 5 side outputs
    [B, 1, H/2^k, W/2^k] (pre-sigmoid logits)."""

    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        in_ch = 3
        for name, ch, layers in _BLOCKS:
            self.add_module(name, _DoubleConvBlock(in_ch, ch, layers))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = x - self.norm
        sides = []
        for i, (name, _, _) in enumerate(_BLOCKS):
            h, side = getattr(self, name)(h, down_sampling=i > 0)
            sides.append(side)
        return sides


def load_hed(state: dict) -> HEDNetwork:
    model = HEDNetwork()
    model.load_state_dict(state, strict=True)
    return model


def safe_step(x: np.ndarray, step: int = 2) -> np.ndarray:
    """Quantize to ``step`` coarse levels (the *safe processor variants):
    y = floor(x * (step+1)) / step, clipped to [0, 1]."""
    y = np.floor(x.astype(np.float64) * float(step + 1)) / float(step)
    return np.clip(y, 0.0, 1.0).astype(np.float32)


def hed_side_outputs(images: np.ndarray, model_path: str,
                     device="cuda") -> list[np.ndarray]:
    """[T, H, W, 3] RGB in [0, 1] -> the five side outputs, each
    [T, H/2^k, W/2^k] fp32 (logits), from the net on ``device``, _BATCH
    frames a forward."""
    model = cached_model("hed", model_path, device, load_hed)
    x = torch.from_numpy(np.ascontiguousarray(
        np.asarray(images, np.float32).transpose(0, 3, 1, 2))) * 255.0
    outs: list[list[np.ndarray]] = [[] for _ in _BLOCKS]
    with torch.inference_mode(), exact_fp32():
        for i in range(0, x.shape[0], _BATCH):
            sides = model(x[i:i + _BATCH].to(device))
            for k, s in enumerate(sides):
                outs[k].append(s[:, 0].cpu().numpy())
    return [np.concatenate(o) for o in outs]


def hed_edges(images: np.ndarray, model_path: str, device="cuda",
              safe: bool = True) -> np.ndarray:
    """[T, H, W, 3] RGB in [0,1] -> softedge maps [T, H, W, 3] in [0,1]."""
    import cv2

    T, H, W = images.shape[:3]
    sides = hed_side_outputs(images, model_path, device)
    out = []
    for t in range(T):
        maps = [cv2.resize(s[t], (W, H), interpolation=cv2.INTER_LINEAR)
                for s in sides]
        logit = np.clip(np.mean(maps, axis=0, dtype=np.float64), -60., 60.)
        edge = 1.0 / (1.0 + np.exp(-logit))
        if safe:
            edge = safe_step(edge)
        out.append(np.stack([edge] * 3, -1).astype(np.float32))
    return np.stack(out)


def hed_model_path() -> str | None:
    return model_path("VIDTOME_HED_MODEL")
