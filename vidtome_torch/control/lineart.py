"""Anime lineart extraction for the lineart_anime ControlNet.

Counterpart of ``vidtome_tpu/control/lineart.py`` (the reference delegates
lineart to ``controlnet_aux``, ``utils/controlnet_utils.py:28-60`` in
lixirui142/VidToMe), whose lineart-anime detector is the Anime2Sketch
generator: a pix2pix ``UnetGenerator`` (8 downsamplings, ngf 64,
InstanceNorm without affine parameters).  :class:`UnetGenerator` nests its
``UnetSkipConnectionBlock`` Sequentials as pix2pix does, so the ``netG.pth``
checkpoint loads with ``strict=True`` (after dropping a ``module.`` prefix):

  model.model.0            outermost 4x4/2 downconv (3 -> 64)
  model.model.1.model...   nested blocks (LeakyReLU 0.2 -> downconv ->
                           [norm] -> sub -> ReLU -> upconv -> [norm]);
                           skip = channel cat
  model.model.3            outermost 4x4/2 transposed upconv (128 -> 1),
                           then tanh

Enabled by ``VIDTOME_LINEART_MODEL``; the net runs on the device the caller
names, in fp32 with TF32 off, and the resizing around it is the JAX
package's, in cv2.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vidtome_torch.control.loading import (cached_model, exact_fp32,
                                            model_path)

NGF = 64
NUM_DOWNS = 8

# channel plan outermost -> innermost: (outer_nc, inner_nc)
_PLAN = [(1, NGF), (NGF, NGF * 2), (NGF * 2, NGF * 4), (NGF * 4, NGF * 8)] \
    + [(NGF * 8, NGF * 8)] * (NUM_DOWNS - 4)


def _norm(ch: int) -> nn.Module:
    return nn.InstanceNorm2d(ch, affine=False, track_running_stats=False)


class UnetSkipConnectionBlock(nn.Module):
    """One level: [down, sub, up] in one Sequential named ``model``; every
    level but the outermost returns its input concatenated with its
    output."""

    def __init__(self, level: int, input_nc: int | None = None):
        super().__init__()
        outer_nc, inner_nc = _PLAN[level]
        outermost, innermost = level == 0, level == len(_PLAN) - 1
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1)
        up_in = inner_nc if innermost else inner_nc * 2
        upconv = nn.ConvTranspose2d(up_in, outer_nc, 4, stride=2, padding=1)
        if outermost:
            layers = [downconv, UnetSkipConnectionBlock(level + 1), nn.ReLU(),
                      upconv, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(), upconv,
                      _norm(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), downconv, _norm(inner_nc),
                      UnetSkipConnectionBlock(level + 1), nn.ReLU(), upconv,
                      _norm(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """x: [B, 3, H, W] in [-1, 1], H and W multiples of 2^NUM_DOWNS ->
    [B, 1, H, W] in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.model = UnetSkipConnectionBlock(0, input_nc=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def load_lineart(state: dict) -> UnetGenerator:
    model = UnetGenerator()
    model.load_state_dict({k.replace("module.", ""): v
                           for k, v in state.items()}, strict=True)
    return model


def lineart_edges(images: np.ndarray, model_path: str,
                  device="cuda") -> np.ndarray:
    """[T, H, W, 3] RGB in [0,1] -> lineart maps [T, H, W, 3] in [0,1]
    (dark strokes on white, the Anime2Sketch output convention)."""
    import cv2

    model = cached_model("lineart", model_path, device, load_lineart)
    T, H, W = images.shape[:3]
    gran = 256  # detector works on 256-multiples (controlnet_aux recipe)
    Hn, Wn = ((H + gran - 1) // gran) * gran, ((W + gran - 1) // gran) * gran

    out = []
    for img in np.asarray(images, np.float32):
        feed = cv2.resize(img, (Wn, Hn), interpolation=cv2.INTER_CUBIC)
        x = torch.from_numpy(np.ascontiguousarray(feed.transpose(2, 0, 1)))
        with torch.inference_mode(), exact_fp32():
            line = model(x[None].to(device) * 2.0 - 1.0)
        line = line[0, 0].cpu().numpy() * 0.5 + 0.5
        line = cv2.resize(line, (W, H), interpolation=cv2.INTER_CUBIC)
        line = np.clip(line, 0.0, 1.0)
        out.append(np.stack([line] * 3, -1))
    return np.stack(out)


def lineart_model_path() -> str | None:
    return model_path("VIDTOME_LINEART_MODEL")
