"""The ControlNet edit under the serving caches, port vs JAX, on the CPU.

The tiny canny slice of ``tests/test_torch_controlnet_slice.py`` (same
weights, clip, merge draws and control images), generated from the JAX
package's inversion latents with a CFG delta cache (CFG-skip steps run the
ControlNet on the cond lane only) or a deep-feature cache (shallow steps
still run the whole ControlNet; the UNet takes the level-0 residuals
only).  The frames reach the slice's 60 dB bar for a generation from
identical inversion latents; the UNet calls per kind follow the schedule.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_controlnet_slice import (PSNR_SLICE, config, frames,
                                               jax_bundle, jax_edit,
                                               jax_invert, port_edit)
from tests.torch_parity import port_bundle_from_jax, psnr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inverted(tmp_path_factory):
    jb, clip = jax_bundle(), frames()
    inv_j = jax_invert(jb, config(), clip,
                       str(tmp_path_factory.mktemp("latents")))
    return jb, clip, inv_j


@pytest.mark.parametrize("mode,calls", [
    ({"cfg_schedule": "full:2,uniform:2"}, {"full": 16, "cfg_skip": 6}),
    ({"cache_schedule": "full:2,uniform:3"}, {"full": 8, "shallow": 8}),
], ids=["cfg_skip", "deep_cache"])
def test_serving_controlnet_matches_jax(inverted, tmp_path, mode, calls):
    jb, clip, inv_j = inverted
    cfg = config(**mode)
    frames_j = jax_edit(jb, cfg, clip, inv_j, str(tmp_path))
    frames_t, gen = port_edit(port_bundle_from_jax(jb), cfg, clip, inv_j,
                              str(tmp_path))
    assert dict(gen.unet_calls) == calls
    score = psnr(frames_t, frames_j)
    print(f"ControlNet {next(iter(mode))} PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_SLICE
