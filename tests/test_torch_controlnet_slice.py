"""The ControlNet edit path on the port vs the JAX package, on the CPU.

A tiny invert -> generate with a canny ControlNet in both stages
(``inversion.control: canny``, ``generation.control: canny``,
``control_scale`` 0.7): 8 frames at 64x64 with moving discs (edges for
canny), 2 chunks, local and global merging, 8+8 DDIM steps, fp32, the JAX
package's weights (its tiny ControlNet with the zero convs moved off zero,
``tests/torch_parity.perturb_zero_convs``) and merge draws.  The inverted
latents agree to atol 1e-4; the frames reach the repo's 35 dB floor
(BASELINE.md), and from the JAX package's own inversion latents the
generation alone reaches 60 dB (as ``tests/test_torch_pnp_slice.py``
holds PnP: from the port's latents, 1e-5 differences flip near-tie global
matchings on random weights).  The control images go through the png cache
in both packages.  ``control_scale: 0`` must change the frames, as
``tests/test_pipeline_control.py`` checks the JAX package.

``tests/test_torch_controlnet_serving.py`` holds the CFG-skip and
deep-cache generations with the ControlNet.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_draw_table, perturb_zero_convs,
                                port_bundle_from_jax, psnr, to_np)
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config

torch.set_num_threads(2)

STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0  # the fp32 generation from identical inversion latents
PROMPT = "a colorful gradient, oil painting"


def config(**generation):
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4,
                      "control": "canny", "control_scale": 0.7},
        "generation": {
            "control": "canny", "control_scale": 0.7,
            "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "align_batch": True, "share_match": True, "len_quantum": 1024,
            **generation},
    })


def frames() -> np.ndarray:
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    out = []
    for i in range(N_FRAMES):
        ph = i / N_FRAMES
        disc = ((xx - 0.3 - 0.4 * ph) ** 2 + (yy - 0.55) ** 2) < 0.03
        r = np.where(disc, 0.9, 0.5 + 0.4 * np.sin(2 * np.pi * (xx + ph)))
        g = np.where(disc, 0.1, 0.5 + 0.4 * np.cos(2 * np.pi * yy))
        out.append(np.stack([r, g, np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def jax_bundle():
    """The JAX tiny bundle with a tiny ControlNet, its zero convs moved."""
    import jax

    from tests.helpers import make_tiny_bundle
    from vidtome_tpu.models.controlnet import ControlNetModel
    from vidtome_tpu.models.registry import _jit_init
    from vidtome_tpu.models.unet import TINY_UNET

    jb = make_tiny_bundle()
    model = ControlNetModel(config=TINY_UNET, dtype=jnp.float32)
    params = _jit_init(model, jnp.zeros((1, 8, 8, 4)), jnp.asarray(0),
                       jnp.zeros((1, 8, 32)), jnp.zeros((1, 64, 64, 3)),
                       seed=7)
    jb.controlnet_params = perturb_zero_convs(
        jax.tree.map(np.asarray, jax.device_get(params)))
    jb.controlnet_config = TINY_UNET
    return jb


def jax_invert(jb, cfg, clip, save_dir) -> np.ndarray:
    from vidtome_tpu.control.preprocess import control_preprocess
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(clip)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    control = jnp.asarray(control_preprocess(clip, "canny"), jb.dtype)
    return np.asarray(jinv.ddim_inversion(lat, conds, None, control,
                                          save_dir), np.float32)


def jax_edit(jb, cfg, clip, inverted, work_dir) -> np.ndarray:
    from vidtome_tpu.control.preprocess import control_preprocess
    from vidtome_tpu.io import artifacts
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = None
    images = artifacts.load_or_compute_control(
        work_dir, "canny", clip, list(range(N_FRAMES)),
        lambda f: control_preprocess(f, "canny"))
    jgen.control_images = jnp.asarray(images, jb.dtype)[jgen.pad_src]
    clean = jgen.ddim_sample(jnp.asarray(inverted, jb.dtype)[jgen.pad_src],
                             jgen._build_context(PROMPT))
    return np.asarray(jgen.vae.decode(clean[:N_FRAMES]), np.float32)


def port_edit(tb, cfg, clip, inverted, work_dir):
    gen = TGen(tb, cfg)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    assert table.shape[1] == 2
    pad = torch.as_tensor(gen.pad_src)
    control = gen.load_control(clip, list(range(N_FRAMES)), work_dir)
    clean = gen.ddim_sample(
        torch.from_numpy(np.array(inverted))[pad].to(tb.dtype),
        gen.context(PROMPT), fidx_table=table,
        draws=DrawSource(jax_draw_table(123, STEPS, 2, 4, 4)),
        control=control[pad])
    return to_np(gen.vae.decode(clean[:N_FRAMES])), gen


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg, clip = config(), frames()
    jb = jax_bundle()
    tmp = tmp_path_factory.mktemp("jax")
    inv_j = jax_invert(jb, cfg, clip, str(tmp))
    return jb, clip, inv_j, jax_edit(jb, cfg, clip, inv_j, str(tmp))


def test_controlnet_slice_matches_jax(jax_run, tmp_path):
    jb, clip, inv_j, frames_j = jax_run
    cfg = config()
    tb = port_bundle_from_jax(jb)
    tinv = TInv(tb, cfg)
    assert tinv.use_controlnet and tinv.control_scale == 0.7
    inv_t, _ = tinv(clip)
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    frames_t, gen = port_edit(tb, cfg, clip, to_np(inv_t), str(tmp_path))
    assert gen.use_controlnet and dict(gen.unet_calls) == {"full": 16}
    assert (tmp_path / "canny_image" / "0007.png").exists()
    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"ControlNet slice (fp32) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR
    same, _ = port_edit(tb, cfg, clip, inv_j, str(tmp_path))
    score = psnr(same, frames_j)
    print(f"ControlNet slice (fp32, same inversion latents) PSNR: "
          f"{score:.2f} dB")
    assert score >= PSNR_SLICE


def test_control_scale_changes_the_edit(jax_run, tmp_path):
    """control_scale 0 against 0.7 from the same inversion latents: the
    ControlNet reaches the frames (the JAX package's own check,
    ``tests/test_pipeline_control.py``)."""
    jb, clip, inv_j, frames_j = jax_run
    tb = port_bundle_from_jax(jb)
    at_07, _ = port_edit(tb, config(), clip, inv_j, str(tmp_path))
    at_0, gen = port_edit(tb, config(control_scale=0.0), clip, inv_j,
                          str(tmp_path))
    assert gen.control_scale == 0.0
    assert np.abs(at_0 - at_07).max() > 1e-2
    assert psnr(at_07, frames_j) > psnr(at_0, frames_j)


def test_generation_needs_control_images():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="canny")
    gen = TGen(bundle, config())
    gen.configure_frames(N_FRAMES)
    with pytest.raises(ValueError, match="control images"):
        gen.ddim_sample(torch.zeros(N_FRAMES, 8, 8, 4), gen.context(PROMPT))
    inv = TInv(bundle, config())
    with pytest.raises(ValueError, match="control images"):
        inv.ddim_inversion(torch.zeros(N_FRAMES, 8, 8, 4),
                           inv.text([PROMPT] * N_FRAMES))


@pytest.mark.parametrize("stage", ["inversion", "generation"])
def test_a_controlnet_stage_needs_one_in_the_bundle(stage):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match="needs a ControlNet"):
        (TInv if stage == "inversion" else TGen)(bundle, config())


def test_int8_stage_quantizes_the_controlnet(capsys):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="canny")
    cfg = config()
    cfg["quant"] = "int8"
    gen, inv = TGen(bundle, cfg), TInv(bundle, cfg)
    assert gen.cn_qt is not None and inv.cn_qt is not None
    assert gen.cn_qt is not inv.cn_qt and len(gen.cn_qt) == len(inv.cn_qt)
    assert "ControlNet weight tensors" in capsys.readouterr().out
    assert gen.cn_qt.get(bundle.controlnet.controlnet_mid_block) is None
    cfg["quant"] = "none"
    assert TGen(bundle, cfg).cn_qt is None


def test_cli_controlnet_stages_on_cpu(tmp_path):
    """The CLI's stages on a tiny CPU bundle with a canny ControlNet in both
    stages: generation reads the clip, writes its control images to
    <work_dir>/canny_image/ and edits."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli

    cfg = config()
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"), n_frames=8)
    cfg["work_dir"] = str(tmp_path / "work")
    cfg.inversion["save_path"] = str(tmp_path / "latents")
    cfg.generation.update(latents_path=str(tmp_path / "latents"),
                          output_path=str(tmp_path / "out"),
                          frame_range=[8], save_frame=True)
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="canny")
    cli.run_inversion(cfg, bundle)
    out = cli.run_generation(cfg, bundle)
    assert out["edit"].shape == (8, 64, 64, 3)
    assert sorted(os.listdir(tmp_path / "work" / "canny_image")) == [
        f"{i:04}.png" for i in range(8)]
    assert (tmp_path / "out" / "edit" / "frames" / "0007.png").exists()
