"""SD2-depth (``sd_version: depth``) on the port vs the JAX package, on the
CPU.

The UNet is the tiny one with a fifth input channel, as
``tests/test_pipeline_control.py`` builds the JAX depth bundle (random
weights, seed 9), carried over by ``tests/torch_parity.port_bundle_from_jax``.
The module: the UNet at a 5-channel input, unmerged and merged, to rtol =
atol = 1e-4 in fp32.  The slice: 8 frames at 64x64, the proxy depth
through the depth cache in both packages (the files must be identical),
invert -> generate with local and global merging in 2 chunks, 8+8 DDIM
steps, fp32, the JAX package's merge draws: plain, with a CFG delta cache
(the CFG-skip steps tile the depth over the cond lane alone) and with PnP
(the source lane takes the depth too).  The inverted latents agree to atol
1e-4 and the frames reach the repo's 35 dB floor (BASELINE.md); from the
JAX package's own inversion latents the generation alone reaches 60 dB.
"""

from __future__ import annotations

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_draw_table, port_bundle_from_jax, psnr,
                                to_np)
from vidtome_torch.control.depth import \
    prepare_depth_latents as t_prepare_depth
from vidtome_torch.models.registry import SD_CONFIGS, SD_MODEL_KEYS
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.models.unet import SD2_DEPTH_UNET, SD21_UNET
from vidtome_torch.pipeline.common import stage_depth
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config
from vidtome_tpu.io import artifacts

torch.set_num_threads(2)

STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0  # the fp32 generation from identical inversion latents
PROMPT = "a colorful gradient, oil painting"
MODES = {
    "plain": {},
    "cfg_skip": {"cfg_schedule": "full:2,uniform:2"},
    "pnp": {"control": "pnp", "pnp_attn_t": 0.5, "pnp_f_t": 0.8},
}
CALLS = {"plain": {"full": 16}, "cfg_skip": {"full": 16, "cfg_skip": 6},
         "pnp": {"full": 16}}


def config(work_dir: str = "unused", **generation):
    return Config({
        "sd_version": "depth", "height": 64, "width": 64, "seed": 123,
        "work_dir": work_dir, "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4,
                      "save_intermediate": True},
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
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
    """The JAX tiny bundle with the tiny depth UNet
    (``tests/test_pipeline_control.py::test_depth_model_pipeline``)."""
    from tests.helpers import make_tiny_bundle
    from vidtome_tpu.models.registry import _jit_init
    from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel

    jb = make_tiny_bundle()
    depth_cfg = dataclasses.replace(TINY_UNET, in_channels=5)
    unet = UNet2DConditionModel(config=depth_cfg, dtype=jnp.float32)
    jb.unet_params = _jit_init(unet, jnp.zeros((1, 8, 8, 5)), jnp.asarray(0),
                               jnp.zeros((1, 16, 32)), seed=9)
    jb.unet_config = depth_cfg
    jb.sd_version = "depth"
    assert jb.use_depth
    return jb


def jax_invert(jb, cfg, clip, depth, save_dir) -> np.ndarray:
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(clip)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    return np.asarray(jinv.ddim_inversion(lat, conds, jnp.asarray(depth),
                                          None, save_dir), np.float32)


def jax_edit(jb, cfg, inverted, depth, latents_dir) -> np.ndarray:
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.control_images = None
    jgen.depth = jnp.asarray(depth)[jgen.pad_src]
    jgen.latents_dir, jgen.frame_ids = latents_dir, list(range(N_FRAMES))
    clean = jgen.ddim_sample(jnp.asarray(inverted, jb.dtype)[jgen.pad_src],
                             jgen._build_context(PROMPT))
    return np.asarray(jgen.vae.decode(clean[:N_FRAMES]), np.float32)


def port_edit(tb, cfg, saved: dict, clip, work_dir):
    """Edit from inversion latents {timestep: [T, h, w, 4]}."""
    gen = TGen(tb, cfg)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    assert table.shape[1] == 2
    pad = torch.as_tensor(gen.pad_src)
    depth = stage_depth(tb, clip, range(N_FRAMES), work_dir)
    src = None
    if gen.use_pnp:
        src = torch.stack([saved[int(t)]
                           for t in gen.scheduler.timesteps])[:, pad]
    clean = gen.ddim_sample(
        saved[int(gen.scheduler.timesteps[0])][pad], gen.context(PROMPT),
        fidx_table=table, draws=DrawSource(jax_draw_table(123, STEPS, 2, 4, 4)),
        src_table=src, depth=depth[pad])
    return to_np(gen.vae.decode(clean[:N_FRAMES])), gen


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's depth latents (through its depth cache), inversion
    (saving every timestep) and three generations."""
    os.environ.pop("VIDTOME_DEPTH_MODEL", None)
    from vidtome_tpu.control.depth import prepare_depth_latents

    jb, clip = jax_bundle(), frames()
    work = tmp_path_factory.mktemp("jax_work")
    lat_dir = str(tmp_path_factory.mktemp("jax_latents"))
    depth = prepare_depth_latents(clip, list(range(N_FRAMES)), str(work))
    inv_j = jax_invert(jb, config(), clip, depth, lat_dir)
    edits = {m: jax_edit(jb, config(**MODES[m]), inv_j, depth, lat_dir)
             for m in MODES}
    return jb, clip, work, lat_dir, inv_j, edits


def test_sd2_depth_config_and_registry():
    assert SD2_DEPTH_UNET == dataclasses.replace(SD21_UNET, in_channels=5)
    unet_cfg, text_cfg, _ = SD_CONFIGS["depth"]
    assert unet_cfg is SD2_DEPTH_UNET and text_cfg is SD_CONFIGS["2.1"][1]
    assert SD_MODEL_KEYS["depth"] == "stable-diffusion-2-depth"
    from vidtome_tpu.models.unet import SD2_DEPTH_UNET as J_DEPTH

    for field in SD2_DEPTH_UNET.__dataclass_fields__:
        assert tuple(np.atleast_1d(getattr(SD2_DEPTH_UNET, field))) == tuple(
            np.atleast_1d(getattr(J_DEPTH, field))), field


@pytest.mark.parametrize("merged", [False, True], ids=["unmerged", "merged"])
def test_depth_unet_module_matches_jax(merged):
    """The depth UNet at a 5-channel input: one unmerged call, or two
    chunks of 2 lanes x 4 frames (the bank initialised, then merged
    against)."""
    from tests.torch_parity import jax_block_draws, port_tome
    from vidtome_torch.models.tome import ToMeCall as TCall
    from vidtome_tpu.models.tome import ToMeCall as JCall
    from vidtome_tpu.models.tome import ToMeConfig as JConfig
    from vidtome_tpu.models.unet import UNet2DConditionModel as JUNet

    jb = jax_bundle()
    tb = port_bundle_from_jax(jb)
    assert tb.use_depth and tb.unet.conv_in.in_channels == 5
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(8, 16, 16, 5)).astype(np.float32)
          for _ in range(2)]
    ctx = np.repeat(rng.normal(size=(2, 16, 32)).astype(np.float32), 4, 0)
    jcfg = JConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                   global_merge_ratio=0.8, align_batch=True,
                   share_match=True, len_quantum=1024) if merged else None
    model = JUNet(config=jb.unet_config, tome=jcfg, dtype=jnp.float32,
                  use_pallas=False)
    variables = {"params": jb.unet_params}
    banks: dict = {}
    for chunk, (x, mode) in enumerate(zip(xs, ("init", "merge"))):
        if not merged:
            want = model.apply(variables, jnp.asarray(x), jnp.asarray(301),
                               jnp.asarray(ctx))
            with torch.no_grad():
                got = tb.unet(torch.from_numpy(x), 301,
                              torch.from_numpy(ctx))
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            continue
        key = jax.random.key(40 + chunk)
        want, mut = model.apply(variables, jnp.asarray(x), jnp.asarray(301),
                                jnp.asarray(ctx),
                                tome_call=JCall(key=key, bank_mode=mode),
                                num_lanes=2, mutable=["tome_bank"])
        variables = {**variables, **mut}
        local, coin = jax_block_draws(key, 4, 4)
        call = TCall(cfg=port_tome(jcfg), local_draws=local, coin=coin,
                     bank_mode=mode, banks=banks)
        with torch.no_grad():
            got = tb.unet(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                          tome_call=call)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_depth_slice_matches_jax(jax_run, tmp_path):
    jb, clip, jwork, lat_dir, inv_j, edits = jax_run
    tb = port_bundle_from_jax(jb)
    cfg = config(str(tmp_path))
    tinv = TInv(tb, cfg)
    inv_t, _ = tinv(clip)
    # the depth cache: the same files, byte for byte
    names = sorted(os.listdir(jwork / "depth"))
    assert names == sorted(os.listdir(tmp_path / "depth")) and len(names) == 16
    _, mismatch, errors = filecmp.cmpfiles(jwork / "depth", tmp_path / "depth",
                                           names, shallow=False)
    assert not mismatch and not errors
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    frames_t, gen = port_edit(tb, config(), tinv.saved, clip, str(tmp_path))
    assert gen.use_depth and dict(gen.unet_calls) == CALLS["plain"]
    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    score = psnr(frames_t, edits["plain"])
    print(f"depth slice (fp32) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR


@pytest.mark.parametrize("mode", list(MODES))
def test_depth_generation_matches_jax(jax_run, tmp_path, mode):
    """From the JAX package's inversion latents: the depth tile follows the
    lanes that run (PnP: the source lane too; CFG skip: the cond lane
    alone)."""
    jb, clip, _, lat_dir, _, edits = jax_run
    tb = port_bundle_from_jax(jb)
    saved = {int(t): torch.from_numpy(artifacts.load_latent(lat_dir, t))
             for t in TGen(tb, config()).scheduler.timesteps}
    frames_t, gen = port_edit(tb, config(**MODES[mode]), saved, clip,
                              str(tmp_path))
    assert dict(gen.unet_calls) == CALLS[mode]
    assert gen.num_lanes == (3 if mode == "pnp" else 2)
    score = psnr(frames_t, edits[mode])
    print(f"depth generation ({mode}, same inversion latents) PSNR port vs "
          f"JAX: {score:.2f} dB")
    assert score >= PSNR_SLICE


def test_depth_latents_reach_the_edit(jax_run, tmp_path):
    """Zero depth against the clip's depth, from the same latents: the
    fifth channel reaches the frames."""
    jb, clip, _, lat_dir, _, edits = jax_run
    tb = port_bundle_from_jax(jb)
    gen = TGen(tb, config())
    gen.configure_frames(N_FRAMES)
    pad = torch.as_tensor(gen.pad_src)
    x = torch.from_numpy(artifacts.load_latent(
        lat_dir, int(gen.scheduler.timesteps[0])))[pad]
    depth = t_prepare_depth(clip, list(range(N_FRAMES)), str(tmp_path))
    depth = torch.from_numpy(depth)[pad]
    draws = DrawSource(jax_draw_table(123, STEPS, 2, 4, 4))
    table = gen.fidx_table()
    out = [to_np(gen.vae.decode(gen.ddim_sample(
        x, gen.context(PROMPT), fidx_table=table, draws=draws,
        depth=d)[:N_FRAMES])) for d in (depth, torch.zeros_like(depth))]
    assert psnr(out[0], edits["plain"]) >= PSNR_SLICE
    assert np.abs(out[0] - out[1]).max() > 1e-2


@pytest.mark.parametrize("stage", ["inversion", "generation"])
def test_depth_stage_needs_depth_latents(stage):
    tb = port_bundle_from_jax(jax_bundle())
    if stage == "inversion":
        inv = TInv(tb, config())
        with pytest.raises(ValueError, match="depth latents"):
            inv.ddim_inversion(torch.zeros(N_FRAMES, 8, 8, 4),
                               inv.text([PROMPT] * N_FRAMES))
        return
    gen = TGen(tb, config())
    gen.configure_frames(N_FRAMES)
    with pytest.raises(ValueError, match="depth latents"):
        gen.ddim_sample(torch.zeros(N_FRAMES, 8, 8, 4), gen.context(PROMPT))


def test_depth_with_a_controlnet_is_refused():
    """SD2-depth's UNet takes 5 channels and 1024-wide contexts, the SD1.5
    ControlNets 4 and 768: the JAX package cannot run that call, and the
    port refuses it at construction."""
    from vidtome_torch.models.controlnet import ControlNetModel
    from vidtome_torch.models.unet import TINY_UNET

    tb = port_bundle_from_jax(jax_bundle())
    tb.controlnet = ControlNetModel(TINY_UNET).eval()
    with pytest.raises(ValueError, match="cannot run this combination"):
        TGen(tb, config(control="canny"))


def test_cli_depth_stages_on_cpu(tmp_path):
    """The CLI's stages on the tiny depth bundle: both read the clip's
    depth through <work_dir>/depth/."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli

    cfg = config(str(tmp_path / "work"))
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"), n_frames=8)
    cfg.inversion.update(save_path=str(tmp_path / "latents"),
                         save_intermediate=False)
    cfg.generation.update(latents_path=str(tmp_path / "latents"),
                          output_path=str(tmp_path / "out"),
                          frame_range=[8], save_frame=True)
    tb = port_bundle_from_jax(jax_bundle())
    cli.run_inversion(cfg, tb)
    out = cli.run_generation(cfg, tb)
    assert out["edit"].shape == (8, 64, 64, 3)
    assert sorted(os.listdir(tmp_path / "work" / "depth")) == sorted(
        f"{i:04}.{e}" for i in range(8) for e in ("npy", "png"))
    assert (tmp_path / "out" / "edit" / "frames" / "0007.png").exists()
