"""SDXL and the SDXL refiner on the port vs the JAX package, on the CPU.

The JAX side is the tiny dual-encoder stack of
``tests/test_pipeline_xl.py`` (its ``xl_bundle``: the tiny XL UNet with a
48-wide context, the 32- and 16-wide text encoders, the tiny VAE at
scaling 0.13025; random, seeds 0-3) and the JAX ``init_model
("tiny-refiner")``, carried into the port by
``tests/torch_parity.port_bundle_from_jax`` / ``load_jax_weights``.

Modules, fp32: the text-encoder pair's context and pooled output, and the
refiner's one encoder, to atol 1e-5; the tiny XL and refiner UNets with
add-embeddings (given, and the zero defaults) to rtol = atol = 1e-4.

The slice: 8 frames at 64x64, invert -> generate with local and global
merging in 2 chunks, 6+6 DDIM steps, fp32, the JAX package's merge draws:
the inverted latents to atol 1e-4, the frames to the repo's 35 dB floor
(BASELINE.md); the two-stage generation (base steps 0-3, refiner 4-5)
with and without the deep and CFG step caches, from the JAX package's own
inversion latents, to 60 dB.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_draw_table, load_jax_weights,
                                port_bundle_from_jax, port_text_config,
                                port_unet_config, psnr, to_np)
from vidtome_torch.models import clip_text as t_clip
from vidtome_torch.models import unet as t_unet
from vidtome_torch.models.registry import (SD_CONFIGS, SD_MODEL_KEYS,
                                           init_model)
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.ops.quant import quantize_unet
from vidtome_torch.pipeline.common import TextEncoder as TText
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config

torch.set_num_threads(2)

STEPS = 6
N_FRAMES = 8
PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0  # the fp32 generation from identical inversion latents
PROMPT = "a colorful gradient, oil painting"
REFINER = {"sd_version": "tiny-refiner", "denoising_start": 0.7,
           "aesthetic_score": 6.0, "negative_aesthetic_score": 2.5}
CACHES = {"cache_interval": 2, "cfg_interval": 2}


def config(**generation) -> Config:
    return Config({
        "sd_version": "xl", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4},
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "global_rand": 0.5, "len_quantum": 1024, **generation},
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


def jax_xl_bundle():
    """``tests/test_pipeline_xl.py::xl_bundle``."""
    from vidtome_tpu.models.clip_text import (TINY_TEXT, TINY_TEXT_2,
                                              CLIPTextModel)
    from vidtome_tpu.models.registry import ModelBundle, _jit_init
    from vidtome_tpu.models.tokenizer import HashTokenizer
    from vidtome_tpu.models.unet import TINY_SDXL_UNET, UNet2DConditionModel
    from vidtome_tpu.models.vae import AutoencoderKL

    dtype = jnp.float32
    cfg = dataclasses.replace(TINY_SDXL_UNET, cross_attention_dim=48)
    unet = UNet2DConditionModel(config=cfg, dtype=dtype)
    unet_params = _jit_init(
        unet, jnp.zeros((1, 8, 8, 4), dtype), jnp.asarray(0),
        jnp.zeros((1, 16, 48), dtype), add_text_embeds=jnp.zeros((1, 16)),
        add_time_ids=jnp.zeros((1, 6)), seed=0)
    vae = AutoencoderKL(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                        scaling_factor=0.13025, dtype=dtype)
    vae_params = _jit_init(vae, jnp.zeros((1, 64, 64, 3), dtype), seed=1)
    text1 = _jit_init(CLIPTextModel(cfg=TINY_TEXT),
                      jnp.zeros((1, 16), jnp.int32), seed=2)
    text2 = _jit_init(CLIPTextModel(cfg=TINY_TEXT_2),
                      jnp.zeros((1, 16), jnp.int32), seed=3)
    return ModelBundle(
        model_key="tiny-xl", sd_version="xl", unet_config=cfg,
        text_config=TINY_TEXT, unet_params=unet_params,
        vae_params=vae_params, text_params=text1,
        tokenizer=HashTokenizer(vocab_size=1000, max_length=16),
        dtype=dtype, random_weights=True, vae_channels=((8, 8, 8, 8), 1),
        vae_scaling=0.13025, text2_config=TINY_TEXT_2, text2_params=text2)


@pytest.fixture(scope="module")
def bundles():
    from vidtome_tpu.models.registry import init_model as j_init

    jb = jax_xl_bundle()
    jr = j_init(sd_version="tiny-refiner", weight_dtype="fp32")
    return jb, jr


def jax_edits(jb, cfg, inverted, base: bool,
              latents_dir: str | None = None) -> dict:
    """The JAX generator's two-stage frames (and, with ``base``, the base
    model's alone over all steps: the same executable, blocks of 2
    steps); PnP reads the saved inversion latents under ``latents_dir``."""
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jgen = JGen(jb, Config({**cfg, "generation": {
        **cfg.generation, "steps_per_block": 2}}))
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    jgen.latents_dir, jgen.frame_ids = latents_dir, list(range(N_FRAMES))
    jgen.init_noise = jnp.asarray(inverted, jb.dtype)[jgen.pad_src]
    context = jgen._build_context(PROMPT)
    clean = {"two_stage": jgen._sample_with_refiner(PROMPT, context)}
    if base:
        clean["base"] = jgen.ddim_sample(jgen.init_noise, context)
    return {k: np.asarray(jgen.vae.decode(v[:N_FRAMES]), np.float32)
            for k, v in clean.items()}


@pytest.fixture(scope="module")
def jax_run(bundles, tmp_path_factory):
    """The JAX package's inversion and generations: base only, two-stage,
    two-stage with step caches."""
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jb, _ = bundles
    cfg = config()
    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames())
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    inv = np.asarray(jinv.ddim_inversion(
        lat, conds, None, None, str(tmp_path_factory.mktemp("latents"))),
        np.float32)
    plain = jax_edits(jb, config(refiner=REFINER), inv, base=True)
    caches = jax_edits(jb, config(refiner=REFINER, **CACHES), inv, False)
    return inv, {"base": plain["base"], "refiner": plain["two_stage"],
                 "refiner_caches": caches["two_stage"]}


def port_sample(tb, bundles, cfg, inverted, src: dict | None = None):
    """The port's frames from inversion latents [T, h, w, 4], with the
    JAX package's merge draws (PnP: the source table from ``src``,
    {timestep: latents}); a refiner stage takes the JAX refiner's weights,
    and an int8 refiner its int8 table of them."""
    gen = TGen(tb, cfg)
    r = gen.refiner
    if r is not None:
        load_jax_weights(r.bundle, bundles[1])
        if r.qt is not None:
            r.qt = quantize_unet(r.bundle.unet)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    assert table.shape[1] == 2
    pad = torch.as_tensor(gen.pad_src)
    inputs = {}
    if src is not None:
        inputs["src_table"] = torch.stack(
            [src[int(t)] for t in gen.scheduler.timesteps])[:, pad]
    x0 = torch.tensor(np.asarray(inverted))[pad]
    clean = gen.sample(x0, PROMPT, fidx_table=table,
                       draws=DrawSource(jax_draw_table(123, STEPS, 2, 4, 4)),
                       **inputs)
    return to_np(gen.vae.decode(clean[:N_FRAMES])), gen


def test_sdxl_configs_match_jax():
    from vidtome_tpu.models import clip_text as j_clip
    from vidtome_tpu.models import unet as j_unet

    for name in ("SDXL_UNET", "SDXL_REFINER_UNET", "TINY_SDXL_UNET",
                 "TINY_REFINER_UNET"):
        assert getattr(t_unet, name) == port_unet_config(
            getattr(j_unet, name)), name
    for name in ("SDXL_TEXT_1", "SDXL_TEXT_2", "TINY_TEXT_2"):
        assert getattr(t_clip, name) == port_text_config(
            getattr(j_clip, name)), name
    assert t_unet.SDXL_UNET.depth_for(0) == 0
    assert t_unet.SDXL_UNET.depth_for(2) == 10
    assert SD_CONFIGS["xl-refiner"][1] is t_clip.SDXL_TEXT_2
    assert SD_MODEL_KEYS["xl"] == "stable-diffusion-xl-base-1.0"


@pytest.mark.parametrize("version", ["xl", "xl-refiner"])
def test_full_sdxl_stacks_build(version):
    """The full-size stacks on the meta device: parameter counts, the
    addition embedding's input width and the per-level depth."""
    unet_cfg, text_cfg, _ = SD_CONFIGS[version]
    with torch.device("meta"):
        unet = t_unet.UNet2DConditionModel(unet_cfg)
        text = t_clip.CLIPTextModel(text_cfg)
    n = sum(p.numel() for p in unet.parameters())
    ids = 6 if version == "xl" else 5
    assert unet.add_embedding.linear_1.in_features == 1280 + ids * 256
    blocks = sum(len(a.transformer_blocks) for a in unet.modules()
                 if isinstance(a, t_unet.Transformer2D))
    assert (n, blocks) == ((2_567_463_684, 70) if version == "xl"
                           else (2_259_526_660, 44))
    assert (text.text_projection is None) == (version == "xl")


@pytest.mark.parametrize("version", ["xl", "tiny-refiner"])
def test_text_encoders_match_jax(bundles, version):
    """The pair's concatenated context and encoder 2's pooled output
    (SDXL), the one bigG-style encoder's (refiner), one prompt and the
    CFG pair."""
    from vidtome_tpu.pipeline.common import TextEncoder as JText

    jb = bundles[0] if version == "xl" else bundles[1]
    tb = port_bundle_from_jax(jb, "tiny" if version == "xl" else version)
    assert tb.is_xl == (version == "xl") and tb.needs_pooled
    jt, tt = JText(jb), TText(tb)
    for got, want in ((tt("a prompt"), jt("a prompt")),
                      (tt.embed_cfg(PROMPT, "bad"), jt.embed_cfg(PROMPT,
                                                                "bad"))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5,
                                       rtol=0)
    ctx, pooled = tt("a prompt")
    assert ctx.shape[-1] == (48 if version == "xl" else 16)
    assert pooled.shape == (1, 16)


@pytest.mark.parametrize("given", [True, False], ids=["embeds", "zeros"])
@pytest.mark.parametrize("version", ["xl", "tiny-refiner"])
def test_unet_matches_jax(bundles, version, given):
    """One UNet call with the pooled embeds and time ids (or without: the
    zero defaults), fp32."""
    from vidtome_tpu.models.unet import UNet2DConditionModel as JUNet

    jb = bundles[0] if version == "xl" else bundles[1]
    tb = port_bundle_from_jax(jb, "tiny" if version == "xl" else version)
    cfg = jb.unet_config
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 4), np.float32)
    ctx = rng.standard_normal((4, 16, cfg.cross_attention_dim), np.float32)
    kw = {}
    if given:
        ids = ([64.0, 64.0, 0.0, 0.0, 64.0, 64.0] if version == "xl" else
               [64.0, 64.0, 0.0, 0.0, 2.5])
        kw = dict(add_text_embeds=rng.standard_normal((4, 16), np.float32),
                  add_time_ids=np.tile(np.float32(ids), (4, 1)))
    model = JUNet(config=cfg, dtype=jnp.float32, use_pallas=False)
    want = model.apply({"params": jb.unet_params}, jnp.asarray(x),
                       jnp.asarray(301), jnp.asarray(ctx),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_xl_shallow_call_stays_exact(bundles):
    """SDXL's level 0 has no attention: a shallow call fed the deep
    feature of a full call at the same t reproduces its eps."""
    tb = port_bundle_from_jax(bundles[0])
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, 48), np.float32))
    kw = dict(add_text_embeds=torch.ones(2, 16),
              add_time_ids=torch.full((2, 6), 64.0))
    with torch.no_grad():
        eps, deep = tb.unet(x, 301, ctx, cache_mode="full", **kw)
        shallow = tb.unet(x, 301, ctx, cache_mode="shallow", deep_cache=deep,
                          **kw)
    assert deep.shape == (2, 16, 16, 64)
    assert torch.equal(eps, shallow)


def test_xl_slice_matches_jax(bundles, jax_run):
    """Inversion (pooled embeds and time ids each call) and generation."""
    inv_j, edits = jax_run
    tb = port_bundle_from_jax(bundles[0])
    tinv = TInv(tb, config())
    inv_t, _ = tinv(frames())
    assert dict(tinv.unet_calls) == {"full": 2 * STEPS}
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    frames_t, gen = port_sample(tb, bundles, config(), inv_t)
    assert gen.refiner is None and dict(gen.unet_calls) == {"full": 2 * STEPS}
    score = psnr(frames_t, edits["base"])
    print(f"SDXL slice (fp32) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR


@pytest.mark.parametrize("mode", ["refiner", "refiner_caches"])
def test_two_stage_refiner_matches_jax(bundles, jax_run, mode):
    """Base steps 0-3, refiner 4-5, from the JAX package's inversion
    latents: the refiner's draws and chunk schedule at the global step
    index; with the step caches its first step refreshes."""
    inv_j, edits = jax_run
    tb = port_bundle_from_jax(bundles[0])
    cfg = config(refiner=REFINER, **(CACHES if mode != "refiner" else {}))
    frames_t, gen = port_sample(tb, bundles, cfg, inv_j)
    r = gen.refiner
    assert gen.split_step() == 4 and r.bundle.is_refiner
    assert r.refiner is None and r.use_pnp is False
    if mode == "refiner":
        assert dict(gen.unet_calls) == {"full": 8}
        assert dict(r.unet_calls) == {"full": 4}
    else:  # steps 4 and 5: a refresh, then a shallow CFG-skip step
        assert dict(r.unet_calls) == {"full": 2, "shallow": 2, "cfg_skip": 2}
    score = psnr(frames_t, edits[mode])
    print(f"two-stage ({mode}) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_SLICE
    assert np.abs(frames_t - edits["base"]).max() > 1e-3


def test_refiner_rejects_non_xl_base():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = config(refiner={"sd_version": "tiny-refiner"})
    cfg["sd_version"] = "tiny"
    with pytest.raises(ValueError, match="SDXL base"):
        TGen(bundle, cfg)


@pytest.mark.parametrize("version", ["xl", "xl-refiner", "tiny-refiner"])
def test_controlnet_on_sdxl_raises(version):
    """Every ControlNet of CONTROLNET_DICT is SD1.5's: refused before any
    module is built."""
    with pytest.raises(ValueError, match="SD1.5"):
        init_model(version, weight_dtype="fp32", device="meta",
                   control="canny")


def test_inverter_refuses_a_refiner(bundles):
    """The JAX inverter keys on is_xl, so a refiner's (context, pooled)
    reaches its UNet as the context; the port refuses it at
    construction."""
    tr = port_bundle_from_jax(bundles[1], "tiny-refiner")
    with pytest.raises(ValueError, match="cannot invert"):
        TInv(tr, config())


def test_cli_sdxl_stages_on_cpu(bundles, tmp_path):
    """The CLI's stages on the tiny SDXL bundle with a (random) tiny
    refiner: the latents under the bundle's model key, the per-frame
    prompts beside them, the frames of the two-stage edit."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli

    cfg = config(refiner=REFINER, latents_path=str(tmp_path / "latents"),
                 output_path=str(tmp_path / "out"), frame_range=[N_FRAMES],
                 save_frame=True, batch_size=2)
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"),
                                        n_frames=N_FRAMES)
    cfg.inversion["save_path"] = str(tmp_path / "latents")
    tb = port_bundle_from_jax(bundles[0])
    assert tb.is_xl and not tb.is_refiner and tb.vae_scaling == 0.13025
    cli.run_inversion(cfg, tb)
    lat_dir = tmp_path / "latents" / "tiny-xl"
    assert (lat_dir / "inversion_prompts.txt").read_text() == "\n".join(
        ["a colorful gradient"] * N_FRAMES)
    out = cli.run_generation(cfg, tb)
    assert out["edit"].shape == (N_FRAMES, 64, 64, 3)
    assert torch.isfinite(out["edit"]).all()
    assert (tmp_path / "out" / "edit" / "frames" / "0007.png").exists()


@pytest.mark.parametrize("mode", ["pnp", "int8"])
def test_cli_sdxl_modes_on_cpu(bundles, tmp_path, mode):
    """The CLI's stages on the tiny SDXL bundle with PnP (the inversion
    writes the latents of every step, the generation reads them as its
    source lane) or with int8 in both stages."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli

    gene = ({"control": "pnp"} if mode == "pnp"
            else {"quant": "int8", "guidance_scale": 1.0})
    cfg = config(latents_path=str(tmp_path / "latents"),
                 output_path=str(tmp_path / "out"), frame_range=[N_FRAMES],
                 batch_size=2, **gene)
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"),
                                        n_frames=N_FRAMES)
    cfg.inversion.update(save_path=str(tmp_path / "latents"),
                         save_intermediate=mode == "pnp",
                         quant="int8" if mode == "int8" else "none")
    tb = port_bundle_from_jax(bundles[0])
    cli.run_inversion(cfg, tb)
    saved = sorted((tmp_path / "latents" / "tiny-xl").glob("noisy_latents_*"))
    assert len(saved) == (STEPS if mode == "pnp" else 1)
    out = cli.run_generation(cfg, tb)
    assert out["edit"].shape == (N_FRAMES, 64, 64, 3)
    assert torch.isfinite(out["edit"]).all()
    assert (tmp_path / "out" / "edit").is_dir()
