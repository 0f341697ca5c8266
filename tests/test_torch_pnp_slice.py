"""The PnP edit path on the port vs the JAX package, on the CPU.

A tiny invert -> PnP generate: 8 frames at 64x64 in 2 chunks with local
and global merging (the bank initialised on the first chunk and merged
against on the second), the source lane fed from the inversion latents of
every generation timestep, attention injection on the first half of the
steps and conv injection on the first 80%, and a CFG delta cache so that
some steps run the 3-lane CFG skip (source and cond lanes only).  Same
weights, chunk schedule and merge draws on both sides.  The inverted
latents agree to atol 1e-4 (fp32 noise); the frames reach the repo's
35 dB PSNR floor (BASELINE.md):

* fp32, ``sublayer_mode`` off on both sides;
* bf16, ``sublayer_mode: fused``: the port's fused sublayer (its plain
  version on the CPU) against the JAX package's Pallas sublayer in
  interpret mode, generating from the same inversion latents.  On these
  random weights bf16 rounding flips near-tie token matchings (the JAX
  package's own bf16 run against its fp32 run: 26 dB) and guidance 7.5
  amplifies what is left (port vs JAX 25 dB, the JAX package's two
  sublayer modes against each other 30 dB), so this slice runs without
  merging at guidance 1.0, where the JAX package's two sublayer modes
  agree at 44 dB (4 steps); merging, the bank and guidance are held by
  the fp32 slice.

Also: ``configs/dog.yaml`` and ``configs/demo-pnp.yaml`` build both stages,
PnP refuses the eps skip and the deep cache with the JAX package's
ValueErrors, and every ControlNet control on a bundle without a ControlNet
(and openpose without a pose model) is refused.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_draw_table, port_bundle_from_jax, psnr, to_np
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config, load_config_file
from vidtome_tpu.io import artifacts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0  # the fp32 generation from identical inversion latents
PROMPT = "a colorful gradient, oil painting"


def _config(**generation):
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4,
                      "save_intermediate": True},
        "generation": {
            "control": "pnp", "pnp_attn_t": 0.5, "pnp_f_t": 0.8,
            "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "share_match": True, "len_quantum": 1024,
            "cfg_schedule": "full:2,uniform:2", **generation},
    })


def _frames():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    out = []
    for i in range(N_FRAMES):
        ph = i / N_FRAMES
        out.append(np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (xx + ph)),
                             0.5 + 0.5 * np.cos(2 * np.pi * (yy + ph / 2)),
                             np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def _jax_edit(jb, cfg, latents_dir, inverted, use_pallas=None):
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jgen = JGen(jb, cfg, use_pallas=use_pallas)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    jgen.latents_dir, jgen.frame_ids = latents_dir, list(range(N_FRAMES))
    clean = jgen.ddim_sample(jnp.asarray(inverted, jb.dtype)[jgen.pad_src],
                             jgen._build_context(PROMPT))
    return np.asarray(jgen.vae.decode(clean[:N_FRAMES]), np.float32)


def _jax_saved(latents_dir, timesteps) -> dict:
    """The JAX inverter's saved latents, as a port Inverter keeps them."""
    return {int(t): torch.from_numpy(artifacts.load_latent(latents_dir, t))
            for t in timesteps}


def _port_edit(tb, cfg, saved):
    """Edit from inversion latents {timestep: [T, h, w, 4]}."""
    gen = TGen(tb, cfg)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    assert table.shape[1] == 2
    pad = torch.as_tensor(gen.pad_src)
    src = torch.stack([saved[int(t)] for t in gen.scheduler.timesteps])[:, pad]
    inverted = saved[int(gen.scheduler.timesteps[0])]
    clean = gen.ddim_sample(
        inverted[pad].to(tb.dtype), gen.context(PROMPT), fidx_table=table,
        draws=DrawSource(jax_draw_table(123, STEPS, 2, 4, 4)),
        src_table=src.to(tb.dtype))
    return to_np(gen.vae.decode(clean[:N_FRAMES])), gen


def _jax_invert(jb, cfg, frames, save_dir):
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    return np.asarray(jinv.ddim_inversion(lat, conds, None, None, save_dir),
                      np.float32)


def test_pnp_slice_fp32_matches_jax(tmp_path):
    from tests.helpers import make_tiny_bundle

    cfg, frames = _config(), _frames()
    jb = make_tiny_bundle()
    inv_j = _jax_invert(jb, cfg, frames, str(tmp_path))
    frames_j = _jax_edit(jb, cfg, str(tmp_path), inv_j)

    tb = port_bundle_from_jax(jb)
    tinv = TInv(tb, cfg)
    inv_t, _ = tinv(frames)
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    timesteps = [int(t) for t in tinv.scheduler.timesteps]
    assert sorted(tinv.saved) == sorted(timesteps)
    for t in timesteps:  # every source latent within fp32 noise
        np.testing.assert_allclose(
            to_np(tinv.saved[t]), artifacts.load_latent(str(tmp_path), t),
            atol=1e-4, rtol=0)
    frames_t, gen = _port_edit(tb, cfg, tinv.saved)
    assert (gen.num_lanes, gen.pnp_attn_steps, gen.pnp_conv_steps) == (3, 4, 6)
    assert gen.tome.align_batch
    # cfg refresh [1,1,1,0,1,0,1,0]: 3 of the 8 steps run the CFG skip
    assert dict(gen.unet_calls) == {"full": 16, "cfg_skip": 6}
    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"PnP slice (fp32) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR
    # From the JAX package's own inversion latents the two agree to fp32
    # noise (113 dB); from the port's, 1e-5 differences flip near-tie
    # global matchings on these random weights (46 dB).  The tighter bar
    # holds the generation alone.
    same, _ = _port_edit(tb, cfg, _jax_saved(str(tmp_path), timesteps))
    score = psnr(same, frames_j)
    print(f"PnP slice (fp32, same inversion latents) PSNR: {score:.2f} dB")
    assert score >= PSNR_SLICE


def test_pnp_slice_fused_sublayer_bf16_matches_jax(tmp_path):
    """Generation in bf16 with sublayer_mode: fused on both sides, from the
    JAX package's fp32 inversion latents."""
    from tests.helpers import make_tiny_bundle

    cfg, frames = _config(), _frames()
    inv_j = _jax_invert(make_tiny_bundle(), cfg, frames, str(tmp_path))
    bcfg = _config(sublayer_mode="fused", float_precision="bf16",
                   guidance_scale=1.0, local_merge_ratio=0.0,
                   merge_global=False)
    jb16 = make_tiny_bundle(jnp.bfloat16)
    frames_j = _jax_edit(jb16, bcfg, str(tmp_path), inv_j, use_pallas=True)
    tb16 = port_bundle_from_jax(jb16)
    saved = _jax_saved(str(tmp_path), TGen(tb16, bcfg).scheduler.timesteps)
    frames_t, gen = _port_edit(tb16, bcfg, saved)
    assert gen.sublayer_mode == "fused" and tb16.dtype == torch.bfloat16
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"PnP slice (bf16, fused sublayer) PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR


@pytest.mark.parametrize("name", ["dog.yaml", "demo-pnp.yaml"])
def test_pnp_configs_build_both_stages(name):
    cfg = load_config_file(str(ROOT / "configs" / name))
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    inv, gen = TInv(bundle, cfg), TGen(bundle, cfg)
    assert inv.save_intermediate and gen.use_pnp and gen.num_lanes == 3
    steps = gen.n_timesteps
    assert (gen.pnp_attn_steps, gen.pnp_conv_steps) == (
        int(steps * float(cfg.generation.get("pnp_attn_t", 0.5))),
        int(steps * float(cfg.generation.get("pnp_f_t", 0.8))))
    assert {int(t) for t in gen.scheduler.timesteps} <= inv.timesteps_to_save
    cfg.generation["sublayer_mode"] = "fused"
    assert TGen(bundle, cfg).sublayer_mode == "fused"


def test_context_has_the_source_lane_first():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    gen = TGen(bundle, _config())
    ctx = gen.context(PROMPT)
    want = gen.text(["", "blurry", PROMPT])
    assert ctx.shape[0] == 3 and torch.equal(ctx, want)


@pytest.mark.parametrize("key,value", [
    ("cache_interval", 2), ("eps_schedule", "full:2,uniform:2"),
    ("eps_interval", 3), ("cache_schedule", "full:2,uniform:2")])
def test_pnp_refuses_step_skips(key, value):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match="pnp"):
        TGen(bundle, _config(**{key: value}))


@pytest.mark.parametrize("control", ["tile", "ip2p", "openpose", "softedge",
                                     "depth", "lineart_anime", "canny"])
def test_controlnet_controls_still_refused(control, monkeypatch, tmp_path):
    """Every ControlNet control is refused on a bundle without a ControlNet
    and builds on one with it; openpose first needs a pose model, and fails
    at construction without one, as in the JAX package."""
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    if control == "openpose":
        monkeypatch.delenv("VIDTOME_POSE_MODEL", raising=False)
        with pytest.raises(RuntimeError, match="VIDTOME_POSE_MODEL"):
            TGen(bundle, _config(control=control))
        monkeypatch.setenv("VIDTOME_POSE_MODEL", str(tmp_path))
    with pytest.raises(ValueError, match="needs a ControlNet"):
        TGen(bundle, _config(control=control))
    with_cn = init_model("tiny", weight_dtype="fp32", device="cpu",
                         control=control)
    gen = TGen(with_cn, _config(control=control))
    assert gen.use_controlnet and not gen.use_pnp and gen.num_lanes == 2


@pytest.mark.parametrize("stage", ["inversion", "generation"])
def test_sublayer_mode_parsed_and_int8_refused(stage):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cls = TInv if stage == "inversion" else TGen
    cfg = _config()
    cfg[stage]["sublayer_mode"] = "sometimes"
    with pytest.raises(ValueError, match="sublayer_mode"):
        cls(bundle, cfg)
    cfg[stage].update(sublayer_mode="fused", quant="int8")
    with pytest.raises(ValueError, match="bf16"):
        cls(bundle, cfg)


def test_generation_needs_the_source_table():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    gen = TGen(bundle, _config())
    gen.configure_frames(N_FRAMES)
    x = torch.zeros(N_FRAMES, 8, 8, 4)
    with pytest.raises(ValueError, match="src_table"):
        gen.ddim_sample(x, gen.context(PROMPT))


@pytest.mark.parametrize("version", ["depth", "xl"])
def test_unported_versions_refused(version):
    """SDXL is not ported yet and is refused; SD2-depth builds (on the meta
    device here: its full-size weights are not needed to check the
    stack)."""
    if version == "xl":
        with pytest.raises(NotImplementedError, match=version):
            init_model(version, weight_dtype="fp32", device="cpu")
        return
    from vidtome_torch.models import registry

    assert version not in registry._UNPORTED_VERSIONS
    unet_cfg, text_cfg, _ = registry.SD_CONFIGS[version]
    with torch.device("meta"):
        unet = registry.UNet2DConditionModel(unet_cfg)
    assert unet.conv_in.weight.shape == (320, 5, 3, 3)
    assert unet.config.cross_attention_dim == text_cfg.hidden_size == 1024


def test_cli_pnp_stages_on_cpu(tmp_path):
    """The CLI's stages on a tiny CPU bundle with PnP: the inversion writes
    the latents of every timestep, the generation reads them back as the
    source table; without them it refuses to start."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli

    cfg = _config()
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"), n_frames=8)
    cfg.inversion["save_path"] = str(tmp_path / "latents")
    cfg.generation.update(latents_path=str(tmp_path / "latents"),
                          output_path=str(tmp_path / "out"),
                          frame_range=[8], save_frame=True)
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg.inversion["save_intermediate"] = False
    cli.run_inversion(cfg, bundle)
    with pytest.raises(FileNotFoundError, match="every generation timestep"):
        cli.run_generation(cfg, bundle)
    cfg.inversion.update(save_intermediate=True, force=True)
    cli.run_inversion(cfg, bundle)
    out = cli.run_generation(cfg, bundle)
    assert out["edit"].shape == (8, 64, 64, 3)
    assert (tmp_path / "out" / "edit" / "frames" / "0007.png").exists()
