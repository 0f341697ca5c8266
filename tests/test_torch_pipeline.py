"""The port's slice as a whole vs the JAX package: a tiny invert -> generate
(8 frames at 64x64, 2 chunks, local and global merging on, 2 DDIM steps
each way) with the same weights, chunk schedule and merge draws.

Inverted latents must agree to fp32 noise (atol 1e-4).  Frames are compared
by PSNR against the repo's 35 dB floor (BASELINE.md); merging decisions
taken on values within fp32 noise of each other may differ between the two
frameworks, which the PSNR floor absorbs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_draw_table, port_bundle_from_jax, psnr, to_np
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config

torch.set_num_threads(2)

STEPS = 2
N_FRAMES = 8
PSNR_FLOOR = 35.0


def _config():
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused",
        "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4},
        "generation": {
            "control": "none", "guidance_scale": 7.5,
            "n_timesteps": STEPS, "negative_prompt": "blurry",
            "prompt": {"edit": "a colorful gradient, oil painting"},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "align_batch": True, "share_match": True, "len_quantum": 1024},
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


def test_invert_generate_matches_jax(tmp_path):
    from tests.helpers import make_tiny_bundle
    from vidtome_tpu.pipeline.generator import Generator as JGen
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    cfg, frames = _config(), _frames()
    jb = make_tiny_bundle()
    tb = port_bundle_from_jax(jb)
    prompt = cfg.generation.prompt["edit"]

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    inv_j = np.asarray(jinv.ddim_inversion(lat, conds, None, None,
                                           str(tmp_path)))
    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    clean_j = jgen.ddim_sample(inv_j[jgen.pad_src], jgen._build_context(prompt))
    frames_j = np.asarray(jgen.vae.decode(clean_j[:N_FRAMES]))

    inv_t, _ = TInv(tb, cfg)(frames)
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    tgen = TGen(tb, cfg)
    tgen.configure_frames(N_FRAMES)
    table = tgen.fidx_table()
    draws = DrawSource(jax_draw_table(123, STEPS, table.shape[1], 4, 4))
    clean_t = tgen.ddim_sample(inv_t[torch.as_tensor(tgen.pad_src)],
                               tgen.text.embed_cfg(prompt, "blurry"),
                               fidx_table=table, draws=draws)
    frames_t = to_np(tgen.vae.decode(clean_t[:N_FRAMES]))

    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"slice PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR


def test_cli_stages_on_cpu(tmp_path, monkeypatch):
    """The CLI's stages on a tiny CPU bundle: invert a frame folder, cache
    the latents, edit, write the video; the openpose control without a pose
    model fails at construction, as in the JAX package."""
    from tests.helpers import make_tiny_video
    from vidtome_torch import cli
    from vidtome_torch.models.registry import init_model

    cfg = _config()
    cfg["input_path"] = make_tiny_video(str(tmp_path / "video"), n_frames=8)
    cfg.inversion["save_path"] = str(tmp_path / "latents")
    cfg.generation.update(latents_path=str(tmp_path / "latents"),
                          output_path=str(tmp_path / "out"),
                          frame_range=[8], save_frame=True)
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    inverted = cli.run_inversion(cfg, bundle)
    assert inverted.shape == (8, 8, 8, 4)
    assert cli.run_inversion(cfg, bundle) is None  # cached latents reused
    out = cli.run_generation(cfg, bundle)
    assert out["edit"].shape == (8, 64, 64, 3)
    assert (tmp_path / "out" / "edit" / "frames" / "0007.png").exists()
    cfg.generation["control"] = "openpose"
    monkeypatch.delenv("VIDTOME_POSE_MODEL", raising=False)
    with pytest.raises(RuntimeError, match="VIDTOME_POSE_MODEL"):
        cli.run_generation(cfg, bundle)
