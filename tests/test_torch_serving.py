"""The serving profile on the port vs the JAX package, on the CPU.

* The slice as a whole: a tiny invert -> generate (8 frames at 64x64, 2
  chunks, local and global merging, 8+8 DDIM steps) with every serving
  cache on, as ``configs/serve.yaml`` turns them on but with schedules
  short enough to hit every kind of step in 8: full and shallow UNet
  calls, CFG-skip calls and eps-skip steps in generation (quadratic
  extrapolation), shallow and eps-skip steps in inversion (linear), and an
  eps schedule that the deep / CFG refreshes force upward in both stages.
  Same weights, chunk schedule and merge draws as the JAX package: the mode
  tables must be equal, the inverted latents agree to atol 1e-4 (fp32
  noise), the frames reach the repo's 35 dB PSNR floor (BASELINE.md).
  ``resnet_mode: fused`` runs the port's fused block (its plain version on
  the CPU) where the JAX package, on the CPU in fp32, takes its unfused one.
* Every interval 1 and ``resnet_mode: off``: the port's serving path is
  bit-equal to its exact path.
* ``configs/serve.yaml`` builds both stages (with ``quant: int8`` too, as
  ``bench.py``'s int8 profiles run it); the options still unported are
  refused, and the JAX package's refusals of PnP with the step caches are
  kept.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_draw_table, port_bundle_from_jax, psnr, to_np
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config, load_config_file

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
# The two packages agree to fp32 noise on this slice (104.73 dB): a
# second, tighter bar catches a wrong cache formula that the repo's floor
# would let through (eps = cond + gs * delta on CFG-skip steps scores 41 dB).
PSNR_SLICE = 60.0
PROMPT = "a colorful gradient, oil painting"


def _config(inversion=None, generation=None):
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4,
                      **(inversion or {})},
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "align_batch": True, "share_match": True, "len_quantum": 1024,
            **(generation or {})},
    })


# deep refresh [1,1,1,0,0,1,0,0] and eps run [1,1,1,1,0,0,1,0]: step 5's
# deep refresh forces an eps run there (the auto-alignment)
SERVING = _config(
    inversion={"cache_schedule": "full:2,uniform:3",
               "eps_schedule": "full:3,uniform:3", "eps_extrapolate": True,
               "resnet_mode": "fused"},
    generation={"cache_schedule": "full:2,uniform:3",
                "cfg_schedule": "full:2,uniform:3",
                "eps_schedule": "full:3,uniform:3", "eps_extrapolate": 2,
                "resnet_mode": "fused"})


def _frames():
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    out = []
    for i in range(N_FRAMES):
        ph = i / N_FRAMES
        out.append(np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (xx + ph)),
                             0.5 + 0.5 * np.cos(2 * np.pi * (yy + ph / 2)),
                             np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def _port_edit(bundle, cfg, frames, draws_from_jax=True):
    """Invert and edit on the port; returns (inverted, frames, inverter,
    generator)."""
    inv = TInv(bundle, cfg)
    inverted, _ = inv(frames)
    gen = TGen(bundle, cfg)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    draws = (DrawSource(jax_draw_table(123, STEPS, table.shape[1], 4, 4))
             if draws_from_jax else None)
    clean = gen.ddim_sample(inverted[torch.as_tensor(gen.pad_src)],
                            gen.text.embed_cfg(PROMPT, "blurry"),
                            fidx_table=table, draws=draws)
    return inverted, gen.vae.decode(clean[:N_FRAMES]), inv, gen


def test_serving_slice_matches_jax(tmp_path, capsys):
    from tests.helpers import make_tiny_bundle
    from vidtome_tpu.pipeline.generator import Generator as JGen
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    cfg, frames = SERVING, _frames()
    jb = make_tiny_bundle()
    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    inv_j = np.asarray(jinv.ddim_inversion(lat, conds, None, None,
                                           str(tmp_path)))
    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    modes_j = np.asarray(jgen._mode_masks()).astype(bool)
    clean_j = jgen.ddim_sample(inv_j[jgen.pad_src],
                               jgen._build_context(PROMPT))
    frames_j = np.asarray(jgen.vae.decode(clean_j[:N_FRAMES]))
    capsys.readouterr()

    inv_t, frames_t, tinv, tgen = _port_edit(port_bundle_from_jax(jb), cfg,
                                             frames)
    assert "auto-aligned" in capsys.readouterr().out  # inversion's warning
    modes = tgen.mode_masks()
    np.testing.assert_array_equal(modes, modes_j)
    deep, cfgm, run = modes.T
    assert run.tolist() == [1, 1, 1, 1, 0, 1, 1, 0]
    chunks = N_FRAMES // 4
    assert dict(tgen.unet_calls) == {
        "full": chunks * int((run & deep).sum()),
        "shallow": chunks * int((run & ~deep).sum()),
        "cfg_skip": chunks * int((run & ~cfgm).sum()),
        "eps_skip": int((~run).sum())} == {
        "full": 8, "shallow": 4, "cfg_skip": 4, "eps_skip": 2}
    # 2 micro-batches a step; deep [1,1,1,0,0,1,0,0], eps-run forced to
    # [1,1,1,1,0,1,1,0]
    assert dict(tinv.unet_calls) == {"full": 8, "shallow": 4, "eps_skip": 2}

    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    frames_t = to_np(frames_t)
    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"serving slice PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_FLOOR
    assert score >= PSNR_SLICE


def test_every_interval_one_is_the_exact_path():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu", seed=3)
    frames = _frames()
    ones = _config(
        inversion={"cache_interval": 1, "eps_interval": 1,
                   "eps_extrapolate": 2, "resnet_mode": "off"},
        generation={"cache_interval": 1, "cfg_interval": 1,
                    "eps_interval": 1, "eps_extrapolate": 1,
                    "resnet_mode": "off"})
    exact_inv, exact, _, _ = _port_edit(bundle, _config(), frames, False)
    inv, out, tinv, tgen = _port_edit(bundle, ones, frames, False)
    assert tgen.cache_on and tgen.cfg_on and tgen.eps_on
    assert tgen.unet_calls["full"] == 2 * STEPS
    assert tinv.unet_calls["full"] == 2 * STEPS
    assert torch.equal(inv, exact_inv)
    assert torch.equal(out, exact)


def _serve_config():
    cfg = load_config_file(str(ROOT / "configs" / "serve.yaml"))
    cfg["generation"]["prompt"] = {"edit": PROMPT}
    return cfg


def test_serve_yaml_builds_both_stages():
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = _serve_config()
    inv, gen = TInv(bundle, cfg), TGen(bundle, cfg)
    assert inv.eps_on and inv.eps_extrapolate == 1 and not inv.cache_on
    assert gen.cache_on and gen.cfg_on and gen.eps_on
    assert (inv.resnet_mode, gen.resnet_mode) == ("off", "fused")
    assert gen.tome.local_merge_ratio == 0.95
    deep, cfgm, run = gen.mode_masks().T
    assert len(run) == 50 and run[:6].all() and not (deep & ~run).any()
    assert not (deep & ~cfgm).any() and not (cfgm & ~run).any()
    assert inv.qt is gen.qt is None
    cfg["generation"]["quant"] = cfg["inversion"]["quant"] = "int8"
    assert len(TGen(bundle, cfg).qt) == len(TInv(bundle, cfg).qt) > 0


@pytest.mark.parametrize("stage,key,value", [
    ("generation", "use_lora", True),
    ("generation", "merge_ff", True),
    ("generation", "chunk_batch", True),
    ("generation", "chunk_boundaries", "ragged"),
    ("inversion", "control", "openpose"),
    ("top", "use_lora", True),
])
def test_serve_yaml_still_refuses_unported(stage, key, value, monkeypatch,
                                          capsys):
    """merge_ff, chunk_batch and ragged chunk boundaries are refused.  What
    the port now runs behaves as in the JAX package: ``use_lora`` in
    generation merges the adapter it names (none here: a warning, and the
    weights stay), the top-level key is not read at all, and
    ``inversion.control: openpose`` without a pose model fails at
    construction."""
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = _serve_config()
    (cfg if stage == "top" else cfg[stage])[key] = value
    cls = TInv if stage == "inversion" else TGen
    if key == "use_lora":
        before = {k: v.clone() for k, v in bundle.unet.state_dict().items()}
        cls(bundle, cfg)
        out = capsys.readouterr().out
        assert ("no lora.path given" in out) == (stage == "generation")
        assert "LoRA[" not in out
        after = bundle.unet.state_dict()  # cast to the stage's precision
        assert all(torch.equal(v.to(after[k].dtype), after[k])
                   for k, v in before.items())
        return
    if key == "control":
        monkeypatch.delenv("VIDTOME_POSE_MODEL", raising=False)
        with pytest.raises(RuntimeError, match="VIDTOME_POSE_MODEL"):
            cls(bundle, cfg)
        return
    with pytest.raises(NotImplementedError, match=key):
        cls(bundle, cfg)


@pytest.mark.parametrize("key", ["cache_interval", "eps_schedule"])
def test_pnp_with_step_caches_raises_like_jax(key):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = copy.deepcopy(_config())
    cfg.generation.update(control="pnp",
                          **{key: 2 if key == "cache_interval" else
                             "full:2,uniform:2"})
    with pytest.raises(ValueError, match="pnp"):
        TGen(bundle, cfg)


@pytest.mark.parametrize("inversion,match", [
    ({"resnet_mode": "measured"}, "resnet_mode"),
    ({"eps_interval": 2, "eps_extrapolate": 3}, "eps_extrapolate"),
])
def test_inverter_rejects_bad_options(inversion, match):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match=match):
        TInv(bundle, _config(inversion=inversion))


@pytest.mark.parametrize("key", ["cache_schedule", "eps_schedule"])
def test_reversed_schedule_must_start_with_a_refresh(key):
    """Reversed, "full:2,uniform:3" begins with a shallow step: the deep
    cache (or eps history) would be read empty.  The inversion is refused;
    unreversed (the reconstruction), the same schedule runs."""
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    inv = TInv(bundle, _config(inversion={key: "full:2,uniform:3",
                                          "cache_reverse": True}))
    with pytest.raises(ValueError, match="first step"):
        inv.step_masks(inversion=True)
    mask, eps_mask = inv.step_masks(inversion=False)
    assert (mask if key == "cache_schedule" else eps_mask)[0]
