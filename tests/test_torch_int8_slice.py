"""The int8 (W8A8) serving slice on the port vs the JAX package, on the CPU.

A tiny invert -> generate (8 frames at 64x64, 2 chunks, local and global
merging, 8+8 DDIM steps) with ``quant: int8`` in both stages and the serving
caches on (deep / CFG / eps, as ``tests/test_torch_serving.py`` turns them
on), in fp32, with the JAX package's weights and merge draws.  Both
packages quantize the same weights at construction; the generation starts
from the JAX package's inversion latents (from the port's own, 1e-5
differences flip near-tie global matchings on random weights, as in
``tests/test_torch_pnp_slice.py``).
Guidance is 1.0: int8 rounding turns fp32 noise into whole quantization
steps (a 1e-6 difference flips the rounding of about one activation in
10^4), and guidance 7.5 amplifies the flips, so that the JAX package's own
int8 run, from its inversion latents plus 1e-6 noise, agrees with itself
only to 23.4 dB (35.0 dB at guidance 1.0; the port against it at 7.5:
31.4 dB).  The same flips spread the int8 inversions: the JAX package's
own, from its clean latents plus 1e-6 noise, moves by up to 0.48 (latents
up to 3.6), and the port's lies as far from it (0.45 at most, 0.056 on
average).  The frames must reach the repo's 35 dB PSNR floor
(BASELINE.md):

* ``resnet_mode: off`` on both sides (XLA's int8 convolutions against the
  port's im2col int8 products);
* the port with ``resnet_mode: fused`` (the W8A8 block's plain version on
  the CPU: activations quantized with the reciprocal of the static scale,
  one dequantization per output) against the JAX package's ``off``.

Also: ``quant`` is parsed per stage with the top-level fallback, unknown
modes raise ValueError as in the JAX package, the bundle's weights stay in
their dtype, and a stage's int8 table changes its output.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_draw_table, port_bundle_from_jax, psnr, to_np
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config

torch.set_num_threads(2)

STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
PROMPT = "a colorful gradient, oil painting"


def _config(resnet_mode="off", **top):
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32", **top,
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4, "quant": "int8",
                      "eps_schedule": "full:3,uniform:3",
                      "eps_extrapolate": True, "resnet_mode": resnet_mode},
        "generation": {
            "control": "none", "guidance_scale": 1.0, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "align_batch": True, "share_match": True, "len_quantum": 1024,
            "quant": "w8a8", "cache_schedule": "full:2,uniform:3",
            "cfg_schedule": "full:2,uniform:3",
            "eps_schedule": "full:3,uniform:3", "eps_extrapolate": 2,
            "resnet_mode": resnet_mode},
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


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's int8 inversion and generation (resnet_mode off),
    and its tiny bundle."""
    from tests.helpers import make_tiny_bundle
    from vidtome_tpu.pipeline.generator import Generator as JGen
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    cfg, frames = _config(), _frames()
    jb = make_tiny_bundle()
    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    inv_j = np.asarray(jinv.ddim_inversion(
        lat, conds, None, None, str(tmp_path_factory.mktemp("latents"))))
    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    clean = jgen.ddim_sample(inv_j[jgen.pad_src], jgen._build_context(PROMPT))
    frames_j = np.asarray(jgen.vae.decode(clean[:N_FRAMES]))
    return jb, frames, inv_j, frames_j


def _port_generate(bundle, cfg, inverted):
    gen = TGen(bundle, cfg)
    gen.configure_frames(N_FRAMES)
    table = gen.fidx_table()
    draws = DrawSource(jax_draw_table(123, STEPS, table.shape[1], 4, 4))
    x0 = torch.from_numpy(np.array(inverted))[torch.as_tensor(gen.pad_src)]
    clean = gen.ddim_sample(x0, gen.text.embed_cfg(PROMPT, "blurry"),
                            fidx_table=table, draws=draws)
    return to_np(gen.vae.decode(clean[:N_FRAMES])), gen


@pytest.mark.parametrize("resnet_mode", ["off", "fused"])
def test_int8_slice_matches_jax(jax_run, capsys, resnet_mode):
    jb, frames, inv_j, frames_j = jax_run
    tb = port_bundle_from_jax(jb)
    cfg = _config(resnet_mode)
    tinv = TInv(tb, cfg)
    assert tinv.quant == "int8" and tinv.qt is not None
    inv_t, _ = tinv(frames)
    inv_err = np.abs(to_np(inv_t) - inv_j)
    assert inv_err.mean() < 0.1
    frames_t, gen = _port_generate(tb, cfg, inv_j)
    out = capsys.readouterr().out
    assert "int8 serving (inversion): quantized" in out
    assert gen.quant == "int8" and gen.resnet_mode == resnet_mode
    assert dict(gen.unet_calls) == {"full": 8, "shallow": 4, "cfg_skip": 4,
                                    "eps_skip": 2}
    assert frames_t.shape == (N_FRAMES, 64, 64, 3)
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"int8 slice (resnet {resnet_mode}) PSNR port vs JAX "
          f"(JAX off): {score:.2f} dB; inversion |err| max {inv_err.max():.2e}, "
          f"mean {inv_err.mean():.2e}")
    assert score >= PSNR_FLOOR
    assert tb.unet.conv_in.weight.dtype == torch.float32  # weights stay


def test_int8_table_changes_the_stage_output():
    """The same bundle serves an int8 stage and a bf16 one: the int8 table
    is per stage, and it changes the UNet's output."""
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu", seed=5)
    exact = copy.deepcopy(_config())
    exact.inversion["quant"] = "none"
    inv_q, inv_f = TInv(bundle, _config()), TInv(bundle, exact)
    assert inv_f.qt is None and len(inv_q.qt) > 0
    x = torch.randn(4, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    ctx = inv_f.text(["a"] * 4)
    with torch.no_grad():
        a = bundle.unet(x, 501, ctx)
        b = bundle.unet(x, 501, ctx, qt=inv_q.qt)
        c = bundle.unet(x, 501, ctx)
    assert torch.equal(a, c)
    assert 1e-4 < (a - b).abs().max().item() < 0.5 * a.abs().max().item()


@pytest.mark.parametrize("where,value,want", [
    ("top", "int8", "int8"), ("top", "W8A8", "int8"), ("stage", False, "none"),
    ("stage", "off", "none"), ("stage", "none", "none")])
def test_quant_parsed_per_stage(where, value, want):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = copy.deepcopy(_config())
    for stage in ("inversion", "generation"):
        cfg[stage].pop("quant")
        if where == "stage":
            cfg[stage]["quant"] = value
    if where == "top":
        cfg["quant"] = value
    assert TInv(bundle, cfg).quant == TGen(bundle, cfg).quant == want


@pytest.mark.parametrize("stage", ["inversion", "generation"])
def test_unknown_quant_mode_raises(stage):
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cfg = copy.deepcopy(_config())
    cfg[stage]["quant"] = "int4"
    with pytest.raises(ValueError, match="quant"):
        (TInv if stage == "inversion" else TGen)(bundle, cfg)
