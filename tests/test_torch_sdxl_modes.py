"""int8 (W8A8), PnP and LoRA on SDXL and its refiner: the port vs the JAX
package, on the CPU.

The stacks are those of ``tests/test_torch_sdxl.py``: the tiny SDXL base
of ``tests/test_pipeline_xl.py`` and the JAX ``init_model
("tiny-refiner")``, carried into the port by
``tests/torch_parity.port_bundle_from_jax`` / ``load_jax_weights``; 8
frames at 64x64, 6+6 DDIM steps, local and global merging in 2 chunks, the
refiner from step 4, the JAX package's merge draws, fp32.

* int8: inversion and the two-stage generation with ``quant: int8`` in
  both stages, the generation from the JAX package's int8 inversion
  latents at guidance 1.0 and without merging, the port's resnet blocks
  unfused and fused (the W8A8 block's plain version); the frames to the
  repo's 35 dB floor (BASELINE.md), the inversion to a mean |error| of
  0.1.  int8 rounding turns fp32 noise into whole quantization steps
  (as ``tests/test_torch_int8_slice.py`` found), and near-tie token
  matchings amplify the flips: with merging, the JAX package's own int8
  two-stage run from its inversion latents plus 1e-6 noise agrees with
  itself to 35.8 dB and the port with it to 34.6; without merging 38.7
  and 39.6 dB.  Merging is held by the fp32 slices.  The int8 tables of
  base and refiner quantize the tensors JAX ``quantize_params`` does, bit
  for bit.
* PnP: fp32, with and without the refiner (which runs ``control: none``),
  from the JAX package's saved inversion latents (the port's own within
  atol 1e-4 of them), to 60 dB, the bar of a generation from identical
  latents (the repo's 35 dB floor below it).
* LoRA: one synthetic file over every dense layer and conv of the UNet and
  both text encoders, in kohya and in diffusers form: the merged counts
  per namespace equal to JAX's, the merged (context, pooled) to atol
  1e-5 and a UNet call to 1e-4; on the refiner bundle (one bigG-style
  encoder) the same merged, skipped and warned lines as JAX's.
"""

from __future__ import annotations

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_sdxl import bundles  # noqa: F401 (a fixture)
from tests.test_torch_sdxl import (N_FRAMES, PROMPT, REFINER, STEPS, config,
                                   frames, jax_edits, port_sample)
from tests.torch_parity import port_bundle_from_jax, psnr, to_np
from vidtome_torch.io import safetensors as t_st
from vidtome_torch.models import convert
from vidtome_torch.models import lora as t_lora
from vidtome_torch.ops import quant as t_quant
from vidtome_torch.pipeline.common import TextEncoder as TText
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_torch.pipeline.inverter import Inverter as TInv
from vidtome_tpu.config import Config
from vidtome_tpu.io import artifacts

torch.set_num_threads(2)

PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0  # the fp32 generation from identical inversion latents
INT8 = {"quant": "int8", "guidance_scale": 1.0, "local_merge_ratio": 0.0,
        "merge_global": False}
PNP = {"control": "pnp", "pnp_attn_t": 0.5, "pnp_f_t": 0.8}


def mode_config(inversion: dict | None = None, **generation) -> Config:
    cfg = config(**generation)
    cfg.inversion.update(inversion or {})
    return cfg


def jax_invert(jb, cfg, save_dir: str) -> np.ndarray:
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames())
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    return np.asarray(jinv.ddim_inversion(lat, conds, None, None, save_dir),
                      np.float32)


# ---------------------------------------------------------------- int8


@pytest.fixture(scope="module")
def int8_run(bundles, tmp_path_factory):
    """The JAX package's int8 inversion and two-stage int8 generation."""
    jb, _ = bundles
    cfg = mode_config({"quant": "int8"}, refiner=REFINER, **INT8)
    inv = jax_invert(jb, cfg, str(tmp_path_factory.mktemp("int8")))
    return inv, jax_edits(jb, cfg, inv, base=False)["two_stage"]


@pytest.mark.parametrize("version", ["xl", "tiny-refiner"])
def test_int8_tables_match_jax(bundles, version):
    """The policy quantizes the same tensors on both sides: names, int8
    weights, weight scales and static activation scales."""
    from vidtome_tpu.ops import quant as j_quant

    jb = bundles[0] if version == "xl" else bundles[1]
    tb = port_bundle_from_jax(jb, "tiny" if version == "xl" else version)
    _, qp = j_quant.quantize_params(jb.unet_params)
    want = convert.from_jax_qparams(
        jax_tree_np(qp), tb.unet).entries
    got = t_quant.quantize_unet(tb.unet).entries
    assert t_quant.count_quantized(t_quant.QuantTable(tb.unet, got)) == (
        j_quant.count_quantized(qp)) == len(want)
    assert set(got) == set(want)
    assert not any("add_embedding" in n or "time_emb" in n for n in got)
    assert any(n.endswith("proj_in") for n in got)
    for name, w in want.items():
        g = got[name]
        assert torch.equal(g.weight, w.weight), name
        torch.testing.assert_close(g.scale, w.scale, rtol=1e-6, atol=0)
        assert (g.act_scale is None) == (w.act_scale is None), name
        if w.act_scale is not None:
            torch.testing.assert_close(g.act_scale, w.act_scale, rtol=1e-6,
                                       atol=0)


def jax_tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("version", ["xl", "xl-refiner"])
def test_full_int8_policy_matches_jax(version):
    """At full width, from shapes alone: the port's ``quantizable`` names
    on the UNet built on the meta device are the modules of JAX
    ``quantize_params`` over ``jax.eval_shape`` of the JAX init (675 SDXL,
    451 refiner), and the static activation scales sit on the same ones
    (conv1 / conv2 / proj_in)."""
    from vidtome_torch.models.registry import SD_CONFIGS
    from vidtome_torch.models.unet import UNet2DConditionModel
    from vidtome_tpu.models import unet as j_unet
    from vidtome_tpu.ops import quant as j_quant

    cfg = {"xl": j_unet.SDXL_UNET,
           "xl-refiner": j_unet.SDXL_REFINER_UNET}[version]
    model = j_unet.UNet2DConditionModel(config=cfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda key: model.init(
        key, jnp.zeros((1, 8, 8, 4), jnp.bfloat16), jnp.asarray(0),
        jnp.zeros((1, 8, cfg.cross_attention_dim), jnp.bfloat16),
        add_text_embeds=jnp.zeros((1, cfg.addition_pooled_dim)),
        add_time_ids=jnp.zeros((1, cfg.addition_num_time_ids)))["params"],
        jax.random.key(0))
    qshapes = jax.eval_shape(lambda p: j_quant.quantize_params(p)[1],
                             shapes)
    want, want_static = set(), set()
    for path in convert._flatten(qshapes):
        for pattern, repl in convert._RULES["unet"]:
            path = re.sub(pattern, repl, path)
        module, _, leaf = path.rpartition("/")
        want.add(module.replace("/", "."))
        if leaf == "act_scale":
            want_static.add(module.replace("/", "."))
    with torch.device("meta"):
        unet = UNet2DConditionModel(SD_CONFIGS[version][0])
    names = t_quant.quantizable(unet)
    assert len(names) == len(set(names)) == {"xl": 675,
                                             "xl-refiner": 451}[version]
    assert set(names) == want
    assert set(t_quant._static_scales(unet, names)) == want_static
    assert not any("add_embedding" in n for n in names)


@pytest.mark.parametrize("version", ["xl", "xl-refiner"])
def test_full_int8_products_take_int_mm(version, monkeypatch):
    """Every int8 product of the full UNet at a 128x128 latent (1024p),
    batch 4 (inversion), 8 (CFG) and 12 (PnP), on the meta device, meets
    ``torch._int_mm``'s rule (more than 16 rows, K and N multiples of 8):
    the wrapper raises where it does not."""
    from vidtome_torch.models.registry import SD_CONFIGS
    from vidtome_torch.models.unet import UNet2DConditionModel

    cfg = SD_CONFIGS[version][0]
    products = []
    int_mm = t_quant._int_mm

    def spy(a, b):
        products.append((a.shape[0], a.shape[1], b.shape[1]))
        return int_mm(a, b)

    monkeypatch.setattr(t_quant, "_int_mm", spy)
    with torch.device("meta"), torch.no_grad():
        unet = UNet2DConditionModel(cfg).to(torch.bfloat16)
        qt = t_quant.quantize_unet(unet)
        for B in (4, 8, 12):
            products.clear()
            out = unet(torch.empty(B, 128, 128, 4), 1,
                       torch.empty(B, 77, cfg.cross_attention_dim), qt=qt,
                       add_text_embeds=torch.empty(B, cfg.addition_pooled_dim),
                       add_time_ids=torch.empty(B, cfg.addition_num_time_ids))
            assert out.shape == (B, 128, 128, 4)
            assert len(products) == len(qt)
            assert min(m for m, _, _ in products) == 77 * B
            assert all(k % 8 == 0 and n % 8 == 0 for _, k, n in products)


@pytest.mark.parametrize("resnet_mode", ["off", "fused"])
def test_int8_two_stage_matches_jax(bundles, int8_run, capsys, resnet_mode):
    inv_j, frames_j = int8_run
    tb = port_bundle_from_jax(bundles[0])
    cfg = mode_config({"quant": "int8", "resnet_mode": resnet_mode},
                      refiner=REFINER, resnet_mode=resnet_mode, **INT8)
    tinv = TInv(tb, cfg)
    assert tinv.quant == "int8" and tinv.qt is not None
    inv_t, _ = tinv(frames())
    inv_err = np.abs(to_np(inv_t) - inv_j)
    assert inv_err.mean() < 0.1
    frames_t, gen = port_sample(tb, bundles, cfg, inv_j)
    r = gen.refiner
    assert gen.quant == r.quant == "int8"
    assert r.resnet_mode == gen.resnet_mode == resnet_mode
    assert len(r.qt) > 0 and len(gen.qt) > 0 and r.bundle.is_refiner
    assert "int8 serving (generation): quantized" in capsys.readouterr().out
    assert dict(gen.unet_calls) == {"full": 8}
    assert dict(r.unet_calls) == {"full": 4}
    assert np.isfinite(frames_t).all()
    score = psnr(frames_t, frames_j)
    print(f"SDXL int8 two-stage (resnet {resnet_mode}) PSNR port vs JAX "
          f"(JAX off): {score:.2f} dB; inversion |err| max "
          f"{inv_err.max():.2e}, mean {inv_err.mean():.2e}")
    assert score >= PSNR_FLOOR


# ---------------------------------------------------------------- PnP


@pytest.fixture(scope="module")
def pnp_run(bundles, tmp_path_factory):
    """The JAX package's inversion saving every step's latents, and its
    PnP edits: two-stage and base only."""
    jb, _ = bundles
    save_dir = str(tmp_path_factory.mktemp("pnp"))
    cfg = mode_config({"save_intermediate": True}, refiner=REFINER, **PNP)
    inv = jax_invert(jb, cfg, save_dir)
    return inv, save_dir, jax_edits(jb, cfg, inv, True, save_dir)


def test_pnp_inversion_saves_every_step(bundles, pnp_run):
    inv_j, save_dir, _ = pnp_run
    tb = port_bundle_from_jax(bundles[0])
    tinv = TInv(tb, mode_config({"save_intermediate": True}, **PNP))
    inv_t, _ = tinv(frames())
    np.testing.assert_allclose(to_np(inv_t), inv_j, atol=1e-4, rtol=0)
    timesteps = [int(t) for t in tinv.scheduler.timesteps]
    assert sorted(tinv.saved) == sorted(timesteps)
    for t in timesteps:
        np.testing.assert_allclose(to_np(tinv.saved[t]),
                                   artifacts.load_latent(save_dir, t),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("refiner", [False, True],
                         ids=["base", "two_stage"])
def test_pnp_matches_jax(bundles, pnp_run, refiner):
    """Three lanes (source first) on the base, the source lane fed from the
    saved latents at every step, attention injection on the first 3 steps
    and conv injection on the first 4; the refiner, where there is one,
    runs two lanes."""
    inv_j, save_dir, edits = pnp_run
    tb = port_bundle_from_jax(bundles[0])
    cfg = mode_config(**PNP, **({"refiner": REFINER} if refiner else {}))
    src = {int(t): torch.from_numpy(artifacts.load_latent(save_dir, int(t)))
           for t in TGen(tb, cfg).scheduler.timesteps}
    frames_t, gen = port_sample(tb, bundles, cfg, inv_j, src)
    assert (gen.num_lanes, gen.pnp_attn_steps, gen.pnp_conv_steps) == (3, 3,
                                                                       4)
    assert gen.tome.align_batch
    if refiner:
        r = gen.refiner
        assert r.use_pnp is False and r.num_lanes == 2
        assert dict(gen.unet_calls) == {"full": 8}
        assert dict(r.unet_calls) == {"full": 4}
    else:
        assert dict(gen.unet_calls) == {"full": 2 * STEPS}
    want = edits["two_stage" if refiner else "base"]
    score = psnr(frames_t, want)
    print(f"SDXL PnP ({'two-stage' if refiner else 'base'}) PSNR port vs "
          f"JAX: {score:.2f} dB")
    assert score >= max(PSNR_FLOOR, PSNR_SLICE)


# ---------------------------------------------------------------- LoRA


def sdxl_lora(tb, fmt: str, seed: int = 0, rank: int = 4,
              alpha: float = 2.0) -> dict[str, np.ndarray]:
    """A LoRA over every Linear and conv of the SDXL bundle's UNet and its
    two text encoders (fp32, from a numpy seed), under kohya names
    (``lora_unet_`` / ``lora_te1_`` / ``lora_te2_``) or diffusers ones
    (``unet.`` / ``text_encoder.`` / ``text_encoder_2.``, no alpha)."""
    rng = np.random.default_rng(seed)
    state = {}
    for kohya, diffusers, root in (
            ("lora_unet_", "unet.", tb.unet),
            ("lora_te1_", "text_encoder.", tb.text_encoder),
            ("lora_te2_", "text_encoder_2.", tb.text_encoder_2)):
        for name, mod in root.named_modules():
            if not isinstance(mod, (nn.Linear, nn.Conv2d)):
                continue
            w = mod.weight
            if w.ndim == 4:
                down = (rank, w.shape[1], w.shape[2], w.shape[3])
                up = (w.shape[0], rank, 1, 1)
            else:
                down, up = (rank, w.shape[1]), (w.shape[0], rank)
            down = (0.1 * rng.standard_normal(down)).astype(np.float32)
            up = (0.1 * rng.standard_normal(up)).astype(np.float32)
            if fmt == "kohya":
                base = kohya + name.replace(".", "_")
                state[f"{base}.lora_down.weight"] = down
                state[f"{base}.lora_up.weight"] = up
                state[f"{base}.alpha"] = np.asarray(alpha, np.float32)
            else:
                state[f"{diffusers}{name}.lora_A.weight"] = down
                state[f"{diffusers}{name}.lora_B.weight"] = up
    return state


def lora_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if "LoRA" in ln]


def merge_both(jb, tb, path: str, capsys):
    """The same file merged by both packages' ``apply_lora_bundle`` at
    scale 0.7; returns (JAX bundle, its log lines, the port's lines)."""
    from vidtome_tpu.models import lora as j_lora

    jb = copy.copy(jb)
    capsys.readouterr()
    j_lora.apply_lora_bundle(jb, {"path": path, "weight": 0.7})
    out_j = lora_lines(capsys.readouterr().out)
    t_lora.apply_lora_bundle(tb, {"path": path, "weight": 0.7})
    out_t = lora_lines(capsys.readouterr().out)
    return jb, out_j, out_t


@pytest.mark.parametrize("fmt", ["kohya", "diffusers"])
def test_lora_on_sdxl_matches_jax(bundles, tmp_path, capsys, fmt):
    from vidtome_tpu.models.unet import UNet2DConditionModel as JUNet
    from vidtome_tpu.pipeline.common import TextEncoder as JText

    tb = port_bundle_from_jax(bundles[0])
    path = str(tmp_path / "lora.safetensors")
    state = sdxl_lora(tb, fmt)
    t_st.save_file({k: torch.from_numpy(v) for k, v in state.items()}, path)
    plain = TText(tb)(PROMPT)
    jb, out_j, out_t = merge_both(bundles[0], tb, path, capsys)
    assert out_t == out_j
    merged = {m[1]: int(m[2]) for m in (
        re.search(r"LoRA\[(\w+)\]: merged (\d+) modules", ln)
        for ln in out_t) if m}
    assert set(merged) == {"unet", "text_encoder", "text_encoder_2"}
    assert merged["text_encoder"] == 12  # 2 layers x (q, k, v, out, fc1, fc2)
    assert merged["unet"] > 60 and merged["text_encoder_2"] >= 12
    # the merged encoders: (context, pooled), and both moved
    got, want = TText(tb)(PROMPT), JText(jb)(PROMPT)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5,
                                   rtol=0)
        assert (g - p).abs().max().item() > 1e-3
    # one call of the merged UNet
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    ctx = rng.standard_normal((2, 16, 48), np.float32)
    kw = dict(add_text_embeds=rng.standard_normal((2, 16), np.float32),
              add_time_ids=np.tile(np.float32([64, 64, 0, 0, 64, 64]),
                                   (2, 1)))
    model = JUNet(config=jb.unet_config, dtype=jnp.float32, use_pallas=False)
    want = model.apply({"params": jb.unet_params}, jnp.asarray(x),
                       jnp.asarray(301), jnp.asarray(ctx),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", ["kohya", "diffusers"])
def test_lora_on_the_refiner_matches_jax(bundles, tmp_path, capsys, fmt):
    """The base's LoRA offered to the refiner, as the JAX refiner stage is
    built from a config that keeps use_lora: UNet and text-encoder pairs
    merged where the names and shapes fit and skipped where not, the te2
    pairs warned about (one encoder); the same lines as the JAX package's."""
    tb = port_bundle_from_jax(bundles[0])
    path = str(tmp_path / "lora.safetensors")
    state = sdxl_lora(tb, fmt, seed=1)
    t_st.save_file({k: torch.from_numpy(v) for k, v in state.items()}, path)
    tr = port_bundle_from_jax(bundles[1], "tiny-refiner")
    assert tr.text_encoder_2 is None
    _, out_j, out_t = merge_both(bundles[1], tr, path, capsys)
    print("\n".join(out_t))
    assert out_t == out_j
    assert any("skipped" in ln for ln in out_t)
    assert out_t[-1] == ("[WARNING] LoRA has text_encoder_2 tensors but the "
                         "model has a single text encoder — skipped")


def test_refiner_generator_takes_the_lora(bundles, tmp_path, capsys):
    """A Generator with use_lora and a refiner merges the adapter into both
    bundles, each once."""
    tb = port_bundle_from_jax(bundles[0])
    path = str(tmp_path / "lora.safetensors")
    t_st.save_file({k: torch.from_numpy(v)
                    for k, v in sdxl_lora(tb, "kohya").items()}, path)
    cfg = mode_config(refiner=REFINER, use_lora=True,
                      lora={"path": path, "weight": 0.5})
    gen = TGen(tb, cfg)
    out = capsys.readouterr().out
    assert tb.lora is not None and gen.refiner.bundle.lora == tb.lora
    assert out.count("LoRA[text_encoder_2]: merged") == 1
    assert "text_encoder_2 tensors but the model has a single" in out
