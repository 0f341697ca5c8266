"""LoRA merge-on-load (``use_lora: true``) and the safetensors reader of the
port, against the JAX package and the ``safetensors`` package, on the CPU.

* the kohya name splitting (``_kohya_to_dotted``) on one name of each
  module kind, and the pair collection on kohya and peft state dicts, equal
  to the JAX package's;
* the merged UNet and text-encoder weights of the tiny stack against JAX's
  ``merge_lora_state`` / ``merge_lora_text_state`` (its HWIO / [in, out]
  kernels carried back by ``convert.from_jax_params``), to atol 1e-6, with
  the same merged and skipped modules;
* the generation slice with ``use_lora: true`` against the JAX generator
  from the same inversion latents (the repo's 35 dB floor; 60 dB, the bar
  of a generation from identical latents), and the int8 table built from
  the merged weights;
* the port's safetensors reader and writer against
  ``safetensors.numpy.load_file`` / ``safetensors.torch.load_file`` on F32,
  F16 and BF16 files.
"""

from __future__ import annotations

import copy
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from tests.torch_parity import (jax_draw_table, port_bundle_from_jax, psnr,
                                to_np)
from vidtome_torch.io import safetensors as t_st
from vidtome_torch.models import convert
from vidtome_torch.models import lora as t_lora
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_tpu.config import Config
from vidtome_tpu.models import lora as j_lora

torch.set_num_threads(2)

STEPS = 8
N_FRAMES = 8
PSNR_FLOOR = 35.0
PSNR_SLICE = 60.0
PROMPT = "a colorful gradient, pixel art"

# one kohya name of each module kind -> its diffusers path
KOHYA_NAMES = {
    "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q":
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
    "lora_unet_mid_block_attentions_0_transformer_blocks_0_attn2_to_out_0":
        "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "lora_unet_up_blocks_1_attentions_2_transformer_blocks_0_ff_net_0_proj":
        "up_blocks.1.attentions.2.transformer_blocks.0.ff.net.0.proj",
    "lora_unet_up_blocks_1_attentions_2_transformer_blocks_0_ff_net_2":
        "up_blocks.1.attentions.2.transformer_blocks.0.ff.net.2",
    "lora_unet_down_blocks_1_attentions_1_proj_in":
        "down_blocks.1.attentions.1.proj_in",
    "lora_unet_up_blocks_3_attentions_0_proj_out":
        "up_blocks.3.attentions.0.proj_out",
    "lora_unet_down_blocks_2_resnets_1_time_emb_proj":
        "down_blocks.2.resnets.1.time_emb_proj",
    "lora_unet_up_blocks_0_resnets_2_conv1":
        "up_blocks.0.resnets.2.conv1",
    "lora_unet_up_blocks_0_resnets_0_conv_shortcut":
        "up_blocks.0.resnets.0.conv_shortcut",
    "lora_unet_down_blocks_0_downsamplers_0_conv":
        "down_blocks.0.downsamplers.0.conv",
    "lora_unet_up_blocks_2_upsamplers_0_conv":
        "up_blocks.2.upsamplers.0.conv",
}
KOHYA_TE_NAMES = {
    "text_model_encoder_layers_11_self_attn_q_proj":
        "text_model.encoder.layers.11.self_attn.q_proj",
    "text_model_encoder_layers_0_self_attn_out_proj":
        "text_model.encoder.layers.0.self_attn.out_proj",
    "text_model_encoder_layers_3_mlp_fc2":
        "text_model.encoder.layers.3.mlp.fc2",
}


def config(**generation):
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4},
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.6,
            "global_rand": 0.5, "align_batch": True, "share_match": True,
            "len_quantum": 1024, **generation},
    })


def kohya_lora(unet: nn.Module, text: nn.Module, seed: int = 0,
               rank: int = 4, alpha: float = 2.0) -> dict[str, np.ndarray]:
    """A kohya LoRA over every Linear and conv of ``unet`` and ``text``
    (fp32, from a numpy seed): names the mapping cannot place are skipped
    by both packages alike."""
    rng = np.random.default_rng(seed)
    state = {}
    for prefix, root in (("lora_unet_", unet), ("lora_te_", text)):
        for name, mod in root.named_modules():
            if not isinstance(mod, (nn.Linear, nn.Conv2d)):
                continue
            base = prefix + name.replace(".", "_")
            w = mod.weight
            if w.ndim == 4:
                down = (rank, w.shape[1], w.shape[2], w.shape[3])
                up = (w.shape[0], rank, 1, 1)
            else:
                down, up = (rank, w.shape[1]), (w.shape[0], rank)
            state[f"{base}.lora_down.weight"] = (
                0.1 * rng.standard_normal(down)).astype(np.float32)
            state[f"{base}.lora_up.weight"] = (
                0.1 * rng.standard_normal(up)).astype(np.float32)
            state[f"{base}.alpha"] = np.asarray(alpha, np.float32)
    return state


def peft_lora(kohya: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The same adapters under diffusers / peft names."""
    out = {}
    for key, value in kohya.items():
        base, leaf = key.split(".", 1)
        if leaf == "alpha":
            continue
        if base.startswith("lora_unet_"):
            dotted = "unet." + t_lora._kohya_to_dotted(base)
        else:
            dotted = "text_encoder." + t_lora._kohya_to_dotted(
                base[len("lora_te_"):], t_lora._TE_MODS)
        ab = "lora_A" if leaf == "lora_down.weight" else "lora_B"
        out[f"{dotted}.{ab}.weight"] = value
    return out


@pytest.fixture(scope="module")
def bundles():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    return jb, port_bundle_from_jax(jb)


@pytest.mark.parametrize("name", list(KOHYA_NAMES))
def test_kohya_unet_names(name):
    assert t_lora._kohya_to_dotted(name) == KOHYA_NAMES[name]
    assert j_lora._kohya_to_dotted(name) == KOHYA_NAMES[name]


@pytest.mark.parametrize("name", list(KOHYA_TE_NAMES))
def test_kohya_text_names(name):
    assert t_lora._kohya_to_dotted(name, t_lora._TE_MODS) == \
        KOHYA_TE_NAMES[name]
    assert t_lora._UNET_MODS == j_lora._UNET_MODS
    assert t_lora._TE_MODS == j_lora._TE_MODS


def _same_pairs(got, want):
    assert set(got) == set(want)
    for space in want:
        assert set(got[space]) == set(want[space]), space
        for dotted, entry in want[space].items():
            assert set(got[space][dotted]) == set(entry), dotted
            for leaf, v in entry.items():
                np.testing.assert_array_equal(
                    np.asarray(got[space][dotted][leaf]), np.asarray(v))


@pytest.mark.parametrize("fmt", ["kohya", "peft"])
def test_collect_pairs_matches_jax(bundles, fmt):
    _, tb = bundles
    state = kohya_lora(tb.unet, tb.text_encoder)
    if fmt == "peft":
        state = peft_lora(state)
        state["text_encoder_2.text_model.encoder.layers.0.self_attn.q_proj"
              ".lora_A.weight"] = np.ones((2, 32), np.float32)
        state["base_model.model.conv_in.lora_B.default.weight"] = np.ones(
            (32, 2, 1, 1), np.float32)
    else:
        state["lora_te2_text_model_encoder_layers_0_mlp_fc1.alpha"] = \
            np.asarray(1.0, np.float32)
    got = t_lora._collect_pairs({k: torch.from_numpy(np.asarray(v))
                                 for k, v in state.items()})
    want = j_lora._collect_pairs(state)
    _same_pairs(got, want)
    assert got["te2"] and got["unet"] and got["te"]


def _merged_state(jtree, comp):
    tree = jax.tree.map(np.asarray, jax.device_get(jtree))
    return convert.from_jax_params(tree, comp)


@pytest.mark.parametrize("fmt", ["kohya", "peft"])
def test_merged_weights_match_jax(bundles, fmt, capsys):
    jb, tb = bundles
    state = kohya_lora(tb.unet, tb.text_encoder, seed=1)
    if fmt == "peft":
        state = peft_lora(state)
    tstate = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    unet, text = copy.deepcopy(tb.unet), copy.deepcopy(tb.text_encoder)
    n_unet = t_lora.merge_lora_state(unet, tstate, scale=0.7)
    n_text = t_lora.merge_lora_text_state(text, tstate, scale=0.7)
    out_t = capsys.readouterr().out
    want_u = _merged_state(j_lora.merge_lora_state(jb.unet_params, state,
                                                   scale=0.7), "unet")
    want_t = _merged_state(j_lora.merge_lora_text_state(
        jb.text_params, state, scale=0.7), "text")
    out_j = capsys.readouterr().out
    # the same modules merged and skipped, by the same messages
    assert [l for l in out_t.splitlines() if "merged" in l] == [
        l for l in out_j.splitlines() if "merged" in l]
    assert n_unet > 20 and n_text == 12  # 2 layers x (q, k, v, out, fc1, fc2)
    moved = 0
    for mod, want in ((unet, want_u), (text, want_t)):
        got = mod.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)
        base = (tb.unet if mod is unet else tb.text_encoder).state_dict()
        moved += sum(not torch.equal(got[k], base[k]) for k in want)
    assert moved == n_unet + n_text


def test_merge_rebuilds_the_scaled_wq():
    """The in-place merge moves the weight's version: the sublayer's cached
    scaled Wq is built anew from the merged weight."""
    from vidtome_torch.models.registry import init_model
    from vidtome_torch.ops.sublayer import _scaled_wq, scaled_wq

    tb = init_model("tiny", weight_dtype="fp32", device="cpu")
    attn = tb.unet.get_submodule("down_blocks.0.attentions.0."
                                 "transformer_blocks.0.attn2.to_q")
    before = scaled_wq(attn.weight, 2).clone()
    state = {"lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_"
             "attn2_to_q.lora_down.weight": torch.ones(1, 32),
             "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_"
             "attn2_to_q.lora_up.weight": torch.ones(32, 1)}
    assert t_lora.merge_lora_state(tb.unet, state) == 1
    after = scaled_wq(attn.weight, 2)
    assert not torch.equal(before, after)
    assert torch.equal(after, _scaled_wq(attn.weight, 2, torch.bfloat16))


def test_apply_lora_bundle_messages(bundles, tmp_path, capsys):
    _, tb = bundles
    bundle = copy.deepcopy(tb)
    t_lora.apply_lora_bundle(bundle, {})
    assert "no lora.path given" in capsys.readouterr().out
    state = kohya_lora(tb.unet, tb.text_encoder, seed=2)
    state = {k: v for k, v in state.items() if "lora_te_" in k
             or "down_blocks_0" in k}
    state["lora_te2_text_model_encoder_layers_0_mlp_fc1.lora_down.weight"] = \
        np.ones((2, 32), np.float32)
    state["lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight"] = \
        np.ones((3, 3), np.float32)  # a shape the conv cannot take
    path = str(tmp_path / "lora.safetensors")
    t_st.save_file({k: torch.from_numpy(np.asarray(v))
                    for k, v in state.items()}, path)
    t_lora.apply_lora_bundle(bundle, {"path": path, "weight": 0.5})
    out = capsys.readouterr().out
    assert "[INFO] LoRA[unet]: merged" in out and "skipped 1" in out
    assert "[INFO] LoRA[text_encoder]: merged 12 modules" in out
    assert "text_encoder_2 tensors but the model has a single" in out


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file as torch_save

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "scalar": np.asarray(4.0, np.float32),
              "conv": rng.standard_normal((4, 2, 3, 3)).astype(np.float32)}
    np_save(arrays, str(tmp_path / "np.safetensors"),
            metadata={"format": "pt"})
    got = t_st.load_file(str(tmp_path / "np.safetensors"))
    for k, v in arrays.items():
        assert got[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["bf16"] = torch.from_numpy(
        rng.standard_normal((2, 6)).astype(np.float32)).bfloat16()
    torch_save(tensors, str(tmp_path / "pt.safetensors"))
    got = t_st.load_file(str(tmp_path / "pt.safetensors"))
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the port's writer, read back by the package
    t_st.save_file(tensors, str(tmp_path / "port.safetensors"))
    back = torch_load(str(tmp_path / "port.safetensors"))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_component_state_needs_no_safetensors_package(tmp_path, monkeypatch):
    import sys

    comp = tmp_path / "unet"
    comp.mkdir()
    t_st.save_file({"w": torch.ones(2, 2)}, str(comp / "a.safetensors"))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    state = convert.load_component_state(str(tmp_path), "unet")
    assert torch.equal(state["w"], torch.ones(2, 2))


@pytest.fixture(scope="module")
def lora_file(bundles, tmp_path_factory):
    _, tb = bundles
    path = str(tmp_path_factory.mktemp("lora") / "pixel.safetensors")
    t_st.save_file({k: torch.from_numpy(np.asarray(v)) for k, v in
                    kohya_lora(tb.unet, tb.text_encoder, seed=3).items()},
                   path)
    return path


def _jax_latents(jb, cfg, clip, save_dir):
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(clip)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    return np.asarray(jinv.ddim_inversion(lat, conds, None, None, save_dir),
                      np.float32)


def test_lora_generation_matches_jax(bundles, lora_file, capsys, tmp_path):
    import jax.numpy as jnp

    from tests.helpers import make_tiny_bundle
    from tests.test_torch_depth_slice import frames
    from vidtome_tpu.pipeline.generator import Generator as JGen

    cfg = config(use_lora=True, lora={"path": lora_file, "weight": 0.8})
    jb = make_tiny_bundle()
    inv_j = _jax_latents(jb, config(), frames(), str(tmp_path))
    tb = port_bundle_from_jax(jb)  # before the JAX generator merges
    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    clean = jgen.ddim_sample(jnp.asarray(inv_j)[jgen.pad_src],
                             jgen._build_context(PROMPT))
    frames_j = np.asarray(jgen.vae.decode(clean[:N_FRAMES]), np.float32)
    out_j = capsys.readouterr().out

    def port_edit(cfg):
        gen = TGen(tb, cfg)
        gen.configure_frames(N_FRAMES)
        pad = torch.as_tensor(gen.pad_src)
        clean = gen.ddim_sample(
            torch.from_numpy(np.array(inv_j))[pad], gen.context(PROMPT),
            fidx_table=gen.fidx_table(),
            draws=DrawSource(jax_draw_table(123, STEPS, 2, 4, 4)))
        return to_np(gen.vae.decode(clean[:N_FRAMES]))

    plain = port_edit(config())
    frames_t = port_edit(cfg)
    out_t = capsys.readouterr().out
    assert [l for l in out_t.splitlines() if "LoRA[" in l] == [
        l for l in out_j.splitlines() if "LoRA[" in l]
    score = psnr(frames_t, frames_j)
    print(f"LoRA generation (fp32, same inversion latents) PSNR port vs "
          f"JAX: {score:.2f} dB; without the LoRA "
          f"{psnr(plain, frames_j):.2f} dB")
    assert score >= PSNR_SLICE
    assert np.abs(frames_t - plain).max() > 1e-2


def test_int8_table_is_built_after_the_merge(bundles, lora_file):
    """quant: int8 with use_lora: the generation's int8 table quantizes the
    merged weights (its entry equals the quantization of W + delta)."""
    from vidtome_torch.ops.quant import quantize_weight

    _, tb = bundles
    bundle = copy.deepcopy(tb)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k"
    w0 = bundle.unet.get_submodule(name).weight.detach().clone()
    gen = TGen(bundle, config(quant="int8", use_lora=True,
                              lora={"path": lora_file}))
    mod = bundle.unet.get_submodule(name)
    merged = mod.weight.detach()
    assert not torch.equal(merged, w0)
    entry = gen.qt.get(mod)
    q, s = quantize_weight(merged)
    assert torch.equal(entry.weight, q) and torch.equal(entry.scale, s)
    deq = entry.weight.float() * entry.scale.reshape(-1, 1)
    assert (deq - merged).abs().max() < (deq - w0).abs().max()
    # inversion never reads the LoRA: a fresh bundle's inverter is unmerged
    from vidtome_torch.pipeline.inverter import Inverter as TInv

    fresh = copy.deepcopy(tb)
    TInv(fresh, config(use_lora=True, lora={"path": lora_file}))
    assert torch.equal(fresh.unet.get_submodule(name).weight, w0)


def test_second_generator_merges_nothing(bundles, lora_file, capsys):
    """A bundle records its LoRA: a second Generator with the same adapter
    leaves the weights as the first merge made them, and one with another
    scale raises instead of merging a second adapter on top."""
    _, tb = bundles
    bundle = copy.deepcopy(tb)
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    cfg = config(use_lora=True, lora={"path": lora_file, "weight": 0.8})
    TGen(bundle, cfg)
    merged = bundle.unet.get_submodule(name).weight.detach().clone()
    assert not torch.equal(merged, tb.unet.get_submodule(name).weight)
    assert bundle.lora == (os.path.abspath(lora_file), 0.8)
    capsys.readouterr()
    TGen(bundle, cfg)
    assert "already merged" in capsys.readouterr().out
    assert torch.equal(bundle.unet.get_submodule(name).weight, merged)
    with pytest.raises(ValueError, match="needs a fresh bundle"):
        TGen(bundle, config(use_lora=True,
                            lora={"path": lora_file, "weight": 0.5}))
    assert torch.equal(bundle.unet.get_submodule(name).weight, merged)
