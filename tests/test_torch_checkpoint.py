"""Native bundles of the port (``vidtome_torch/models/checkpoint.py``)
against the JAX package's (``vidtome_tpu/models/checkpoint.py``).

- Round trip: ``save_bundle`` then ``load_bundle`` of the tiny stack (with
  a ControlNet; fp32 and bf16), a tiny SD2-depth stack (5 UNet input
  channels), the tiny SDXL stack (two encoders) and the tiny refiner gives
  every tensor back in its dtype and bits, the same configurations and
  metadata, and the same UNet output bit for bit.
- Metadata: ``bundle.json`` carries the JAX file's keys, with the JAX
  values where both packages define them, for one diffusers-layout
  checkpoint converted by both.
- Parity: that checkpoint (the UNet of ``tests/test_convert_golden.py``'s
  ``build_tiny_unet_state``, the VAE and text encoder in diffusers names)
  through ``init_model`` + save + load in each package gives the same
  UNet output in fp32, within 1e-5 of max |ref|.
- ``allow_random_weights=False`` raises the JAX package's error, and the
  converter tool (``vidtome_torch.tools.convert_checkpoint``) writes the
  bundle ``init_model`` reads from the checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtome_torch.io.safetensors import save_file
from vidtome_torch.models.checkpoint import load_bundle, save_bundle
from vidtome_torch.models.clip_text import TINY_TEXT_2, CLIPTextModel
from vidtome_torch.models.registry import init_model, init_random_
from vidtome_torch.models.unet import (TINY_SDXL_UNET, TINY_UNET,
                                       UNet2DConditionModel)
from vidtome_torch.models.vae import AutoencoderKL

torch.set_num_threads(2)

JAX_KEYS = ("model_key", "sd_version", "dtype", "vae_channels",
            "vae_scaling", "random_weights", "has_controlnet", "has_text2")


def _random(module, seed):
    init_random_(module, torch.Generator().manual_seed(seed))
    return module.eval()


def _stack(kind: str, dtype: str = "fp32"):
    """The port's tiny stacks on the CPU: tiny (+ a canny ControlNet),
    SD2-depth's (the tiny UNet with 5 input channels), SDXL's (the tiny XL
    UNet, two encoders, VAE scaling 0.13025) and the tiny refiner."""
    if kind == "refiner":
        return init_model("tiny-refiner", weight_dtype=dtype, device="cpu")
    b = init_model("tiny", weight_dtype=dtype, device="cpu",
                   control="canny" if kind == "tiny" else "none")
    if kind == "depth":
        b.unet = _random(UNet2DConditionModel(
            dataclasses.replace(TINY_UNET, in_channels=5)), 0).to(b.dtype)
        b.sd_version = "depth"
    elif kind == "xl":
        b.unet = _random(UNet2DConditionModel(dataclasses.replace(
            TINY_SDXL_UNET, cross_attention_dim=48)), 0).to(b.dtype)
        b.vae = _random(AutoencoderKL((8, 8, 8, 8), 1,
                                      scaling_factor=0.13025), 1).to(b.dtype)
        b.text_encoder_2 = _random(CLIPTextModel(TINY_TEXT_2), 3)
        b.sd_version, b.model_key = "xl", "tiny-xl"
    return b


def _unet_args(unet, seed: int = 0):
    cfg = unet.config
    rng = np.random.default_rng(seed)
    dtype = next(unet.parameters()).dtype
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, cfg.in_channels))
                         .astype(np.float32)).to(dtype)
    ctx = torch.from_numpy(rng.normal(size=(2, 16, cfg.cross_attention_dim))
                           .astype(np.float32)).to(dtype)
    kw = {}
    if cfg.addition_embed:
        kw = dict(add_text_embeds=torch.from_numpy(rng.normal(
            size=(2, cfg.addition_pooled_dim)).astype(np.float32)),
            add_time_ids=torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]
                                      * 2)[:, :cfg.addition_num_time_ids])
    return (x, 421, ctx), kw


def _modules(b):
    return {"unet": b.unet, "vae": b.vae, "text": b.text_encoder,
            "text2": b.text_encoder_2, "controlnet": b.controlnet}


@pytest.mark.parametrize("kind,dtype", [("tiny", "fp32"), ("tiny", "bf16"),
                                        ("depth", "fp32"), ("xl", "fp32"),
                                        ("refiner", "bf16")])
def test_round_trip_gives_equal_tensors(tmp_path, kind, dtype):
    b = _stack(kind, dtype)
    save_bundle(b, str(tmp_path / "b"))
    back = load_bundle(str(tmp_path / "b"), device="cpu")
    assert (back.model_key, back.sd_version, back.dtype, back.device,
            back.random_weights) == (b.model_key, b.sd_version, b.dtype,
                                     torch.device("cpu"), True)
    assert back.vae_scaling == b.vae_scaling
    for name, mod in _modules(b).items():
        got = _modules(back)[name]
        if mod is None:
            assert got is None
            continue
        assert type(got) is type(mod)
        sa, sb = mod.state_dict(), got.state_dict()
        assert sa.keys() == sb.keys(), name
        for k in sa:
            assert sb[k].dtype == sa[k].dtype, (name, k)
            assert torch.equal(sb[k], sa[k]), (name, k)
    assert back.unet.config == b.unet.config
    assert back.text_encoder.cfg == b.text_encoder.cfg
    np.testing.assert_array_equal(back.tokenizer(["a prompt"]),
                                  b.tokenizer(["a prompt"]))
    args, kw = _unet_args(b.unet)
    with torch.no_grad():
        assert torch.equal(back.unet(*args, **kw), b.unet(*args, **kw))


def test_load_refuses_a_missing_card(tmp_path):
    save_bundle(_stack("refiner"), str(tmp_path / "b"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_bundle(str(tmp_path / "b"))


@pytest.fixture(scope="module")
def diffusers_dir(tmp_path_factory):
    """A diffusers-layout tiny checkpoint: the golden UNet state, and the
    port's random tiny VAE and text encoder under their diffusers names."""
    from tests.test_convert_golden import build_tiny_unet_state

    root = tmp_path_factory.mktemp("sd-tiny-diffusers")
    tiny = init_model("tiny", weight_dtype="fp32", device="cpu")
    parts = {"unet": {k: torch.from_numpy(np.asarray(v))
                      for k, v in build_tiny_unet_state().items()},
             "vae": tiny.vae.state_dict(),
             "text_encoder": tiny.text_encoder.state_dict()}
    for sub, state in parts.items():
        os.makedirs(root / sub)
        save_file(state, str(root / sub / "model.safetensors"))
    return str(root)


@pytest.fixture(scope="module")
def both_bundles(diffusers_dir, tmp_path_factory):
    """The checkpoint through each package's init_model, save and load."""
    from vidtome_tpu.models.checkpoint import load_bundle as j_load
    from vidtome_tpu.models.checkpoint import save_bundle as j_save
    from vidtome_tpu.models.registry import init_model as j_init

    out = tmp_path_factory.mktemp("native")
    jb = j_init("tiny", model_key=diffusers_dir, weight_dtype="fp32")
    j_save(jb, str(out / "jax"))
    tb = init_model("tiny", model_key=diffusers_dir, weight_dtype="fp32",
                    device="cpu")
    save_bundle(tb, str(out / "port"))
    return (j_load(str(out / "jax")), load_bundle(str(out / "port"),
                                                  device="cpu"), out)


def test_metadata_carries_the_jax_keys(both_bundles):
    *_, out = both_bundles
    with open(out / "jax" / "bundle.json") as f:
        want = json.load(f)
    with open(out / "port" / "bundle.json") as f:
        got = json.load(f)
    assert set(JAX_KEYS) == set(want) <= set(got)
    for k in JAX_KEYS:
        assert got[k] == want[k], k
    assert got["random_weights"] is False and got["dtype"] == "float32"


def test_unet_output_matches_jax(both_bundles):
    from vidtome_tpu.models.unet import UNet2DConditionModel as JUNet

    jb, tb, _ = both_bundles
    (x, t, ctx), _ = _unet_args(tb.unet, seed=3)
    ref = np.asarray(JUNet(config=jb.unet_config, dtype=jnp.float32).apply(
        {"params": jb.unet_params}, jnp.asarray(x.numpy()), jnp.asarray(t),
        jnp.asarray(ctx.numpy())))
    with torch.no_grad():
        got = tb.unet(x, t, ctx).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("missing", [None, "no-such-dir"])
def test_no_random_weights_raises_like_jax(tmp_path, missing):
    from vidtome_tpu.models.registry import init_model as j_init

    key = None if missing is None else str(tmp_path / missing)
    with pytest.raises(FileNotFoundError) as want:
        j_init("tiny", model_key=key, weight_dtype="fp32",
               allow_random_weights=False)
    with pytest.raises(FileNotFoundError) as got:
        init_model("tiny", model_key=key, weight_dtype="fp32", device="cpu",
                   allow_random_weights=False)
    assert str(got.value) == str(want.value)


def test_convert_checkpoint_tool(diffusers_dir, tmp_path):
    from vidtome_torch.tools import convert_checkpoint

    convert_checkpoint.main(["--src", diffusers_dir, "--dst",
                             str(tmp_path / "b"), "--sd-version", "tiny",
                             "--dtype", "fp32", "--device", "cpu"])
    back = load_bundle(str(tmp_path / "b"), device="cpu")
    ref = init_model("tiny", model_key=diffusers_dir, weight_dtype="fp32",
                     device="cpu")
    assert back.random_weights is False and back.model_key == diffusers_dir
    for k, v in ref.unet.state_dict().items():
        assert torch.equal(back.unet.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError, match="checkpoint dir not found"):
        convert_checkpoint.main(["--src", str(tmp_path / "none"), "--dst",
                                 str(tmp_path / "c"), "--sd-version", "tiny",
                                 "--device", "cpu"])
