"""Native bundles: save a converted model bundle and load it back.

Counterpart of ``vidtome_tpu/models/checkpoint.py``.  Converting a
diffusers-layout checkpoint (``models/convert.py``) reads and renames every
tensor; a native bundle holds the port's own state dicts, so a later run
loads them as they are:

    save_bundle(bundle, "/ckpts/sd15-native")
    bundle = load_bundle("/ckpts/sd15-native")            # onto the card
    bundle = load_bundle("/ckpts/sd15-native", device="cpu")

A bundle is a directory of

  * ``bundle.json``: the JAX package's keys with its value forms
    (``model_key``, ``sd_version``, ``dtype`` as a numpy dtype name,
    ``vae_channels`` [[channels], layers a block], ``vae_scaling``,
    ``random_weights``, ``has_controlnet``, ``has_text2``), then the port's
    own: each module's configuration (``unet_config``, ``text_config``,
    ``text2_config``, ``controlnet_config``), so that any stack the port
    builds loads back (the tiny SDXL stacks of the tests too), and the
    merged LoRA (``lora``: [path, scale] or null);
  * one ``<component>.safetensors`` a module (``unet``, ``vae``, ``text``,
    and where the bundle has them ``text2`` and ``controlnet``), written
    and read by ``io/safetensors.py`` in the dtype the module holds: the
    UNet, the VAE and the ControlNet in the bundle's dtype, the text
    encoders in fp32.

The JAX package's bundles are orbax trees, which this format does not
read: convert the diffusers checkpoint again with
``python -m vidtome_torch.tools.convert_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from vidtome_torch.io.safetensors import load_file, save_file
from vidtome_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from vidtome_torch.models.controlnet import ControlNetModel
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.models.tokenizer import load_tokenizer
from vidtome_torch.models.unet import UNet2DConditionModel, UNetConfig
from vidtome_torch.models.vae import AutoencoderKL

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _modules(bundle: ModelBundle) -> dict:
    mods = {"unet": bundle.unet, "vae": bundle.vae,
            "text": bundle.text_encoder, "text2": bundle.text_encoder_2,
            "controlnet": bundle.controlnet}
    return {k: m for k, m in mods.items() if m is not None}


def _config_dict(cfg) -> dict | None:
    return None if cfg is None else dataclasses.asdict(cfg)


def _config(cls, d: dict):
    """A frozen config from its JSON form (lists back to tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


def save_bundle(bundle: ModelBundle, path: str) -> None:
    """Write ``bundle`` as a native bundle under ``path`` (created);
    ``bundle.json`` last, so a directory that holds it is complete."""
    os.makedirs(path, exist_ok=True)
    vae = bundle.vae
    meta = {
        "model_key": bundle.model_key,
        "sd_version": bundle.sd_version,
        "dtype": _DTYPE_NAMES[bundle.dtype],
        "vae_channels": [list(vae.block_out_channels), vae.layers_per_block],
        "vae_scaling": vae.scaling_factor,
        "random_weights": bool(bundle.random_weights),
        "has_controlnet": bundle.controlnet is not None,
        "has_text2": bundle.text_encoder_2 is not None,
        "unet_config": _config_dict(bundle.unet.config),
        "text_config": _config_dict(bundle.text_encoder.cfg),
        "text2_config": _config_dict(
            bundle.text_encoder_2.cfg if bundle.text_encoder_2 else None),
        "controlnet_config": _config_dict(
            bundle.controlnet.config if bundle.controlnet else None),
        "lora": list(bundle.lora) if bundle.lora else None,
    }
    for name, mod in _modules(bundle).items():
        save_file(mod.state_dict(), os.path.join(path, f"{name}.safetensors"))
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _load_module(make, dtype: torch.dtype, path: str, name: str,
                 device: torch.device) -> torch.nn.Module:
    """Build the module on the meta device, take the file's tensors as its
    parameters (strictly: every name, every shape), then move it to
    ``device`` in ``dtype``."""
    with torch.device("meta"):
        mod = make()
    mod.load_state_dict(load_file(os.path.join(path, f"{name}.safetensors")),
                        strict=True, assign=True)
    return mod.to(device, dtype).eval()


def load_bundle(path: str, tokenizer_dir: str | None = None,
                device: str | torch.device = "cuda") -> ModelBundle:
    """The bundle saved under ``path``, every tensor on ``device`` (the
    card unless the caller asks for another); the tokenizer from
    ``tokenizer_dir`` (a checkpoint's ``tokenizer/``), else the hash
    tokenizer at the text encoder's vocabulary and length."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_bundle: no CUDA device; pass device='cpu' "
                           "to load the bundle onto the CPU")
    with open(os.path.join(path, "bundle.json")) as f:
        meta = json.load(f)
    dtype = _DTYPES[meta["dtype"]]
    unet_cfg = _config(UNetConfig, meta["unet_config"])
    text_cfg = _config(CLIPTextConfig, meta["text_config"])
    chans, layers = meta["vae_channels"]
    load = dict(path=path, device=device)
    text2 = controlnet = None
    if meta["has_text2"]:
        text2_cfg = _config(CLIPTextConfig, meta["text2_config"])
        text2 = _load_module(lambda: CLIPTextModel(text2_cfg), torch.float32,
                             name="text2", **load)
    if meta["has_controlnet"]:
        cn_cfg = _config(UNetConfig, meta["controlnet_config"])
        controlnet = _load_module(lambda: ControlNetModel(cn_cfg), dtype,
                                  name="controlnet", **load)
    bundle = ModelBundle(
        model_key=meta["model_key"], sd_version=meta["sd_version"],
        unet=_load_module(lambda: UNet2DConditionModel(unet_cfg), dtype,
                          name="unet", **load),
        vae=_load_module(lambda: AutoencoderKL(
            chans, layers, scaling_factor=meta["vae_scaling"]), dtype,
            name="vae", **load),
        text_encoder=_load_module(lambda: CLIPTextModel(text_cfg),
                                  torch.float32, name="text", **load),
        tokenizer=load_tokenizer(tokenizer_dir,
                                 vocab_size=text_cfg.vocab_size,
                                 max_length=text_cfg.max_positions),
        dtype=dtype, device=device, controlnet=controlnet,
        text_encoder_2=text2, random_weights=meta["random_weights"])
    if meta.get("lora"):
        bundle.lora = tuple(meta["lora"])
    return bundle
