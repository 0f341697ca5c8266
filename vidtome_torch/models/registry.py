"""Model factory: SD version -> modules with weights on a device.

Counterpart of ``vidtome_tpu/models/registry.py`` for ``"1.5"``,
``"2.1"`` / ``"2.0"`` (one architecture), ``"depth"`` (SD2-depth: SD2.1's
text encoder and VAE, a UNet with a fifth input channel for the depth
latents), ``"xl"`` (SDXL base: two text encoders, ``text_encoder_2`` the
bigG one with the pooled projection, VAE scaling 0.13025),
``"xl-refiner"`` (the SDXL refiner: the bigG encoder alone, read from a
checkpoint's ``text_encoder_2``), ``"tiny"`` and ``"tiny-refiner"``.
``model_key`` names a local checkpoint directory in the standard layout
(unet/ vae/ text_encoder/ [text_encoder_2/] tokenizer/, safetensors);
without one, weights are random (warned), drawn from a seeded
``torch.Generator`` with the flax initializer families the JAX package
uses: truncated ``lecun_normal`` for conv and dense kernels, zero biases,
unit / zero norm scale / bias, ``normal(1/sqrt(width))`` token and
``normal(0.01)`` position embeddings.  The UNet and the VAE take the
serving dtype; the text encoders stay fp32, as in the JAX package.  Each
module is built in fp32 on the device and cast before the next one is
built, so the largest transient is one fp32 module (SDXL's UNet: 10.4 GB).

A ``control`` naming a ControlNet (``CONTROLNET_DICT``) adds
``ModelBundle.controlnet``, loaded from ``<controlnet_root>/<name>`` when
that directory exists, else random (warned) with its zero convolutions at
zero, as the JAX package initialises them: a no-op until trained.  Every
ControlNet there is SD1.5's, so the SDXL family refuses one.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
from torch import nn

from vidtome_torch.models import convert
from vidtome_torch.models.clip_text import (SD15_TEXT, SD21_TEXT,
                                            SDXL_TEXT_1, SDXL_TEXT_2,
                                            TINY_TEXT, TINY_TEXT_2,
                                            CLIPTextModel)
from vidtome_torch.models.controlnet import ControlNetModel
from vidtome_torch.models.layers import GroupNorm
from vidtome_torch.models.tokenizer import load_tokenizer
from vidtome_torch.models.unet import (SD2_DEPTH_UNET, SD15_UNET, SD21_UNET,
                                       SDXL_REFINER_UNET, SDXL_UNET,
                                       TINY_REFINER_UNET, TINY_UNET,
                                       UNet2DConditionModel)
from vidtome_torch.models.vae import SD_VAE_SCALING, AutoencoderKL

SD_MODEL_KEYS = {"2.1": "stable-diffusion-2-1-base",
                 "2.0": "stable-diffusion-2-base",
                 "1.5": "stable-diffusion-v1-5",
                 "depth": "stable-diffusion-2-depth",
                 "xl": "stable-diffusion-xl-base-1.0",
                 "xl-refiner": "stable-diffusion-xl-refiner-1.0",
                 "tiny": "sd-tiny", "tiny-refiner": "sd-tiny-refiner"}
_SD_VAE = ((128, 256, 512, 512), 2)
_TINY_VAE = ((8, 8, 8, 8), 1)
SD_CONFIGS = {
    "1.5": (SD15_UNET, SD15_TEXT, _SD_VAE),
    "2.0": (SD21_UNET, SD21_TEXT, _SD_VAE),
    "2.1": (SD21_UNET, SD21_TEXT, _SD_VAE),
    "depth": (SD2_DEPTH_UNET, SD21_TEXT, _SD_VAE),
    "xl": (SDXL_UNET, SDXL_TEXT_1, _SD_VAE),
    # the refiner's one (bigG) encoder is its primary text model
    "xl-refiner": (SDXL_REFINER_UNET, SDXL_TEXT_2, _SD_VAE),
    "tiny": (TINY_UNET, TINY_TEXT, _TINY_VAE),
    "tiny-refiner": (TINY_REFINER_UNET, TINY_TEXT_2, _TINY_VAE),
}
# the second text encoder of the versions that have one
TEXT2_CONFIGS = {"xl": SDXL_TEXT_2}
# the VAE scaling of the SDXL family (JAX registry.py:219, :227)
VAE_SCALING = {"xl": 0.13025, "xl-refiner": 0.13025}
# versions the JAX package runs that the port does not yet
_UNPORTED_VERSIONS = ()

# ControlNet checkpoints by control type (reference
# utils/controlnet_utils.py:17-25), under <controlnet_root>/<name>
CONTROLNET_DICT = {
    "tile": "control_v11f1e_sd15_tile",
    "ip2p": "control_v11e_sd15_ip2p",
    "openpose": "control_v11p_sd15_openpose",
    "softedge": "control_v11p_sd15_softedge",
    "depth": "control_v11f1p_sd15_depth",
    "lineart_anime": "control_v11p_sd15s2_lineart_anime",
    "canny": "control_v11p_sd15_canny",
}


@dataclasses.dataclass
class ModelBundle:
    """The SD stack of one version: modules hold their weights."""

    model_key: str
    sd_version: str
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: object
    dtype: torch.dtype
    device: torch.device
    controlnet: ControlNetModel | None = None
    # the LoRA merged into the weights, (absolute path, scale), set by
    # models/lora.apply_lora_bundle
    lora: tuple[str, float] | None = None
    # SDXL's second text encoder (bigG: penultimate states + pooled)
    text_encoder_2: CLIPTextModel | None = None
    # built without a checkpoint (init_model's random weights)
    random_weights: bool = False
    # the mesh the UNet and ControlNet are sharded on
    # (parallel/mesh.shard_bundle), None on one device
    mesh: object = None

    @property
    def use_depth(self) -> bool:
        """SD2-depth: the UNet takes the depth latents as a fifth channel."""
        return self.sd_version == "depth"

    @property
    def vae_scaling(self) -> float:
        return self.vae.scaling_factor

    @property
    def is_xl(self) -> bool:
        """SDXL base: two text encoders."""
        return self.text_encoder_2 is not None

    @property
    def is_refiner(self) -> bool:
        """SDXL refiner: one (bigG) encoder, pooled conditioning, 5 time
        ids (the aesthetic score among them)."""
        return self.sd_version.endswith("refiner")

    @property
    def needs_pooled(self) -> bool:
        """The UNet takes add_text_embeds / add_time_ids (SDXL family)."""
        return self.is_xl or self.is_refiner


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in = w[0].numel()  # OIHW / [out, in]: everything but the out axis
    # flax's truncated lecun_normal: std / .8796 so the truncated draw at
    # +-2 std keeps variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise ``module`` in place with the flax initializer
    families, drawing from ``generator`` in module order."""
    for name, mod in module.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            std = (0.01 if name.endswith("position_embedding")
                   else 1.0 / math.sqrt(mod.weight.shape[1]))
            mod.weight.normal_(0.0, std, generator=generator)


def init_model(sd_version: str = "1.5", model_key: str | None = None,
               weight_dtype: str = "bf16", device: str | torch.device = "cuda",
               seed: int = 0, control: str = "none",
               controlnet_root: str | None = None,
               allow_random_weights: bool = True) -> ModelBundle:
    """Build the SD stack on ``device`` (reference utils/utils.py:19-67).
    ``weight_dtype``: 'bf16' (or 'fp16', which means bf16 here) or 'fp32'.
    ``control``: a key of ``CONTROLNET_DICT`` adds its ControlNet.  Random
    weights draw from ``seed`` + 0 (UNet), 1 (VAE), 2 (text encoder), 3
    (ControlNet) and 4 (SDXL's second encoder), as the JAX package's
    seeds.  With ``allow_random_weights=False`` a ``model_key`` that is
    not a directory raises ``FileNotFoundError`` (the checkpoint
    converter's guard, JAX ``registry.py:262-264``)."""
    if control not in ("none", "pnp") and control not in CONTROLNET_DICT:
        raise ValueError(f"unknown control type {control!r} (choices: none, "
                         f"pnp, {', '.join(CONTROLNET_DICT)})")
    if sd_version in _UNPORTED_VERSIONS:
        raise NotImplementedError(f"sd_version {sd_version!r} is not ported "
                                  f"to vidtome_torch yet (ROADMAP.md, queue 1)")
    if sd_version not in SD_CONFIGS:
        raise ValueError(f"Stable-diffusion version {sd_version!r} not "
                         f"supported by the port (choices: "
                         f"{sorted(SD_CONFIGS)})")
    unet_cfg, text_cfg, (vae_chans, vae_layers) = SD_CONFIGS[sd_version]
    if control in CONTROLNET_DICT and unet_cfg.addition_embed:
        raise ValueError(f"control {control!r}: every ControlNet of "
                         f"CONTROLNET_DICT is SD1.5's; sd_version "
                         f"{sd_version!r} cannot take one")
    dtype = torch.bfloat16 if weight_dtype in ("bf16", "fp16") else torch.float32
    device = torch.device(device)
    have_weights = model_key is not None and os.path.isdir(model_key)
    name = model_key or SD_MODEL_KEYS[sd_version]
    if have_weights:
        print(f"[INFO] loading stable diffusion from: {model_key}")
    elif not allow_random_weights:
        raise FileNotFoundError(f"checkpoint dir not found: {model_key!r}")
    else:
        print(f"[WARNING] no local checkpoint for {name!r} — initializing "
              "RANDOM weights (weight-free mode: development/benchmark only)")
    # (module, its dtype, checkpoint subfolder, component, seed offset); the
    # refiner's one encoder is a checkpoint's text_encoder_2
    parts = {
        "unet": (lambda: UNet2DConditionModel(unet_cfg), dtype, "unet",
                 "unet", 0),
        "vae": (lambda: AutoencoderKL(
            vae_chans, vae_layers,
            scaling_factor=VAE_SCALING.get(sd_version, SD_VAE_SCALING)),
            dtype, "vae", "vae", 1),
        "text": (lambda: CLIPTextModel(text_cfg), torch.float32,
                 "text_encoder_2" if sd_version.endswith("refiner")
                 else "text_encoder", "text", 2)}
    if sd_version in TEXT2_CONFIGS:
        parts["text2"] = (lambda: CLIPTextModel(TEXT2_CONFIGS[sd_version]),
                          torch.float32, "text_encoder_2", "text", 4)
    mods = {}
    for key, (make, mod_dtype, sub, comp, offset) in parts.items():
        with torch.device(device):
            mod = make()
        if have_weights:
            mod.load_state_dict(convert.from_diffusers(
                convert.load_component_state(model_key, sub), comp),
                strict=True)
        else:
            init_random_(mod, torch.Generator(device=device).manual_seed(
                seed + offset))
        mods[key] = mod.to(mod_dtype).eval()

    tokenizer = load_tokenizer(model_key if have_weights else None,
                               vocab_size=text_cfg.vocab_size,
                               max_length=text_cfg.max_positions)
    controlnet = None
    if control in CONTROLNET_DICT:
        # every reference ControlNet is SD1.5's; the tiny stack gets a tiny
        # one (JAX registry.py:289-311)
        controlnet = init_controlnet(
            control, unet_cfg if sd_version == "tiny" else SD15_UNET,
            controlnet_root, device, seed + 3).to(dtype).eval()
    return ModelBundle(
        model_key=name, sd_version=sd_version, unet=mods["unet"],
        vae=mods["vae"], text_encoder=mods["text"], tokenizer=tokenizer,
        dtype=dtype, device=device, controlnet=controlnet,
        text_encoder_2=mods.get("text2"), random_weights=not have_weights)


def init_controlnet(control: str, config, controlnet_root: str | None,
                    device: torch.device, seed: int) -> ControlNetModel:
    """The ControlNet of ``control`` (fp32): the checkpoint under
    ``<controlnet_root>/<CONTROLNET_DICT[control]>`` if that directory
    exists, else random (warned), its zero convolutions at zero."""
    with torch.device(device):
        model = ControlNetModel(config)
    cn_dir = (os.path.join(controlnet_root, CONTROLNET_DICT[control])
              if controlnet_root else None)
    if cn_dir and os.path.isdir(cn_dir):
        print(f"[INFO] loading controlnet from: {cn_dir}")
        model.load_state_dict(convert.from_diffusers(
            convert.load_component_state(cn_dir, "."), "controlnet"),
            strict=True)
        return model
    print("[WARNING] ControlNet weights not found — random init")
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    with torch.no_grad():
        for mod in model.zero_init_modules():
            mod.weight.zero_()
    return model
