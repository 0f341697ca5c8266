"""Model factory: SD version -> modules with weights on a device.

Counterpart of ``vidtome_tpu/models/registry.py`` for ``"1.5"``,
``"2.1"`` / ``"2.0"`` (one architecture), ``"depth"`` (SD2-depth: SD2.1's
text encoder and VAE, a UNet with a fifth input channel for the depth
latents) and ``"tiny"``.  ``model_key``
names a local checkpoint directory in the standard layout (unet/ vae/
text_encoder/ tokenizer/, safetensors); without
one, weights are random (warned), drawn from a seeded ``torch.Generator``
with the flax initializer families the JAX package uses: truncated
``lecun_normal`` for conv and dense kernels, zero biases, unit / zero norm
scale / bias, ``normal(1/sqrt(width))`` token and ``normal(0.01)``
position embeddings.  The UNet and the VAE take the serving dtype; the text
encoder stays fp32, as in the JAX package.

A ``control`` naming a ControlNet (``CONTROLNET_DICT``) adds
``ModelBundle.controlnet``, loaded from ``<controlnet_root>/<name>`` when
that directory exists, else random (warned) with its zero convolutions at
zero, as the JAX package initialises them: a no-op until trained.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
from torch import nn

from vidtome_torch.models import convert
from vidtome_torch.models.clip_text import (SD15_TEXT, SD21_TEXT,
                                            TINY_TEXT, CLIPTextModel)
from vidtome_torch.models.controlnet import ControlNetModel
from vidtome_torch.models.layers import GroupNorm
from vidtome_torch.models.tokenizer import load_tokenizer
from vidtome_torch.models.unet import (SD2_DEPTH_UNET, SD15_UNET, SD21_UNET,
                                       TINY_UNET, UNet2DConditionModel)
from vidtome_torch.models.vae import AutoencoderKL

SD_MODEL_KEYS = {"2.1": "stable-diffusion-2-1-base",
                 "2.0": "stable-diffusion-2-base",
                 "1.5": "stable-diffusion-v1-5",
                 "depth": "stable-diffusion-2-depth", "tiny": "sd-tiny"}
_SD_VAE = ((128, 256, 512, 512), 2)
SD_CONFIGS = {
    "1.5": (SD15_UNET, SD15_TEXT, _SD_VAE),
    "2.0": (SD21_UNET, SD21_TEXT, _SD_VAE),
    "2.1": (SD21_UNET, SD21_TEXT, _SD_VAE),
    "depth": (SD2_DEPTH_UNET, SD21_TEXT, _SD_VAE),
    "tiny": (TINY_UNET, TINY_TEXT, ((8, 8, 8, 8), 1)),
}
# versions the JAX package runs that the port does not yet
_UNPORTED_VERSIONS = ("xl", "xl-refiner", "tiny-refiner")

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

    @property
    def use_depth(self) -> bool:
        """SD2-depth: the UNet takes the depth latents as a fifth channel."""
        return self.sd_version == "depth"


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
               controlnet_root: str | None = None) -> ModelBundle:
    """Build the SD stack on ``device`` (reference utils/utils.py:19-67).
    ``weight_dtype``: 'bf16' (or 'fp16', which means bf16 here) or 'fp32'.
    ``control``: a key of ``CONTROLNET_DICT`` adds its ControlNet."""
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
    dtype = torch.bfloat16 if weight_dtype in ("bf16", "fp16") else torch.float32
    device = torch.device(device)
    have_weights = model_key is not None and os.path.isdir(model_key)
    name = model_key or SD_MODEL_KEYS[sd_version]

    with torch.device(device):
        unet = UNet2DConditionModel(unet_cfg)
        vae = AutoencoderKL(vae_chans, vae_layers)
        text = CLIPTextModel(text_cfg)
    if have_weights:
        print(f"[INFO] loading stable diffusion from: {model_key}")
        for mod, comp, sub in ((unet, "unet", "unet"), (vae, "vae", "vae"),
                               (text, "text", "text_encoder")):
            state = convert.from_diffusers(
                convert.load_component_state(model_key, sub), comp)
            mod.load_state_dict(state, strict=True)
    else:
        print(f"[WARNING] no local checkpoint for {name!r} — initializing "
              "RANDOM weights (weight-free mode: development/benchmark only)")
        for i, mod in enumerate((unet, vae, text)):
            gen = torch.Generator(device=device).manual_seed(seed + i)
            init_random_(mod, gen)

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
        model_key=name, sd_version=sd_version, unet=unet.to(dtype).eval(),
        vae=vae.to(dtype).eval(), text_encoder=text.float().eval(),
        tokenizer=tokenizer, dtype=dtype, device=device,
        controlnet=controlnet)


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
