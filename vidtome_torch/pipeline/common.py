"""Shared pipeline pieces: text embedding, batched VAE coding, frame ids,
stage precision, int8 serving and a stage's ControlNet.  Counterpart of
``vidtome_tpu/pipeline/common.py``."""

from __future__ import annotations

import numpy as np
import torch

from vidtome_torch.control.depth import prepare_depth_latents
from vidtome_torch.control.preprocess import validate_control_available
from vidtome_torch.models.registry import CONTROLNET_DICT, ModelBundle
from vidtome_torch.ops import quant as quant_ops


class TextEncoder:
    """Tokenize + encode prompts to the UNet's cross-attention context
    (fp32, on the bundle's device)."""

    def __init__(self, bundle: ModelBundle):
        self._tokenizer = bundle.tokenizer
        self._model = bundle.text_encoder
        self._device = bundle.device

    @torch.no_grad()
    def __call__(self, prompts: str | list[str]) -> torch.Tensor:
        ids = torch.as_tensor(self._tokenizer(prompts), dtype=torch.long,
                              device=self._device)
        return self._model(ids)

    def embed_cfg(self, prompt: str, negative_prompt: str | None,
                  pnp: bool = False) -> torch.Tensor:
        """[uncond; cond] contexts, with an empty-prompt source lane first
        for PnP (reference generate.py:100-108)."""
        return self([""] * pnp + [negative_prompt or "", prompt])


class VAECoder:
    """Batched VAE encode/decode (reference invert.py:91-115); the last
    batch is padded by repeating its last frame."""

    def __init__(self, bundle: ModelBundle, batch_size: int = 8):
        self.batch_size = batch_size
        self._bundle = bundle

    @torch.no_grad()
    def _batched(self, fn, x: torch.Tensor) -> torch.Tensor:
        n, bs = x.shape[0], self.batch_size
        pad = (-n) % bs
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return torch.cat([fn(x[i:i + bs]) for i in range(0, x.shape[0], bs)])[:n]

    def encode(self, images) -> torch.Tensor:
        """[T, H, W, 3] in [0, 1] -> scaled latents [T, H/8, W/8, 4]."""
        b = self._bundle
        x = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images, device=b.device)
        return self._batched(
            lambda f: b.vae.encode((f.float() * 2 - 1).to(b.dtype)), x)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images [T, H, W, 3] in [0, 1], fp32."""
        b = self._bundle
        return self._batched(lambda z: b.vae.decode(z.to(b.device, b.dtype)),
                             latents)


# Options of the JAX package that the port does not run yet, with the
# values it does run: a config that turns one on is refused rather than run
# without it.
_UNPORTED = {
    "control": ("none", "pnp") + tuple(CONTROLNET_DICT),
    "chunk_batch": (False,),
    "chunk_boundaries": ("rotate",), "merge_crossattn": (False,),
    "merge_ff": (False,), "refiner": (None,),
}


def reject_unported(section: str, stage_cfg, config) -> None:
    """Raise NotImplementedError if ``stage_cfg`` (or the top level, for the
    keys the JAX package also reads there) turns on an unported option."""
    for key, ported in _UNPORTED.items():
        for where, cfg in ((section, stage_cfg), ("", config)):
            value = cfg.get(key, ported[0])
            if value in ported or value in (None, False, 0, "off", "none"):
                continue
            name = f"{where}.{key}" if where else key
            raise NotImplementedError(
                f"{name}={value!r} is not ported to vidtome_torch yet "
                f"(ROADMAP.md, queue 1)")


def get_frame_ids(frame_range, frame_ids=None) -> list[int]:
    """[start, end, step] / [end] / explicit ids (reference
    utils/utils.py:298-309)."""
    if frame_ids is None:
        frame_ids = list(range(*frame_range))
    return sorted(frame_ids)


def resolve_precision(config, stage_cfg, bundle: ModelBundle) -> torch.dtype:
    """The stage's ``float_precision`` (falling back to the global one),
    read as the JAX package and the registry read it: "bf16" and "fp16"
    mean bf16, every other value fp32.  When it differs from the weights',
    the bundle's UNet, VAE and ControlNet are cast in place; the text
    encoder stays fp32."""
    prec = stage_cfg.get("float_precision",
                         config.get("float_precision", "bf16"))
    want = torch.bfloat16 if prec in ("bf16", "fp16") else torch.float32
    if want != bundle.dtype:
        print(f"[INFO] stage float_precision={prec}: re-casting weights "
              f"{bundle.dtype} -> {want} for this stage")
        bundle.unet.to(want)
        bundle.vae.to(want)
        if bundle.controlnet is not None:
            bundle.controlnet.to(want)
        bundle.dtype = want
    return want


def parse_quant(stage_cfg, config) -> str:
    """A stage's ``quant`` (falling back to the top level): "none" or
    "int8" ("w8a8" is int8; "false" / "off" are none); any other value
    raises, as the JAX generator does (``generator.py:375-377``)."""
    mode = str(stage_cfg.get("quant", config.get("quant", "none"))
               or "none").lower()
    if mode in ("none", "false", "off"):
        return "none"
    if mode in ("int8", "w8a8"):
        return "int8"
    raise ValueError(f"unknown quant mode {mode!r} (choices: none, int8)")


def stage_quant_table(quant: str, bundle: ModelBundle, stage: str):
    """The stage's int8 UNet table (None for ``quant: none``), built once
    from the bundle's weights, which stay as they are: the two stages share
    the bundle and may run different modes."""
    if quant == "none":
        return None
    table = quant_ops.quantize_unet(bundle.unet)
    print(f"[INFO] int8 serving ({stage}): quantized "
          f"{quant_ops.count_quantized(table)} UNet weight tensors")
    return table


def stage_controlnet(control: str, bundle: ModelBundle, stage: str) -> bool:
    """Whether a stage with this ``control`` runs the bundle's ControlNet;
    raises where the control's preprocessor cannot run (openpose without a
    pose model, as JAX's ``validate_control_available``), where the bundle
    holds no ControlNet (JAX ``registry.make_controlnet`` asserts), and
    where the ControlNet cannot take the UNet's input and context, as on
    SD2-depth: 5 input channels and 1024-wide contexts against an SD1.5
    ControlNet's 4 and 768, a call the JAX package fails too."""
    if control not in CONTROLNET_DICT:
        return False
    validate_control_available(control)
    if bundle.controlnet is None:
        raise ValueError(f"{stage}.control={control!r} needs a ControlNet in "
                         f"the bundle: init_model(..., control={control!r})")
    ucfg, ccfg = bundle.unet.config, bundle.controlnet.config
    if (ucfg.in_channels, ucfg.cross_attention_dim) != (
            ccfg.in_channels, ccfg.cross_attention_dim):
        raise ValueError(
            f"{stage}.control={control!r}: the bundle's ControlNet takes "
            f"{ccfg.in_channels} input channels and {ccfg.cross_attention_dim}"
            f"-wide contexts, its UNet (sd_version {bundle.sd_version!r}) "
            f"{ucfg.in_channels} and {ucfg.cross_attention_dim}; the JAX "
            f"package cannot run this combination either")
    return True


def stage_controlnet_table(quant: str, bundle: ModelBundle, stage: str):
    """The stage's int8 ControlNet table (None for ``quant: none``), under
    the ControlNet policy (``ops/quant.CONTROLNET_EXCLUDE``)."""
    if quant == "none":
        return None
    table = quant_ops.quantize_unet(bundle.controlnet,
                                    exclude=quant_ops.CONTROLNET_EXCLUDE)
    print(f"[INFO] int8 serving ({stage}): quantized "
          f"{quant_ops.count_quantized(table)} ControlNet weight tensors")
    return table


def stage_depth(bundle: ModelBundle, frames, frame_ids,
                work_dir: str | None) -> torch.Tensor:
    """The depth latents [T, h, w, 1] (fp32, in [-1, 1]) of ``frames``
    [T, H, W, 3] in [0, 1] through the depth cache
    ``<work_dir>/depth/<frame:04>.npy`` (JAX ``inverter.py:427-430``,
    ``generator.py:951-955``), on the bundle's device."""
    if isinstance(frames, torch.Tensor):
        frames = frames.float().cpu().numpy()
    depth = prepare_depth_latents(np.asarray(frames), list(frame_ids),
                                  work_dir)
    return torch.from_numpy(np.asarray(depth, np.float32)).to(bundle.device)
