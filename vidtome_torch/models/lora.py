"""LoRA adapters merged into the UNet and the text encoder on load.

Counterpart of ``vidtome_tpu/models/lora.py`` (the reference calls
``pipe.load_lora_weights``, ``generate.py:93-94`` in lixirui142/VidToMe):
each adapter pair is merged weight-level, W += scale * (alpha / rank) *
up @ down, so the adapted model runs as fast as the plain one.  Deltas are
computed in fp32 in the torch layout ([out, in] for a Linear, [out, in, kh,
kw] for a conv: the up [out, r(, 1, 1)] times the down [r, in(, kh, kw)]),
cast to the weight's dtype and added in place.  The in-place add moves the
weight's version counter, so caches keyed on it (``ops/sublayer.scaled_wq``)
rebuild.

Key formats, as in the JAX package:
  * kohya / webui: ``lora_unet_<path>`` / ``lora_te_<path>`` (SDXL:
    ``lora_te1_`` / ``lora_te2_``) with ``.lora_up.weight`` /
    ``.lora_down.weight`` / ``.alpha`` leaves;
  * diffusers / peft: ``unet.<dotted>.lora_A.weight`` / ``lora_B.weight``,
    ``text_encoder.<dotted>``, ``text_encoder_2.<dotted>``, or
    ``base_model.model.<dotted>`` for the UNet.
The dotted names are diffusers' for the UNet and transformers'
(``text_model.encoder.layers.N...``) for the text encoders: the port's
modules carry both, so a name is looked up as it stands.  The ``te2``
namespace goes into SDXL's second encoder (``bundle.text_encoder_2``); a
bundle with one encoder (SD1.x / 2.x, the SDXL refiner, whose one encoder
is bigG) skips it with a warning, as the JAX package does.  A pair whose
module is missing or of another shape is skipped and counted; the log
gives the shapes in the JAX package's kernel layout (dense [in, out], conv
[kh, kw, in, out]), so that its lines read as the reference's.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn

from vidtome_torch.io.safetensors import load_file
from vidtome_torch.parallel.mesh import shard_like


def _kohya_to_dotted(name: str, mods: tuple[str, ...] | None = None) -> str:
    """lora_unet_down_blocks_0_attentions_0_... -> down_blocks.0.attentions.0...

    ``mods`` is the module-name vocabulary used to place the remaining
    underscore→dot boundaries (longest match first, so e.g.
    "time_emb_proj" wins over the shorter "proj"/"conv")."""
    if name.startswith("lora_unet_"):
        name = name[len("lora_unet_"):]
    if mods is None:
        mods = _UNET_MODS
    name = re.sub(r"_(\d+)(?=_|$)", r".\1", name)
    pat = "|".join(sorted(mods, key=len, reverse=True))
    name = re.sub(rf"_({pat})(?=[._]|$)", r".\1", name)
    return name


_UNET_MODS = ("attentions", "resnets", "transformer_blocks", "attn1",
              "attn2", "ff", "to_q", "to_k", "to_v", "to_out", "net",
              "proj", "proj_in", "proj_out", "conv1", "conv2", "conv",
              "time_emb_proj", "downsamplers", "upsamplers")
_TE_MODS = ("encoder", "layers", "self_attn", "q_proj", "k_proj",
            "v_proj", "out_proj", "mlp", "fc1", "fc2")


def _collect_pairs(state: dict) -> dict[str, dict[str, dict]]:
    """Group lora tensors by namespace ("unet" / "te" / "te2") and target
    module path (diffusers dotted form)."""
    spaces: dict[str, dict[str, dict]] = {"unet": {}, "te": {}, "te2": {}}

    def slot(space: str, dotted: str) -> dict:
        return spaces[space].setdefault(dotted, {})

    for key, value in state.items():
        if key.startswith("lora_unet_") or key.startswith("lora_te"):
            base, leaf = key.split(".", 1)
            if base.startswith("lora_unet_"):
                space, dotted = "unet", _kohya_to_dotted(
                    base[len("lora_unet_"):], _UNET_MODS)
            else:
                prefix = base.split("_", 2)[1]  # te / te1 / te2
                space = "te2" if prefix == "te2" else "te"
                rest = base[len("lora_") + len(prefix) + 1:]
                dotted = _kohya_to_dotted(rest, _TE_MODS)
            entry = slot(space, dotted)
            if leaf == "lora_up.weight":
                entry["up"] = value
            elif leaf == "lora_down.weight":
                entry["down"] = value
            elif leaf == "alpha":
                entry["alpha"] = float(value)
        elif ".lora_A." in key or ".lora_B." in key:
            dotted = key
            space = "unet"
            for prefix, sp in (("unet.", "unet"),
                               ("text_encoder_2.", "te2"),
                               ("text_encoder.", "te"),
                               ("base_model.model.", "unet")):
                if dotted.startswith(prefix):
                    dotted, space = dotted[len(prefix):], sp
                    break
            which = "down" if ".lora_A." in dotted else "up"
            dotted = re.sub(r"\.lora_[AB]\.(default\.)?weight$", "", dotted)
            slot(space, dotted)[which] = value
    return spaces


def _delta(entry: dict, scale: float) -> torch.Tensor | None:
    """scale * alpha / rank * up @ down in the torch layout (fp32, CPU)."""
    up, down = entry.get("up"), entry.get("down")
    if up is None or down is None:
        return None
    up, down = torch.as_tensor(up).float(), torch.as_tensor(down).float()
    rank = down.shape[0]
    alpha = entry.get("alpha", float(rank))
    if up.ndim == 4:  # conv lora: [out, r, 1, 1] @ [r, in, kh, kw]
        w = (up.reshape(up.shape[0], up.shape[1])
             @ down.reshape(rank, -1)).reshape(up.shape[0], *down.shape[1:])
    else:
        w = up @ down  # [out, r] @ [r, in]
    return w * (scale * alpha / rank)


def _jax_layout(shape) -> tuple[int, ...]:
    """A torch weight shape in the JAX package's kernel layout: [out, in]
    -> (in, out), OIHW -> (H, W, I, O)."""
    shape = tuple(shape)
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return shape[::-1]


def _merge_pairs(root: nn.Module, pairs: dict[str, dict], scale: float,
                 label: str) -> int:
    """Add each pair's delta to the weight of the Linear or conv it names
    under ``root``, in place; returns the count merged."""
    applied, skipped = 0, []
    for dotted, entry in pairs.items():
        delta = _delta(entry, scale)
        if delta is None:
            skipped.append(dotted)
            continue
        try:
            module = root.get_submodule(dotted)
        except AttributeError:
            module = None
        if not isinstance(module, (nn.Linear, nn.Conv2d)):
            skipped.append(dotted)
            continue
        # a layer sharded on a mesh's model axis takes its part of the delta
        delta = shard_like(module, delta)
        weight = module.weight
        if tuple(weight.shape) != tuple(delta.shape):
            skipped.append(f"{dotted} (shape {_jax_layout(delta.shape)} vs "
                           f"{_jax_layout(weight.shape)})")
            continue
        with torch.no_grad():
            weight.add_(delta.to(weight.device, weight.dtype))
        applied += 1
    print(f"[INFO] LoRA[{label}]: merged {applied} modules"
          + (f", skipped {len(skipped)}" if skipped else ""))
    if skipped[:3]:
        print(f"[WARNING] LoRA[{label}] skipped examples: {skipped[:3]}")
    return applied


def merge_lora_state(unet: nn.Module, state: dict,
                     scale: float = 1.0) -> int:
    """Merge the LoRA's UNet deltas into ``unet`` in place; returns the
    count of modules merged."""
    return _merge_pairs(unet, _collect_pairs(state)["unet"], scale, "unet")


def merge_lora_text_state(text_encoder: nn.Module, state: dict,
                          scale: float = 1.0, encoder: int = 1) -> int:
    """Merge the LoRA's text-encoder deltas into ``text_encoder`` in place
    (``encoder=2`` selects the SDXL lora_te2_ / text_encoder_2
    namespace)."""
    space = "te2" if encoder == 2 else "te"
    return _merge_pairs(text_encoder, _collect_pairs(state)[space], scale,
                        f"text_encoder{'_2' if encoder == 2 else ''}")


def apply_lora_bundle(bundle, lora_cfg: dict) -> None:
    """Merge the LoRA of the config's ``generation.lora`` section
    (``{path: file.safetensors, weight: 1.0}``; a local safetensors file,
    where the reference takes HF-hub arguments) into the bundle's UNet and
    text encoders, in place, once: the bundle records the adapter
    (``ModelBundle.lora``), the same adapter again merges nothing, and
    another one raises."""
    path = lora_cfg.get("path") or lora_cfg.get("weight_name")
    if path is None:
        print("[WARNING] use_lora set but no lora.path given — skipping")
        return
    scale = float(lora_cfg.get("weight", lora_cfg.get("adapter_weights", 1.0)))
    adapter = (os.path.abspath(path), scale)
    if bundle.lora == adapter:
        print(f"[INFO] LoRA {path} (scale {scale}) already merged")
        return
    if bundle.lora is not None:
        raise ValueError(f"the bundle holds the LoRA {bundle.lora[0]} at "
                         f"scale {bundle.lora[1]}; merging {path} at scale "
                         f"{scale} needs a fresh bundle (init_model)")
    # in name order, as the JAX package's reader (safe_open) lists them,
    # so that both log the same skipped examples
    pairs = _collect_pairs(dict(sorted(load_file(path).items())))
    if pairs["unet"]:
        _merge_pairs(bundle.unet, pairs["unet"], scale, "unet")
    if pairs["te"]:
        _merge_pairs(bundle.text_encoder, pairs["te"], scale, "text_encoder")
    if pairs["te2"]:
        if bundle.text_encoder_2 is None:
            print("[WARNING] LoRA has text_encoder_2 tensors but the model "
                  "has a single text encoder — skipped")
        else:
            _merge_pairs(bundle.text_encoder_2, pairs["te2"], scale,
                         "text_encoder_2")
    bundle.lora = adapter
