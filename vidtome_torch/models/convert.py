"""Weights into the port: diffusers checkpoints and the JAX package's trees.

The port's modules carry the diffusers / transformers parameter names, so
a checkpoint's state dict loads after two fix-ups (:func:`from_diffusers`):
the legacy VAE attention names (``query/key/value/proj_attn``, stored as
[C, C, 1, 1] convs) and transformers' ``position_ids`` buffer.

:func:`from_jax_params` inverts ``vidtome_tpu/models/convert.py``: it turns
a flax parameter tree (numpy leaves) back into that state dict — HWIO conv
kernels to OIHW, [in, out] dense kernels to [out, in], norm ``scale`` to
``weight``, ``embedding`` to ``weight``, and the flat flax module names back
into diffusers paths; :func:`from_jax_qparams` carries the JAX package's
int8 ``qparams`` tree into the port's int8 table the same way.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from vidtome_torch.io.safetensors import load_file
from vidtome_torch.ops.quant import QuantTable, QWeight, packed_conv_weight

_UNET_RULES = [
    (r"^down_(\d+)_resnets_(\d+)/", r"down_blocks.\1.resnets.\2/"),
    (r"^down_(\d+)_attentions_(\d+)/", r"down_blocks.\1.attentions.\2/"),
    (r"^down_(\d+)_downsample/", r"down_blocks.\1.downsamplers.0/"),
    (r"^mid_resnets_(\d+)/", r"mid_block.resnets.\1/"),
    (r"^mid_attentions_0/", "mid_block.attentions.0/"),
    (r"^up_(\d+)_resnets_(\d+)/", r"up_blocks.\1.resnets.\2/"),
    (r"^up_(\d+)_attentions_(\d+)/", r"up_blocks.\1.attentions.\2/"),
    (r"^up_(\d+)_upsample/", r"up_blocks.\1.upsamplers.0/"),
    (r"transformer_blocks_(\d+)/", r"transformer_blocks.\1/"),
    (r"/to_out/", "/to_out.0/"),
    (r"/ff/proj_in/", "/ff.net.0.proj/"),
    (r"/ff/proj_out/", "/ff.net.2/"),
]

_VAE_RULES = [
    (r"^(encoder|decoder)/down_(\d+)_resnets_(\d+)/",
     r"\1/down_blocks.\2.resnets.\3/"),
    (r"^(encoder|decoder)/down_(\d+)_downsample/",
     r"\1/down_blocks.\2.downsamplers.0.conv/"),
    (r"^(encoder|decoder)/up_(\d+)_resnets_(\d+)/",
     r"\1/up_blocks.\2.resnets.\3/"),
    (r"^(encoder|decoder)/up_(\d+)_upsample/",
     r"\1/up_blocks.\2.upsamplers.0.conv/"),
    (r"^(encoder|decoder)/mid_resnets_(\d+)/", r"\1/mid_block.resnets.\2/"),
    (r"^(encoder|decoder)/mid_attn/", r"\1/mid_block.attentions.0/"),
    (r"/to_out/", "/to_out.0/"),
]

_TEXT_RULES = [
    (r"^token_embedding/", "text_model/embeddings/token_embedding/"),
    (r"^position_embedding$", "text_model/embeddings/position_embedding/weight"),
    (r"^layers_(\d+)/", r"text_model/encoder/layers.\1/"),
    (r"/fc(\d)/", r"/mlp/fc\1/"),
    (r"^final_layer_norm/", "text_model/final_layer_norm/"),
]

# the ControlNet's trunk carries the UNet's names; its own modules are the
# inverse of JAX ``convert.py:214-222``
_CONTROLNET_RULES = [
    (r"^cond_embedding/blocks_(\d+)/", r"controlnet_cond_embedding/blocks.\1/"),
    (r"^cond_embedding/", "controlnet_cond_embedding/"),
    (r"^zero_convs_(\d+)/", r"controlnet_down_blocks.\1/"),
    (r"^mid_zero_conv/", "controlnet_mid_block/"),
] + _UNET_RULES

_RULES = {"unet": _UNET_RULES, "vae": _VAE_RULES, "text": _TEXT_RULES,
          "controlnet": _CONTROLNET_RULES}

# legacy diffusers VAE attention names -> the modern ones the port uses
_LEGACY_VAE = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    module, _, leaf = path.rpartition("/")
    if leaf == "kernel":
        value = (value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T)
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return f"{module}/{leaf}", value


def from_jax_params(tree: Mapping[str, Any],
                    component: str) -> dict[str, torch.Tensor]:
    """Flax parameter tree of ``component`` ('unet', 'vae', 'text' or
    'controlnet'), numpy leaves -> the port's state dict (fp32 tensors)."""
    rules = _RULES[component]
    state = {}
    for path, value in _flatten(tree).items():
        for pattern, repl in rules:
            path = re.sub(pattern, repl, path)
        path, value = _leaf(path, np.array(value, np.float32))
        state[path.replace("/", ".")] = torch.from_numpy(
            np.ascontiguousarray(value))
    return state


def from_jax_qparams(qtree: Mapping[str, Any], unet: torch.nn.Module,
                     component: str = "unet"):
    """A JAX ``quantize_params`` qparams tree of the UNet or the ControlNet
    (``component``; numpy leaves ``kernel_q`` / ``scale`` / ``act_scale``
    under each module) -> the port's
    :class:`~vidtome_torch.ops.quant.QuantTable` of ``unet``.  Module
    paths take the :func:`from_jax_params` names; an HWIO ``kernel_q``
    becomes OIHW (packed, as ``quantize_unet`` stores it), a dense [K, N]
    one [N, K]; the scales carry over unchanged."""
    modules: dict[str, dict] = {}
    for path, value in _flatten(qtree).items():
        for pattern, repl in _RULES[component]:
            path = re.sub(pattern, repl, path)
        module, _, leaf = path.rpartition("/")
        modules.setdefault(module.replace("/", "."), {})[leaf] = np.asarray(
            value)
    entries = {}
    dev = next(unet.parameters()).device
    for name, leaves in modules.items():
        k = leaves["kernel_q"]
        w = torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)).to(dev)
        if w.ndim == 4:
            w = packed_conv_weight(w).permute(0, 3, 1, 2)
        f32 = lambda a: torch.from_numpy(  # noqa: E731
            np.array(a, np.float32)).to(dev)
        act = leaves.get("act_scale")
        entries[name] = QWeight(w, f32(leaves["scale"]),
                                None if act is None else f32(act))
    return QuantTable(unet, entries)


def from_diffusers(state: Mapping[str, Any],
                   component: str) -> dict[str, torch.Tensor]:
    """A diffusers / transformers state dict -> the port's state dict
    (``component`` 'unet', 'vae', 'text' or 'controlnet')."""
    out = {}
    for key, value in state.items():
        t = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        if component == "text" and key.endswith("position_ids"):
            continue
        if component == "vae":
            m = re.match(r"^(.*mid_block\.attentions\.0)\.(query|key|value|"
                         r"proj_attn)\.(weight|bias)$", key)
            if m:
                key = f"{m.group(1)}.{_LEGACY_VAE[m.group(2)]}.{m.group(3)}"
            if (re.search(r"mid_block\.attentions\.0\.to_", key)
                    and t.ndim == 4):  # conv-style [C, C, 1, 1] projection
                t = t.reshape(t.shape[0], t.shape[1])
        out[key] = t.float()
    return out


def load_component_state(model_dir: str, component: str) -> dict:
    """All safetensors shards under ``<model_dir>/<component>/``, read by
    the port's own reader (``io/safetensors.py``)."""
    comp_dir = os.path.join(model_dir, component)
    names = sorted(f for f in os.listdir(comp_dir)
                   if f.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no safetensors in {comp_dir}")
    state: dict = {}
    for name in names:
        state.update(load_file(os.path.join(comp_dir, name)))
    return state
