"""Shared helpers of the port-vs-JAX parity tests (``test_torch_*.py``).

The two packages are fed the same weights (the JAX parameter tree through
``vidtome_torch.models.convert.from_jax_params``) and the same random
draws: the JAX package derives its merge draws from a PRNG key chain; the
helpers here recompute those values with ``jax.random`` and hand them to
the port as plain numbers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vidtome_torch.core.merge import local_merge_rounds, round_stride
from vidtome_torch.models import convert
from vidtome_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import ToMeConfig
from vidtome_torch.models.unet import UNet2DConditionModel, UNetConfig
from vidtome_torch.models.vae import AutoencoderKL


def jax_local_draws(key, F: int, target_stride: int) -> list[int]:
    """The dst-frame draws ``core/merge.compute_local_merge`` makes from
    ``key``: one ``randint(0, stride)`` per round on successive splits."""
    draws = []
    for curF in local_merge_rounds(F, target_stride):
        key, sub = jax.random.split(key)
        draws.append(int(jax.random.randint(
            sub, (), 0, round_stride(curF, target_stride))))
    return draws


def jax_block_draws(call_key, F: int, target_stride: int) -> tuple[list, float]:
    """What every transformer block draws from a UNet call's key
    (``models/layers.py:555``): local draws and the global coin."""
    key_local, key_coin = jax.random.split(jax.random.fold_in(call_key, 0))
    return (jax_local_draws(key_local, F, target_stride),
            float(jax.random.uniform(key_coin, ())))


def jax_draw_table(seed: int, steps: int, chunks: int, F: int,
                   target_stride: int) -> np.ndarray:
    """The generator's draws, ``fold_in(fold_in(key(seed), step), chunk)``
    (``pipeline/generator.py:502``), as a port DrawSource table."""
    base = jax.random.key(seed)
    table = []
    for i in range(steps):
        row = []
        for c in range(chunks):
            key = jax.random.fold_in(jax.random.fold_in(base, i), c)
            local, coin = jax_block_draws(key, F, target_stride)
            row.append(local + [coin])
        table.append(row)
    return np.asarray(table, np.float64)


_JITTED: dict = {}


def jax_apply(model, variables, x, t, ctx, key, bank_mode: str,
              mutable: list[str], num_lanes: int = 2):
    """One merged JAX UNet call under ``jax.jit`` (on the CPU a jitted
    call compiles in a few seconds where the op-by-op one takes tens):
    ``model.apply(variables, x, t, ctx, tome_call=ToMeCall(key,
    bank_mode), num_lanes, mutable)``.  The jitted call is kept per model
    and static argument, so another key or input reuses its executable."""
    from vidtome_tpu.models.tome import ToMeCall

    sig = (model, t, bank_mode, tuple(mutable), num_lanes)
    if sig not in _JITTED:
        def call(v, x, c, key):
            return model.apply(v, x, jnp.asarray(t), c,
                               tome_call=ToMeCall(key=key,
                                                  bank_mode=bank_mode),
                               num_lanes=num_lanes, mutable=mutable)
        _JITTED[sig] = jax.jit(call)
    return _JITTED[sig](variables, jnp.asarray(x), jnp.asarray(ctx), key)


def port_tome(cfg) -> ToMeConfig:
    """The port's ToMeConfig with the JAX one's values."""
    fields = ToMeConfig.__dataclass_fields__
    return ToMeConfig(**{k: getattr(cfg, k) for k in fields})


def port_unet_config(cfg) -> UNetConfig:
    """The port's UNetConfig with the JAX one's values."""
    return UNetConfig(**{k: getattr(cfg, k)
                         for k in UNetConfig.__dataclass_fields__})


def port_text_config(cfg) -> CLIPTextConfig:
    """The port's CLIPTextConfig with the JAX one's values."""
    return CLIPTextConfig(**{k: getattr(cfg, k)
                             for k in CLIPTextConfig.__dataclass_fields__})


def port_bundle_from_jax(bundle, sd_version: str = "tiny"):
    """A CPU fp32 port bundle carrying the JAX bundle's weights (its
    ControlNet's too, where it holds one).  A JAX bundle of sd_version
    "depth" (a tiny UNet with 5 input channels, as
    ``tests/test_pipeline_control.py`` builds it) gives a port bundle of
    that version, with a UNet of the JAX one's config; a JAX SDXL bundle
    (the tiny dual-encoder stack of ``tests/test_pipeline_xl.py``) one
    with its UNet, VAE and both text encoders."""
    has_cn = bundle.controlnet_params is not None
    port = init_model(sd_version, weight_dtype="fp32", device="cpu",
                      control="canny" if has_cn else "none")
    if bundle.sd_version == "depth" and sd_version != "depth":
        port.unet = UNet2DConditionModel(
            port_unet_config(bundle.unet_config)).eval()
        port.sd_version = "depth"
    if bundle.is_xl:
        chans, layers = bundle.vae_channels
        port.unet = UNet2DConditionModel(
            port_unet_config(bundle.unet_config)).eval()
        port.vae = AutoencoderKL(chans, layers,
                                 scaling_factor=bundle.vae_scaling).eval()
        port.text_encoder = CLIPTextModel(
            port_text_config(bundle.text_config)).eval()
        port.text_encoder_2 = CLIPTextModel(
            port_text_config(bundle.text2_config)).eval()
        port.sd_version, port.model_key = bundle.sd_version, bundle.model_key
    load_jax_weights(port, bundle)
    return port


def load_jax_weights(port, bundle) -> None:
    """The JAX bundle's weights into the port bundle's modules, in place
    (a stage holding those modules sees them)."""
    mods = [(port.unet, bundle.unet_params, "unet"),
            (port.vae, bundle.vae_params, "vae"),
            (port.text_encoder, bundle.text_params, "text")]
    if bundle.controlnet_params is not None:
        mods.append((port.controlnet, bundle.controlnet_params, "controlnet"))
    if bundle.text2_params is not None:
        mods.append((port.text_encoder_2, bundle.text2_params, "text"))
    for mod, tree, comp in mods:
        tree = jax.tree.map(np.asarray, jax.device_get(tree))
        mod.load_state_dict(convert.from_jax_params(tree, comp), strict=True)


def perturb_zero_convs(params, seed: int = 0):
    """A JAX ControlNet parameter tree with its zero-initialised convs (the
    zero convs and the hint encoder's ``conv_out``) moved by 0.05 N(0, 1),
    as trained ControlNets have them (``tests/test_pipeline_control.py``
    perturbs the zero convs): at zero the ControlNet adds nothing."""
    params = dict(params)
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        return a + (0.05 * rng.standard_normal(a.shape)).astype(a.dtype)

    def moved(tree):
        return jax.tree.map(move, tree)

    for name in sorted(params):
        if name.startswith("zero_convs") or name == "mid_zero_conv":
            params[name] = moved(params[name])
    emb = dict(params["cond_embedding"])
    emb["conv_out"] = moved(emb["conv_out"])
    params["cond_embedding"] = emb
    return params


def module_state(tree) -> dict[str, torch.Tensor]:
    """A flax parameter tree of one UNet module (a block, an attention, a
    transformer) -> the port module's state dict, by the UNet rules."""
    tree = jax.tree.map(np.asarray, jax.device_get(tree))
    state = convert.from_jax_params({"m": tree}, "unet")
    return {k.removeprefix("m."): v for k, v in state.items()}


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
