"""Shared helpers of the port-vs-JAX parity tests (``test_torch_*.py``).

The two packages are fed the same weights (the JAX parameter tree through
``vidtome_torch.models.convert.from_jax_params``) and the same random
draws: the JAX package derives its merge draws from a PRNG key chain; the
helpers here recompute those values with ``jax.random`` and hand them to
the port as plain numbers.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from vidtome_torch.core.merge import local_merge_rounds, round_stride
from vidtome_torch.models import convert
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.tome import ToMeConfig


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


def port_tome(cfg) -> ToMeConfig:
    """The port's ToMeConfig with the JAX one's values."""
    fields = ToMeConfig.__dataclass_fields__
    return ToMeConfig(**{k: getattr(cfg, k) for k in fields})


def port_bundle_from_jax(bundle, sd_version: str = "tiny"):
    """A CPU fp32 port bundle carrying the JAX bundle's weights."""
    port = init_model(sd_version, weight_dtype="fp32", device="cpu")
    for mod, tree, comp in ((port.unet, bundle.unet_params, "unet"),
                            (port.vae, bundle.vae_params, "vae"),
                            (port.text_encoder, bundle.text_params, "text")):
        tree = jax.tree.map(np.asarray, jax.device_get(tree))
        mod.load_state_dict(convert.from_jax_params(tree, comp), strict=True)
    return port


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
