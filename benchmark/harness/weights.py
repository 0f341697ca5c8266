"""Random weights from the run's seed, the same for the program and for the
reference.

Each component (UNet, VAE, text encoder) draws one flat buffer of standard
normals truncated at +-2 with a ``torch.Generator`` on the run's device, in
one call, and cuts it into its parameters in the order of their sorted
names.  The families are the flax initializers the JAX package's random
weights use (the port's ``registry.init_random_`` draws the same families
leaf by leaf): a dense or convolution kernel of fan-in ``f`` takes the
truncated draw times ``sqrt(1 / f) / 0.8796`` (truncated ``lecun_normal``),
biases 0, norm scales 1, the token embedding ``1 / sqrt(width)``, the
position embedding 0.01.  Both sides get the tensors rounded to the
component's serving dtype, so they hold the same numbers.
"""

from __future__ import annotations

import math

import torch

_TRUNC = 0.87962566103423978  # std of a standard normal truncated at +-2
_OFFSETS = {"unet": 0, "vae": 1, "text": 2}


def _scale(name: str, shape: tuple[int, ...]) -> float | None:
    """The draw's scale for a parameter, or None for a constant one."""
    if name.endswith("position_embedding.weight"):
        return 0.01
    if name.endswith("token_embedding.weight"):
        return 1.0 / math.sqrt(shape[1])
    if len(shape) >= 2:
        return math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC
    return None


def draw(shapes: dict[str, tuple[int, ...]], component: str, seed: int,
         device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The parameters ``shapes`` (name -> shape) of ``component``, drawn
    from ``seed`` on ``device`` and rounded to ``dtype``."""
    names = sorted(shapes)
    drawn = [n for n in names if _scale(n, shapes[n]) is not None]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(
        int(seed) * 8 + _OFFSETS[component])
    buf = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    for n in names:
        shape = shapes[n]
        s = _scale(n, shape)
        if s is None:
            fill = 0.0 if n.endswith("bias") else 1.0
            out[n] = torch.full(shape, fill, device=device, dtype=dtype)
            continue
        k = math.prod(shape)
        out[n] = (buf[off:off + k].view(shape) * s).to(dtype)
        off += k
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def load(module: torch.nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into ``module``'s parameters (names and shapes must
    be the module's own, no more and no less)."""
    params = dict(module.named_parameters())
    if set(params) != set(tensors):
        missing = sorted(set(params) ^ set(tensors))[:5]
        raise ValueError(f"parameter names differ: {missing}")
    for n, p in params.items():
        p.copy_(tensors[n])
