"""A control for the layers the program has no lower-precision path of its
own for: the reference's dense layers and convolutions computed on
float8 (e4m3) operands, the step below bfloat16 that a later change could
take.  Weights are rounded once per output channel, each input per tensor,
each with its scale (amax / 448); the products then run in float32."""

from __future__ import annotations

import torch
from torch import nn

_E4M3_MAX = 448.0


def _round(t: torch.Tensor, dim=None) -> torch.Tensor:
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True)).clamp_min(1e-12)
    scale = amax / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def to_fp8_operands(module: nn.Module) -> list:
    """Round ``module``'s dense and convolution weights to e4m3 in place
    and round their inputs on every call; returns the hook handles."""
    handles = []
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            dims = tuple(range(1, m.weight.dim()))
            m.weight.copy_(_round(m.weight, dims))
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: (_round(args[0]),) + tuple(args[1:])))
    return handles
