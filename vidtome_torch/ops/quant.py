"""Int8 (W8A8) serving: weight and activation quantization, int8 products.

Counterpart of ``vidtome_tpu/ops/quant.py``, with the same scheme and the
same rounding points:

  * weights: symmetric per-output-channel int8, quantized once per stage
    (:func:`quantize_unet`): scale = max(amax, 1e-8) / 127, q =
    clamp(round(w / scale), +-127), round half to even;
  * activations: symmetric int8, a static scale from the norm affine for the
    layers fed by a GroupNorm (:func:`static_act_scale`: resnet conv1 /
    conv2, the transformer ``proj_in``), else dynamic: one scale per row of a
    dense layer, per sample of a convolution, amax taken on the input dtype;
  * products: int8 x int8 summed in int32, then ``y * (s * w_scale)`` in
    fp32, cast to the output dtype; the caller adds the bias in that dtype.

The port's layouts put the output channel first (dense [N, K], conv OIHW),
where the JAX package puts it last.  A convolution's int8 weight is stored
[O, kh, kw, I] (one tap's channels contiguous) and handed out as an OIHW
view of that storage: the im2col product here and the W8A8 fused resnet
kernel (``ops/resnet.py``) both read the packed layout without a copy.

The products go to ``torch._int_mm`` (cuBLASLt on the card), as the JAX
package leaves its int8 products to XLA outside any Pallas kernel; it needs
more than 16 rows and K, N multiples of 8, and a shape that breaks that
raises.  The weights stay in the module tree in their serving dtype: a
:class:`QuantTable` is built per stage and passed per UNet call, so one
bundle serves a bf16 stage and an int8 stage.
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8
# post-GroupNorm activations are unit-variance per group; the expected max
# of ~1e6 normal samples is ~5.2 sigma, so amax ~ max_c(|beta_c| +
# K |gamma_c|), floored (ops/resnet.py's in-kernel scale shares both)
_STATIC_K = 6.0
_STATIC_AMAX_FLOOR = 0.3

# Layers kept in the serving dtype, by the JAX package's policy
# (``quant.py:159-164``) in the port's module names: the embeddings and the
# time projections, conv_in / conv_out, the GEGLU down-projection
# (``ff.net.2``), the transformer ``proj_out``, the resamplers and the
# resnet shortcuts.
DEFAULT_EXCLUDE = (
    r"time_embedding|add_embedding|time_emb_proj|"
    r"(^|\.)conv_in$|(^|\.)conv_out$|\.ff\.net\.2$|"
    r"attentions\.\d+\.proj_out$|"
    r"downsamplers|upsamplers|conv_shortcut")
# the ControlNet's policy (JAX ``generator.py:361-374``: DEFAULT_EXCLUDE plus
# "zero_conv|cond_embedding"): its residual-producing zero convs and the
# image-space hint encoder stay in the serving dtype as well
CONTROLNET_EXCLUDE = (DEFAULT_EXCLUDE + r"|controlnet_down_blocks|"
                      r"controlnet_mid_block|controlnet_cond_embedding")
# a module whose input is its sibling norm's output: the static scale
_STATIC_PAIRS = {"conv1": "norm1", "conv2": "norm2", "proj_in": "norm"}


def quantize_weight(w: torch.Tensor, reduce=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of ``w`` (dense [N, K] or conv
    OIHW, output channel first) -> (int8 of w's shape, fp32 scale [N]).
    ``reduce(t, "max")`` (a row-parallel shard's, ``parallel/mesh``) makes
    the amax the whole input row's, so the scale is the whole weight's."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
    if reduce is not None:
        amax = reduce(amax, "max")
    scale = amax.clamp_min(_EPS) / 127.0
    q = torch.round(wf / scale.view(-1, *[1] * (wf.ndim - 1)))
    return q.clamp(-127, 127).to(torch.int8), scale


def quantize_acts(x: torch.Tensor, dims: tuple[int, ...], reduce=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8: one scale per slice reduced over ``dims``,
    amax on x's dtype (``reduce(t, "max")`` takes it over a row-parallel
    shard's model axis) -> (int8, fp32 scale broadcastable against x)."""
    amax = x.abs().amax(dim=dims, keepdim=True).float()
    if reduce is not None:
        amax = reduce(amax, "max")
    scale = amax.clamp_min(_EPS) / 127.0
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def static_act_scale(norm_weight: torch.Tensor,
                     norm_bias: torch.Tensor) -> torch.Tensor:
    """int8 scale of silu?(GroupNorm(x) * gamma + beta) from the affine
    alone: max(max_c(|beta_c| + K |gamma_c|), floor) / 127, fp32 []."""
    amax = (norm_bias.float().abs() + _STATIC_K * norm_weight.float().abs()
            ).max().clamp_min(_STATIC_AMAX_FLOOR)
    return amax / 127.0


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact."""
    M, K = a.shape
    N = b.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"int8 product [{M}, {K}] x [{K}, {N}]: needs more "
                         f"than 16 rows and K, N multiples of 8")
    return torch._int_mm(a, b)


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               out_dtype: torch.dtype,
               act_scale: torch.Tensor | None = None,
               reduce=None) -> torch.Tensor:
    """x [..., K] @ w_q[N, K]^T -> [..., N] in ``out_dtype``; per-row
    dynamic activation scales, or the static ``act_scale``.  A
    row-parallel shard (K a slice of the input) passes its ``reduce(t,
    op)``: the row's scale is the max over the model axis and the int32
    sums are summed over it, so every rank gets the whole product."""
    x2 = x.reshape(-1, x.shape[-1])
    if act_scale is None:
        q, s = quantize_acts(x2, dims=(1,), reduce=reduce)
    else:
        s = act_scale
        q = _quantize(x2, s)
    y = _int_mm(q, w_q.t())
    if reduce is not None:
        y = reduce(y)
    y = (y.float() * (s * w_scale)).to(out_dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[0])


def packed_conv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight as [O, kh, kw, I], contiguous (a free view when
    ``w_q`` is a view of packed storage, as the int8 tables and
    ``ResnetBlock2D`` hold it)."""
    return w_q.permute(0, 2, 3, 1).contiguous()


def int8_conv_acc(q: torch.Tensor, w_q: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """The int32 sums of a convolution with zero padding k // 2: int8 q
    [B, H, W, I], int8 w_q OIHW with a square odd kernel k -> int32
    [B, H', W', O], as an im2col product."""
    B, H, W, Ci = q.shape
    Co, _, kh, kw = w_q.shape
    if kh != kw or kh % 2 == 0 or w_q.shape[1] != Ci:
        raise ValueError(f"int8 conv takes square odd kernels over {Ci} "
                         f"channels, got weight {tuple(w_q.shape)}")
    p = kh // 2
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if p or stride > 1:
        qp = F.pad(q, (0, 0, p, p, p, p))
        cols = torch.stack([qp[:, i:i + stride * (Ho - 1) + 1:stride,
                               j:j + stride * (Wo - 1) + 1:stride]
                            for i in range(kh) for j in range(kw)], dim=3)
    else:
        cols = q
    y = _int_mm(cols.reshape(B * Ho * Wo, kh * kw * Ci),
                packed_conv_weight(w_q).view(Co, -1).t())
    return y.view(B, Ho, Wo, Co)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              out_dtype: torch.dtype, act_scale: torch.Tensor | None = None,
              stride: int = 1) -> torch.Tensor:
    """Convolution of x [B, H, W, I] with int8 w_q OIHW (zero padding
    k // 2) -> [B, H', W', O] in ``out_dtype``; per-sample dynamic
    activation scales, or the static ``act_scale``."""
    if act_scale is None:
        q, s = quantize_acts(x, dims=(1, 2, 3))
    else:
        s = act_scale
        q = _quantize(x, s)
    y = int8_conv_acc(q, w_q, stride)
    return (y.float() * (s * w_scale)).to(out_dtype)


@dataclasses.dataclass(frozen=True)
class QWeight:
    """The int8 form of one Linear / Conv2d weight: ``weight`` int8 in the
    module's layout (a conv's as an OIHW view of [O, kh, kw, I] storage),
    ``scale`` fp32 [O], ``act_scale`` fp32 [] or None (dynamic)."""

    weight: torch.Tensor
    scale: torch.Tensor
    act_scale: torch.Tensor | None = None


class QuantTable:
    """The int8 weights of one module tree: :attr:`entries` by module name
    (relative to the root), looked up by module in :meth:`get`."""

    def __init__(self, root: nn.Module, entries: dict[str, QWeight]):
        self.entries = entries
        self._by_module = {root.get_submodule(n): e
                           for n, e in entries.items()}

    def get(self, module: nn.Module) -> QWeight | None:
        return self._by_module.get(module)

    def __len__(self) -> int:
        return len(self.entries)


def count_quantized(table: QuantTable) -> int:
    """The int8 tensors of a table (one per quantized weight)."""
    return len(table)


def quantizable(root: nn.Module, exclude: str | None = DEFAULT_EXCLUDE,
                include: str | None = None) -> list[str]:
    """Names of the Linear and Conv2d modules under ``root`` that the
    policy quantizes."""
    ex = re.compile(exclude) if exclude else None
    inc = re.compile(include) if include else None
    return [name for name, m in root.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))
            and (ex is None or not ex.search(name))
            and (inc is None or inc.search(name))]


def _static_scales(root: nn.Module, names) -> dict[str, torch.Tensor]:
    """Static activation scales of the modules fed by a sibling norm."""
    out = {}
    for name in names:
        parent, _, leaf = name.rpartition(".")
        norm_name = _STATIC_PAIRS.get(leaf)
        if norm_name is None:
            continue
        norm = getattr(root.get_submodule(parent) if parent else root,
                       norm_name, None)
        if norm is not None and getattr(norm, "weight", None) is not None:
            out[name] = static_act_scale(norm.weight, norm.bias)
    return out


@torch.no_grad()
def quantize_unet(root: nn.Module, exclude: str | None = DEFAULT_EXCLUDE,
                  include: str | None = None) -> QuantTable:
    """The int8 table of ``root`` under the policy (JAX
    ``quantize_params``); the modules' weights are not touched."""
    names = quantizable(root, exclude, include)
    acts = _static_scales(root, names)
    entries = {}
    for name in names:
        mod = root.get_submodule(name)
        tp = getattr(mod, "tp", None)
        w_q, scale = quantize_weight(
            mod.weight, tp.reduce if tp is not None and tp.row_parallel
            else None)
        if w_q.ndim == 4:  # packed once: [O, kh, kw, I], viewed as OIHW
            w_q = packed_conv_weight(w_q).permute(0, 3, 1, 2)
        entries[name] = QWeight(w_q, scale, acts.get(name))
    return QuantTable(root, entries)
