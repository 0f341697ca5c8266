"""The view TMA reads each operand of the flash kernel through
(``vidtome_torch.ops.attention.tma_geometry``), on the CPU: the kernel
itself runs only on the card (``tests/test_torch_kernels.py``), so its
dims, byte strides and head-dim padding, and what the wrapper refuses
before a launch, are pinned here, for contiguous [B, H, S, D] tensors and
for the [B, S, H * D] projections the UNet passes (``models/layers.py``)
seen as [B, H, S, D].  The boxes (query rows a block, keys a K/V tile) are
the C dispatch's alone."""

from __future__ import annotations

import pytest
import torch

from vidtome_torch.ops import attention as t_attn

# D -> D padded to whole 64-column swizzle atoms
PADDED = {16: 64, 40: 64, 64: 64, 80: 128, 128: 128, 160: 192, 512: 512}


def _operand(layout: str, B: int, H: int, S: int, D: int) -> torch.Tensor:
    if layout == "bhsd":
        return torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    return torch.zeros(B, S, H * D, dtype=torch.bfloat16).view(
        B, S, H, D).transpose(1, 2)


@pytest.mark.parametrize("D", sorted(PADDED))
@pytest.mark.parametrize("layout", ["bhsd", "heads_view"])
def test_geometry(layout, D):
    B, H, S = 2, 3, 300
    t = _operand(layout, B, H, S, D)
    dp = PADDED[D]
    if layout == "bhsd":
        strides = (2 * D, 2 * S * D, 2 * H * S * D)
    else:
        strides = (2 * H * D, 2 * D, 2 * S * H * D)
    assert t_attn.tma_geometry(t, S) == ((D, S, H, B), strides, dp)
    # K and V are read up to kv_valid_len: the keys past it read as zeros
    assert t_attn.tma_geometry(t, 211) == ((D, 211, H, B), strides, dp)
    assert t_attn.flash_padded_head_dim(D) == dp


def test_geometry_raises_on_a_misaligned_stride():
    # rows of 124 bf16 (248 bytes): not a multiple of 16 bytes
    t = torch.zeros(2, 10, 124, dtype=torch.bfloat16)[..., :120]
    view = t.view(2, 10, 3, 40).transpose(1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        t_attn.tma_geometry(view, 10)


def test_geometry_raises_on_a_misaligned_base():
    t = torch.zeros(2 * 3 * 10 * 40 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        t_attn.tma_geometry(t.view(2, 3, 10, 40), 10)


def test_geometry_raises_on_a_strided_head_dim():
    t = torch.zeros(2, 3, 10, 80, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        t_attn.tma_geometry(t, 10)


def test_geometry_raises_on_a_broadcast_operand():
    # K/V expanded over the batch: a zero byte stride
    t = torch.zeros(1, 3, 10, 64, dtype=torch.bfloat16).expand(2, 3, 10, 64)
    with pytest.raises(ValueError, match="positive"):
        t_attn.tma_geometry(t, 10)


@pytest.mark.parametrize("D", [36, 200, 256, 0])
def test_unsupported_head_dims_raise(D):
    with pytest.raises(ValueError, match="head dim"):
        t_attn.flash_padded_head_dim(D)
