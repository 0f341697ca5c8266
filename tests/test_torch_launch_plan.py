"""The attention wrappers' per-signature launch plan
(``vidtome_torch.ops.attention.launch_plan``), on the CPU: the kernels run
only on the card (``tests/test_torch_kernels.py``), but what a wrapper
checks once per signature of q, k, v and ``kv_valid_len``, what it raises,
the strides it hands the C entry and that a second call with the same
signature skips the checks are pinned here, for contiguous [B, H, S, D]
tensors and for the [B, S, H * D] projections the UNet passes
(``models/layers.py``) seen as [B, H, S, D]."""

from __future__ import annotations

import math

import pytest
import torch

from vidtome_torch.ops import attention as t_attn


def _heads_view(B: int, S: int, H: int, D: int) -> torch.Tensor:
    return torch.zeros(B, S, H * D, dtype=torch.bfloat16).view(
        B, S, H, D).transpose(1, 2)


@pytest.fixture(autouse=True)
def _fresh_plans():
    t_attn._PLANS.clear()
    yield
    t_attn._PLANS.clear()


@pytest.mark.parametrize("layout", ["bhsd", "heads_view"])
@pytest.mark.parametrize("D", [16, 40, 80, 160])
def test_plan_strides_and_output(layout, D):
    B, H, Sq, Skv = 2, 3, 100, 77
    if layout == "bhsd":
        q = torch.zeros(B, H, Sq, D, dtype=torch.bfloat16)
        k = torch.zeros(B, H, Skv, D, dtype=torch.bfloat16)
    else:
        q, k = _heads_view(B, Sq, H, D), _heads_view(B, Skv, H, D)
    plan = t_attn.launch_plan(q, k, k, Skv, t_attn._check_small_kv_dims)
    out_strides = (Sq * H * D, D, H * D)
    assert tuple(plan.strides) == (*q.stride()[:3], *k.stride()[:3],
                                   *k.stride()[:3], *out_strides)
    assert plan.ints == (B, H, Sq, Skv, D, -(-D // 16) * 16, 80)
    out = q.new_empty_strided(plan.out_shape, plan.out_strides)
    assert out.shape == q.shape and out.stride()[:3] == out_strides
    # [B, Sq, H, D] storage: merging the heads back into channels is a view
    assert out.transpose(1, 2).is_contiguous()


def test_flash_plan_ints():
    q, k = _heads_view(2, 300, 4, 64), _heads_view(2, 333, 4, 64)
    plan = t_attn.launch_plan(q, k, k, 320, t_attn._check_flash_head_dim)
    assert plan.ints == (2, 4, 300, 320, 64)


def test_second_call_skips_the_checks(monkeypatch):
    calls = []
    real = t_attn._check_qkv
    monkeypatch.setattr(t_attn, "_check_qkv",
                        lambda *a: (calls.append(a[3]), real(*a)))
    q, k = _heads_view(2, 64, 4, 40), _heads_view(2, 77, 4, 40)
    plan = t_attn.launch_plan(q, k, k, 77, t_attn._check_small_kv_dims)
    # new tensors with the same signature: the plan comes back unchecked
    again = t_attn.launch_plan(_heads_view(2, 64, 4, 40),
                               _heads_view(2, 77, 4, 40),
                               _heads_view(2, 77, 4, 40), 77,
                               t_attn._check_small_kv_dims)
    assert again is plan and calls == [77]
    # the flash wrapper's check makes a plan of its own
    t_attn.launch_plan(q, k, k, 77, t_attn._check_flash_head_dim)
    assert calls == [77, 77]


def test_same_check_same_plan(monkeypatch):
    q = _heads_view(2, 64, 4, 40)
    k = _heads_view(2, 77, 4, 40)
    plan = t_attn.launch_plan(q, k, k, 77, t_attn._check_small_kv_dims)
    monkeypatch.setattr(t_attn, "_check_qkv", _raise)
    monkeypatch.setattr(t_attn, "small_kv_takes", _raise)
    assert t_attn.launch_plan(_heads_view(2, 64, 4, 40),
                              _heads_view(2, 77, 4, 40),
                              _heads_view(2, 77, 4, 40), 77,
                              t_attn._check_small_kv_dims) is plan
    # another kv_valid_len is another signature, checked anew
    with pytest.raises(AssertionError, match="checked"):
        t_attn.launch_plan(q, k, k, 70, t_attn._check_small_kv_dims)


def _raise(*args):
    raise AssertionError("checked")


def _plan(q, k, kv_len=None, check=t_attn._check_small_kv_dims):
    return t_attn.launch_plan(q, k, k, k.shape[2] if kv_len is None
                              else kv_len, check)


def test_plan_raises_on_fp32():
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(TypeError, match="bf16"):
        _plan(q, q)


def test_plan_raises_on_a_misaligned_stride():
    # rows of 124 bf16 (248 bytes): not a multiple of 16 bytes
    t = torch.zeros(2, 10, 124, dtype=torch.bfloat16)[..., :120]
    view = t.view(2, 10, 3, 40).transpose(1, 2)
    with pytest.raises(ValueError, match="16 bytes"):
        _plan(view, view)


def test_plan_raises_on_a_shape_mismatch():
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 77, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        _plan(q, k)


@pytest.mark.parametrize("kv_len", [0, 78])
def test_plan_raises_on_kv_len_outside_the_keys(kv_len):
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 77, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kv_valid_len"):
        _plan(q, k, kv_len)


@pytest.mark.parametrize("D,Skv", [(36, 77), (168, 77), (64, 257)])
def test_small_kv_plan_raises_on_what_the_kernel_is_not_built_for(D, Skv):
    q = torch.zeros(1, 2, 64, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, Skv, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="small-KV kernel"):
        _plan(q, k)


def test_flash_plan_raises_on_an_unsupported_head_dim():
    q = torch.zeros(1, 2, 300, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        _plan(q, q, check=t_attn._check_flash_head_dim)


def test_the_data_pointer_is_checked_apart():
    # a misaligned base is no part of the signature: the plan is made, and
    # the per-call check raises
    t = torch.zeros(2 * 3 * 10 * 40 + 1, dtype=torch.bfloat16)[1:]
    q = t.view(2, 3, 10, 40)
    _plan(q, q)
    with pytest.raises(ValueError, match="aligned"):
        t_attn._aligned_pointers(q, q, q)


def test_launch_hands_the_c_entry_its_arguments(monkeypatch):
    # the card's current-stream query, which this CPU build lacks
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    q, k = _heads_view(2, 64, 4, 40), _heads_view(2, 77, 4, 40)
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    out = t_attn._launch(entry, "small-KV", q, k, k, 70, 0.5,
                         t_attn._check_small_kv_dims)
    (args,) = seen
    assert args[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(),
                        out.data_ptr())
    assert args[4:11] == (2, 4, 64, 70, 40, 48, 80)
    assert tuple(args[11]) == (*q.stride()[:3], *k.stride()[:3],
                               *k.stride()[:3], *out.stride()[:3])
    assert args[12] == pytest.approx(0.5 * math.log2(math.e))
    assert args[13] == 1234
    with pytest.raises(RuntimeError, match="small-KV launch failed: error 3"):
        t_attn._launch(lambda *a: 3, "small-KV", q, k, k, 70, 0.5,
                       t_attn._check_small_kv_dims)


@pytest.mark.parametrize("Skv,kvp", [(1, 64), (16, 64), (64, 64), (77, 80),
                                     (80, 80), (100, 128), (200, 256),
                                     (256, 256)])
def test_small_kv_padded_key_count(Skv, kvp):
    assert t_attn._small_kv_keys(Skv) == kvp
