"""Mean merging, spatial matching, partition and the ToMe statistics on the
port vs the JAX package, with the JAX draws.

Inputs give every matching decision a wide margin (the constructions of
``tests/test_torch_merge.py``), so the plans must agree exactly: the
sorted src / dst / kept indices of ``keep_sorted_indices`` included; the
merged tokens to fp32 rounding (1e-6).
"""

from __future__ import annotations

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_merge import _frames, _pair
from tests.torch_parity import (jax_apply, jax_block_draws,
                                jax_local_draws, port_bundle_from_jax,
                                port_tome)
from vidtome_torch import logging_utils as t_log
from vidtome_torch.core import merge as TM
from vidtome_torch.models.tome import ToMeCall as TCall
from vidtome_tpu import logging_utils as j_log
from vidtome_tpu.core import merge as JM
from vidtome_tpu.models.tome import ToMeConfig as JConfig
from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel

torch.set_num_threads(2)
TOL = dict(atol=1e-6, rtol=0)


def _jit(fn, *args, **static):
    """``fn(*args, **static)`` under ``jax.jit`` with the keywords static:
    on the CPU one compiled program takes seconds where the op-by-op call
    compiles every primitive apart."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _assert_sorted_plans_equal(tp, jp):
    for name in ("merge_gather", "unmerge_gather", "a_idx", "b_idx",
                 "unm_idx", "src_idx", "dst_idx"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed,F,tnum,align", [
    (0, 4, 64, False), (1, 4, 64, True), (2, 8, 32, False)])
def test_mean_local_merge_matches_jax(seed, F, tnum, align):
    x = _frames(seed, 2, F, tnum, 32)
    key = jax.random.key(200 + seed)
    jt, jplans = _jit(JM.compute_local_merge, jnp.asarray(x), F=F,
                      ratio=0.9, key=key, target_stride=4,
                      align_batch=align, mode="mean", len_quantum=None)
    tt, tplans = TM.compute_local_merge(torch.from_numpy(x), F, 0.9,
                                        jax_local_draws(key, F, 4),
                                        target_stride=4, align_batch=align,
                                        mode="mean", len_quantum=None)
    assert len(tplans) == len(jplans)
    for tp, jp in zip(tplans, jplans):
        _assert_sorted_plans_equal(tp, jp)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    # mean differs from replace: the dst tokens averaged their matches
    replace = TM.merge(torch.from_numpy(x), tplans[0])
    assert (TM.merge(torch.from_numpy(x), tplans[0], "mean")
            - replace).abs().max() > 1e-2


@pytest.mark.parametrize("seed,align", [(0, False), (1, True)])
def test_mean_two_set_merge_matches_jax(seed, align):
    x = np.concatenate(_pair(seed, 2, 320), axis=1)
    jp = _jit(JM.two_set_matching, jnp.asarray(x), src_len=320, ratio=0.8,
              align_batch=align, keep_sorted_indices=True, len_quantum=1024)
    tp = TM.two_set_matching(torch.from_numpy(x), 320, 0.8, align_batch=align,
                             keep_sorted_indices=True, len_quantum=1024)
    _assert_sorted_plans_equal(tp, jp)
    for mode in ("mean", "replace"):
        merged = TM.merge(torch.from_numpy(x), tp, mode)
        np.testing.assert_allclose(merged.numpy(), np.asarray(
            JM.merge(jnp.asarray(x), jp, mode)), **TOL)
        for side in (0, 1):
            np.testing.assert_allclose(
                TM.partition(TM.unmerge(merged, tp), 320, side).numpy(),
                np.asarray(JM.partition(JM.unmerge(
                    JM.merge(jnp.asarray(x), jp, mode), jp), 320, side)),
                **TOL)


def test_sorted_plan_merges_as_the_fast_one():
    """Replace-mode merging keeps the same token set with sorted indices or
    without; only the kept tokens' order differs (JAX's too)."""
    x = torch.from_numpy(_frames(4, 2, 4, 64, 32))
    fast = TM.local_matching(x, 4, 0.9, 0, draw=1)
    slow = TM.local_matching(x, 4, 0.9, 0, draw=1, keep_sorted_indices=True)
    assert fast.src_idx is None and slow.src_idx is not None
    U = fast.unm_num
    assert torch.equal(fast.merge_gather[:, U:], slow.merge_gather[:, U:])
    assert torch.equal(fast.merge_gather[:, :U].sort().values,
                       slow.merge_gather[:, :U].sort().values)
    np.testing.assert_allclose(
        TM.unmerge(TM.merge(x, fast), fast).numpy(),
        TM.unmerge(TM.merge(x, slow), slow).numpy(), **TOL)


def test_unknown_merge_mode_raises():
    x = torch.from_numpy(_frames(0, 2, 4, 16, 8))
    plan = TM.local_matching(x, 4, 0.5, 0, draw=0)
    with pytest.raises(ValueError, match="merge mode"):
        TM.merge(x, plan, "max")
    with pytest.raises(ValueError, match="sorted indices"):
        TM.merge(x, plan, "mean")


@pytest.mark.parametrize("no_rand,sorted_idx", [
    (True, False), (False, False), (False, True)])
def test_spatial_matching_2d_matches_jax(no_rand, sorted_idx):
    h, w, sy, sx, r = 16, 12, 2, 3, 20
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, h * w, 24)).astype(np.float32)
    key = jax.random.key(11)
    jp = jax.jit(lambda m, k: JM.spatial_matching_2d(
        m, w, h, sx, sy, r, key=k, no_rand=no_rand,
        keep_sorted_indices=sorted_idx))(jnp.asarray(x), key)
    rand = torch.from_numpy(np.array(
        jax.random.randint(key, (h // sy, w // sx), 0, sy * sx)))
    tp = TM.spatial_matching_2d(torch.from_numpy(x), w, h, sx, sy, r,
                                rand=rand, no_rand=no_rand,
                                keep_sorted_indices=sorted_idx)
    names = ["merge_gather", "unmerge_gather", "a_idx", "b_idx", "unm_idx"]
    if sorted_idx:
        names += ["src_idx", "dst_idx"]
    for name in names:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    modes = ("replace", "mean") if sorted_idx else ("replace",)
    for mode in modes:
        np.testing.assert_allclose(
            TM.merge(torch.from_numpy(x), tp, mode).numpy(),
            np.asarray(JM.merge(jnp.asarray(x), jp, mode)), **TOL)
    if no_rand:  # every window's corner is dst
        b = tp.b_idx[0]
        assert torch.equal(b % w % sx, torch.zeros_like(b))
        assert torch.equal(b // w % sy, torch.zeros_like(b))
    assert TM.spatial_matching_2d(torch.from_numpy(x), w, h, sx, sy, 0) is None
    drawn = TM.spatial_matching_2d(torch.from_numpy(x), w, h, sx, sy, r,
                                   generator=torch.Generator().manual_seed(0))
    assert drawn.b_idx.shape == tp.b_idx.shape


def test_partition_matches_jax():
    x = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    for src_len, chunk in ((4, 0), (4, 1), (5, 0), (5, 1)):
        np.testing.assert_array_equal(
            TM.partition(torch.from_numpy(x), src_len, chunk).numpy(),
            np.asarray(JM.partition(jnp.asarray(x), src_len, chunk)))
    for chunk in (0, 1):
        np.testing.assert_array_equal(
            TM.partition(torch.from_numpy(x), 5, torch.tensor(chunk)).numpy(),
            np.asarray(JM.partition(jnp.asarray(x), 5, jnp.asarray(chunk))))
    with pytest.raises(ValueError, match="equal-size"):
        TM.partition(torch.from_numpy(x), 4, torch.tensor(0))


def _jax_name(port_name: str) -> str:
    """down_blocks.0.attentions.1.transformer_blocks.0 ->
    down_0_attentions_1/transformer_blocks_0 (the flax module path)."""
    name = re.sub(r"^(down|up)_blocks\.(\d+)\.", r"\1_\2_", port_name)
    name = name.replace("mid_block.", "mid_")
    name = re.sub(r"attentions\.(\d+)\.", r"attentions_\1/", name)
    return re.sub(r"transformer_blocks\.(\d+)$", r"transformer_blocks_\1",
                  name)


def test_tome_stats_match_jax():
    """collect_tome_stats of a call that initialises the bank and of one
    that merges against it (seq_len: 2 lanes x 4 frames x tokens;
    merged_len: after the local merge, and the global one) equals JAX's per
    block."""
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    tb = port_bundle_from_jax(jb)
    jcfg = JConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                   share_match=True, collect_stats=True)
    model = UNet2DConditionModel(config=TINY_UNET, tome=jcfg,
                                 dtype=jnp.float32, use_pallas=False)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 16, 16, 4)).astype(np.float32)
    ctx = np.repeat(rng.normal(size=(2, 16, 32)).astype(np.float32), 4, 0)
    variables = {"params": jb.unet_params}
    banks: dict = {}
    key = jax.random.key(1)
    local, coin = jax_block_draws(key, 4, 4)
    stats = {}
    for mode in ("init", "merge"):
        _, mut = jax_apply(model, variables, x, 11, ctx, key, mode,
                           ["tome_stats", "tome_bank"])
        variables = {**variables, "tome_bank": mut["tome_bank"]}
        want = j_log.collect_tome_stats(mut["tome_stats"])
        call = TCall(cfg=port_tome(jcfg), local_draws=local, coin=coin,
                     bank_mode=mode, banks=banks)
        with torch.no_grad():
            tb.unet(torch.from_numpy(x), 11, torch.from_numpy(ctx),
                    tome_call=call)
        got = t_log.collect_tome_stats(call.stats, tb.unet)
        assert {_jax_name(k): v for k, v in got.items()} == want
        assert all(v["merged_len"] < v["seq_len"] for v in got.values())
        stats[mode] = got
    # against the bank, attn1 also sees the bank tokens the global merge
    # kept
    assert all(stats["merge"][k]["merged_len"] > v["merged_len"]
               for k, v in stats["init"].items())


def test_logger_and_timed(capsys):
    log = t_log.get_logger()
    with t_log.timed("unit-stage", log):
        pass
    assert "unit-stage took" in capsys.readouterr().out
