"""The PnP and SD2.x modules of the port vs the JAX package, on the CPU.

Same weights (the JAX parameter trees through ``from_jax_params``), inputs
from numpy with a seed.  fp32 at rtol / atol 1e-4 (summation-order noise):
``inject_lane0``, share_qk attention, the injected resnet, the
linear-projection ``Transformer2D``, an SD2-shaped tiny UNet (fixed head
dim, dense projections: ``TINY_UNET`` with ``num_heads=None, head_dim=16,
use_linear_projection=True`` on both sides) with both injection flags
both ways, CLIP with exact gelu, and 3-lane ``align_batch`` matching.
bf16: the fused-sublayer TransformerBlock against the JAX fused block
(Pallas sublayer in interpret mode), 5e-2 absolute as
``tests/test_sublayer.py`` holds the JAX kernel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_merge import _assert_plans_equal, _frames, _pair
from tests.torch_parity import (jax_block_draws, jax_local_draws,
                                module_state, port_tome, to_np)
from vidtome_torch.core import merge as TM
from vidtome_torch.models import clip_text as t_clip
from vidtome_torch.models import convert as t_convert
from vidtome_torch.models import layers as TL
from vidtome_torch.models import unet as t_unet
from vidtome_torch.models.tome import ToMeCall as TCall
from vidtome_tpu.core import merge as JM
from vidtome_tpu.models import clip_text as j_clip
from vidtome_tpu.models import layers as JL
from vidtome_tpu.models import unet as j_unet
from vidtome_tpu.models.registry import _jit_init
from vidtome_tpu.models.tome import ToMeCall as JCall
from vidtome_tpu.models.tome import ToMeConfig as JConfig

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 5e-2


def _n(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _load(module, tree):
    module.load_state_dict(module_state(tree), strict=True)
    return module.eval()


@pytest.mark.parametrize("flag", [True, False])
def test_inject_lane0(flag):
    x = _n(np.random.default_rng(0), 6, 5, 4)  # 3 lanes x 2 frames
    want = JL.inject_lane0(jnp.asarray(x), 3, jnp.asarray(flag))
    got = TL.inject_lane0(torch.from_numpy(x), 3, flag)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("share", [True, False])
def test_share_qk_attention(share):
    rng = np.random.default_rng(1)
    x = _n(rng, 6, 12, 32)
    jattn = JL.CrossAttention(query_dim=32, heads=2, head_dim=16,
                              dtype=jnp.float32, use_pallas=False)
    params = jattn.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = jattn.apply({"params": params}, jnp.asarray(x),
                       share_qk=jnp.asarray(share), num_lanes=3)
    tattn = _load(TL.CrossAttention(32, 2, 16), params)
    with torch.no_grad():
        got = tattn(torch.from_numpy(x), share_qk=share, num_lanes=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("inject", [True, False])
def test_injected_resnet(inject):
    """Lane 0's conv2 features go to every lane before the (projection)
    shortcut; a block given an inject flag never takes the fused kernel."""
    rng = np.random.default_rng(2)
    x, temb = _n(rng, 6, 8, 8, 16), _n(rng, 6, 32)
    jres = JL.ResnetBlock2D(out_channels=32, dtype=jnp.float32,
                            use_pallas=False)
    params = jres.init(jax.random.key(1), jnp.asarray(x),
                       jnp.asarray(temb))["params"]
    want = jres.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb),
                      inject=jnp.asarray(inject), num_lanes=3)
    tres = _load(TL.ResnetBlock2D(16, 32, 32), params)
    xt, tt = torch.from_numpy(x), torch.from_numpy(temb)
    with torch.no_grad():
        got = tres(xt, tt, inject=inject, num_lanes=3)
        fused = tres(xt, tt, resnet_mode="fused", inject=inject, num_lanes=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert torch.equal(fused, got)


def test_linear_projection_transformer():
    rng = np.random.default_rng(3)
    x, ctx = _n(rng, 2, 4, 4, 32), _n(rng, 2, 7, 24)
    jt = JL.Transformer2D(channels=32, heads=2, head_dim=16, context_dim=24,
                          use_linear_projection=True, dtype=jnp.float32,
                          use_pallas=False)
    params = jt.init(jax.random.key(2), jnp.asarray(x),
                     jnp.asarray(ctx))["params"]
    assert params["proj_in"]["kernel"].ndim == 2  # dense, not a 1x1 conv
    want = jt.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    tt = _load(TL.Transformer2D(32, 2, 16, 24, downsample=1, linear=True),
               params)
    assert isinstance(tt.proj_in, torch.nn.Linear)
    with torch.no_grad():
        got = tt(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


SD2_TINY_J = dataclasses.replace(j_unet.TINY_UNET, num_heads=None,
                                 head_dim=16, use_linear_projection=True)
SD2_TINY_T = dataclasses.replace(t_unet.TINY_UNET, num_heads=None,
                                 head_dim=16, use_linear_projection=True)


@pytest.fixture(scope="module")
def sd2_tiny():
    model = j_unet.UNet2DConditionModel(config=SD2_TINY_J, dtype=jnp.float32,
                                        use_pallas=False)
    params = _jit_init(model, jnp.zeros((1, 8, 8, 4)), jnp.asarray(0),
                       jnp.zeros((1, 7, 32)), seed=5)
    state = t_convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(params)), "unet")
    tmodel = t_unet.UNet2DConditionModel(SD2_TINY_T)
    tmodel.load_state_dict(state, strict=True)
    jcfg = JConfig(frames=4, local_merge_ratio=0.5, merge_global=True,
                   align_batch=True, share_match=True, len_quantum=None)
    key = jax.random.key(7)

    def run(merged):  # one compile per branch, the flags traced
        m = model.clone(tome=jcfg) if merged else model
        kw = dict(tome_call=JCall(key=key, bank_mode="init"),
                  mutable=["tome_bank"]) if merged else {}

        def f(x, ctx, attn, conv):
            out = m.apply({"params": params}, x, jnp.asarray(601), ctx,
                          attn_inject=attn, conv_inject=conv, num_lanes=3,
                          **kw)
            return out[0] if merged else out
        return jax.jit(f)

    local, coin = jax_block_draws(key, 4, 4)
    tcall = dict(cfg=port_tome(jcfg), local_draws=local, coin=coin,
                 bank_mode="init")
    return {False: run(False), True: run(True)}, tcall, tmodel.eval()


@pytest.mark.parametrize("attn,conv,merged", [
    (True, True, False), (True, False, False), (False, True, False),
    (False, False, False), (True, True, True), (False, False, True)])
def test_sd2_unet_with_injections(sd2_tiny, attn, conv, merged):
    """3 lanes x 4 frames; merged: local + global-bank init with the
    matchings aligned over the lanes, as PnP runs."""
    jax_fns, tcall, tmodel = sd2_tiny
    assert tmodel.down_blocks[0].attentions[0].transformer_blocks[0] \
        .attn1.heads == 2  # 32 channels / head dim 16
    rng = np.random.default_rng(6)
    x = _n(rng, 12, 8, 8, 4)
    ctx = np.repeat(_n(rng, 3, 7, 32), 4, 0)
    want = np.asarray(jax_fns[merged](jnp.asarray(x), jnp.asarray(ctx),
                                      jnp.asarray(attn), jnp.asarray(conv)))
    tkw = dict(tome_call=TCall(**tcall)) if merged else {}
    with torch.no_grad():
        got = to_np(tmodel(torch.from_numpy(x), 601, torch.from_numpy(ctx),
                           attn_inject=attn, conv_inject=conv, num_lanes=3,
                           **tkw))
        off = to_np(tmodel(torch.from_numpy(x), 601, torch.from_numpy(ctx),
                           attn_inject=False, conv_inject=False, num_lanes=3,
                           **tkw))
    np.testing.assert_allclose(got, want, **TOL)
    if attn or conv:  # injection reaches the edit lanes
        assert np.abs(got[4:] - off[4:]).max() > 1e-3
    if not merged:  # the source lane runs on its own values
        np.testing.assert_array_equal(got[:4], off[:4])


def test_clip_exact_gelu():
    jcfg = dataclasses.replace(j_clip.TINY_TEXT, hidden_act="gelu")
    tcfg = dataclasses.replace(t_clip.TINY_TEXT, hidden_act="gelu")
    jm = j_clip.CLIPTextModel(cfg=jcfg)
    ids = np.random.default_rng(8).integers(0, 1000, (3, 16))
    params = jm.init(jax.random.key(3), jnp.asarray(ids))["params"]
    want = jm.apply({"params": params}, jnp.asarray(ids))
    tm = t_clip.CLIPTextModel(tcfg)
    tm.load_state_dict(t_convert.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(params)), "text"),
        strict=True)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # exact gelu is not quick_gelu on these weights
    quick = t_clip.CLIPTextModel(t_clip.TINY_TEXT)
    quick.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert (quick(torch.as_tensor(ids)) - got).abs().max() > 1e-3


def test_sd21_configs_match_jax():
    assert t_unet.SD21_UNET.heads_for(1280) == \
        j_unet.SD21_UNET.heads_for(1280) == (20, 64)
    for f in ("cross_attention_dim", "num_heads", "head_dim",
              "use_linear_projection", "block_out_channels"):
        assert getattr(t_unet.SD21_UNET, f) == getattr(j_unet.SD21_UNET, f)
    for f in ("hidden_size", "num_layers", "num_heads", "intermediate_size",
              "hidden_act", "max_positions"):
        assert getattr(t_clip.SD21_TEXT, f) == getattr(j_clip.SD21_TEXT, f)


@pytest.mark.parametrize("seed,F,tnum,ratio", [(10, 4, 64, 0.9),
                                               (11, 8, 32, 0.9)])
def test_local_merge_aligned_over_three_lanes(seed, F, tnum, ratio):
    """PnP's source, uncond and cond lanes share one matching: each src
    token takes its best lane's score and dst."""
    x = _frames(seed, 3, F, tnum, 32)
    key = jax.random.key(200 + seed)
    jt, jplans = JM.compute_local_merge(jnp.asarray(x), F, ratio, key,
                                        target_stride=4, align_batch=True)
    tt, tplans = TM.compute_local_merge(
        torch.from_numpy(x), F, ratio, jax_local_draws(key, F, 4),
        target_stride=4, align_batch=True)
    assert len(tplans) == len(jplans)
    for tp, jp in zip(tplans, jplans):
        _assert_plans_equal(tp, jp)
        assert (tp.merge_gather == tp.merge_gather[:1]).all()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)


def test_global_merge_aligned_over_three_lanes():
    x = np.concatenate(_pair(12, 3, 320), axis=1)
    jp = JM.two_set_matching(jnp.asarray(x), 320, 0.8, align_batch=True,
                             len_quantum=1024)
    tp = TM.two_set_matching(torch.from_numpy(x), 320, 0.8, align_batch=True,
                             len_quantum=1024)
    _assert_plans_equal(tp, jp)


def test_fused_sublayer_block_matches_jax_fused_block():
    """bf16, the JAX block on its Pallas sublayer (interpret mode) and the
    port's on its plain version; the same block in sublayer_mode off is
    the unfused chain."""
    rng = np.random.default_rng(9)
    x, ctx = _n(rng, 2, 16, 64), _n(rng, 2, 7, 32)
    kw = dict(dim=64, heads=4, head_dim=16, context_dim=32, downsample=1,
              dtype=jnp.bfloat16, use_pallas=True)
    jx, jctx = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16)
    params = JL.TransformerBlock(**kw, sublayer_mode="off").init(
        jax.random.key(4), jx, jctx)["params"]
    want = JL.TransformerBlock(**kw, sublayer_mode="fused").apply(
        {"params": params}, jx, jctx)
    tblk = _load(TL.TransformerBlock(64, 4, 16, 32, downsample=1),
                 params).to(torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    ct = torch.from_numpy(ctx).bfloat16()
    with torch.no_grad():
        got = tblk(xt, ct, sublayer_mode="fused")
        off = tblk(xt, ct, sublayer_mode="off")
        fp32 = tblk.float()(xt.float(), ct.float(), sublayer_mode="fused")
    assert got.dtype == torch.bfloat16
    assert np.abs(to_np(got) - np.asarray(want, np.float32)).max() < BF16_ATOL
    assert np.abs(to_np(got) - to_np(off)).max() < BF16_ATOL
    assert not torch.equal(got, off)  # the fused path ran
    # fp32 weights keep the unfused chain, as in the JAX package
    with torch.no_grad():
        assert torch.equal(fp32, tblk(xt.float(), ct.float()))
    with pytest.raises(ValueError, match="sublayer_mode"):
        tblk(xt.float(), ct.float(), sublayer_mode="measured")
