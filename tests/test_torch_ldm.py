"""LDM-variant merging (``merge_crossattn`` / ``merge_ff``) on the port vs
the JAX package: tiny UNet calls at fp32 on the CPU, same weights, same
draws (recomputed from the JAX keys).

* One UNet call with cross-attention, the feed-forward or both on the
  locally merged tokens, bank ``init`` then ``merge``, ``share_match`` on
  and off, in replace and mean mode, to 1e-5 of max |ref|.
* With identical frames, cross-attention and the feed-forward lose
  nothing by running merged: the LDM call equals the call that merges
  attn1 only (as ``tests/test_models.py:403``).
* The fused-sublayer gate equals JAX's ``_fused_sublayer_ok`` over its
  inputs: a merging block of the LDM variant never fuses.
* One int8 call with LDM merging against JAX's int8 call (JAX's table on
  both sides), and the int8 wiring of the merged layers pinned directly:
  in every merging block each attn2 and ff layer the table holds takes it
  on the locally merged tokens.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (jax_apply, jax_block_draws,
                                port_bundle_from_jax, port_tome, to_np)
from vidtome_torch.models import convert as t_convert
from vidtome_torch.models.layers import Linear as TLinear
from vidtome_torch.models.layers import TransformerBlock as TBlock
from vidtome_torch.models.tome import ToMeCall as TCall
from vidtome_tpu.models.layers import TransformerBlock as JBlock
from vidtome_tpu.models.tome import ToMeConfig as JConfig
from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel
from vidtome_tpu.ops import quant as jq

torch.set_num_threads(2)
# fp32 noise through the tiny UNet's layers, relative to max |ref|
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def bundles():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    return jb, port_bundle_from_jax(jb)


def _inputs(seed, same_frames=False):
    """Two chunks of 2 lanes x 4 frames at a 16x16 latent, the lane
    contexts repeated per frame."""
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(2):
        x = rng.normal(size=(8, 16, 16, 4)).astype(np.float32)
        if same_frames:
            x = np.repeat(x[::4], 4, axis=0)
        xs.append(x)
    ctx = np.repeat(rng.normal(size=(2, 16, 32)).astype(np.float32), 4, 0)
    return xs, ctx


def _port_calls(tb, tcfg, xs, ctx, qt=None):
    """Bank init then merge on the port with the JAX draws."""
    banks: dict = {}
    out = []
    for chunk, (x, mode) in enumerate(zip(xs, ("init", "merge"))):
        local, coin = jax_block_draws(jax.random.key(70 + chunk), 4, 4)
        call = TCall(cfg=tcfg, local_draws=local, coin=coin, bank_mode=mode,
                     banks=banks)
        with torch.no_grad():
            out.append(to_np(tb.unet(torch.from_numpy(x), 301,
                                     torch.from_numpy(ctx), tome_call=call,
                                     qt=qt)))
    return out


def _calls(jb, tb, jcfg, xs, ctx, qparams=None, qt=None):
    """Bank init then merge on both packages: [(port, JAX)] outputs."""
    model = UNet2DConditionModel(config=TINY_UNET, tome=jcfg,
                                 dtype=jnp.float32, use_pallas=False)
    variables = {"params": jb.unet_params}
    if qparams is not None:
        variables = {"params": qparams[0], "qparams": qparams[1]}
    want = []
    for chunk, (x, mode) in enumerate(zip(xs, ("init", "merge"))):
        out, mut = jax_apply(model, variables, x, 301, ctx,
                             jax.random.key(70 + chunk), mode, ["tome_bank"])
        variables = {**variables, **mut}
        want.append(np.asarray(out))
    return list(zip(_port_calls(tb, port_tome(jcfg), xs, ctx, qt), want))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("crossattn,ff,share_match,mode", [
    (True, False, True, "replace"),
    (False, True, False, "replace"),
    (True, True, True, "replace"),
    (True, True, False, "mean"),
])
def test_ldm_unet_call_matches_jax(bundles, crossattn, ff, share_match,
                                   mode):
    jb, tb = bundles
    jcfg = JConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                   global_merge_ratio=0.8, share_match=share_match,
                   merge_crossattn=crossattn, merge_ff=ff, merge_mode=mode,
                   len_quantum=1024)
    xs, ctx = _inputs(1)
    outs = _calls(jb, tb, jcfg, xs, ctx)
    plain = _port_calls(tb, dataclasses.replace(
        port_tome(jcfg), merge_crossattn=False, merge_ff=False), xs, ctx)
    for (got, want), got_plain in zip(outs, plain):
        assert _rel(got, want) <= REL_TOL
        # the LDM variant changes the call
        assert _rel(got_plain, want) > 1e-3


def test_ldm_identical_frames_equal_the_unmerged_call(bundles):
    """With every frame of a chunk identical, each merged-away token's dst
    holds its own value, so attn2 and ff on the merged tokens give what
    they give unmerged (per-token layers commute with the unmerge)."""
    from vidtome_torch.models.tome import ToMeConfig

    _, tb = bundles
    xs, ctx = _inputs(2, same_frames=True)
    out = {}
    for ldm in (False, True):
        cfg = ToMeConfig(frames=4, local_merge_ratio=0.9,
                         merge_crossattn=ldm, merge_ff=ldm)
        call = TCall(cfg=cfg, local_draws=[1], bank_mode="off")
        with torch.no_grad():
            out[ldm] = to_np(tb.unet(torch.from_numpy(xs[0]), 3,
                                     torch.from_numpy(ctx), tome_call=call))
    np.testing.assert_allclose(out[True], out[False], atol=1e-5, rtol=1e-5)


def test_fused_sublayer_gate_matches_jax():
    """Over sublayer mode, weight dtype, head width, whether the block
    merges and both LDM flags (JAX with use_pallas=True, the TPU's
    setting)."""
    from vidtome_torch.models.tome import ToMeConfig

    for (mode, bf16, full_width, do_merge, ca, ff) in itertools.product(
            ("off", "fused"), (True, False), (True, False), (True, False),
            (True, False), (True, False)):
        heads, head_dim = (2, 16) if full_width else (2, 8)
        jcfg = JConfig(frames=4, merge_crossattn=ca, merge_ff=ff)
        jblk = JBlock(dim=32, heads=heads, head_dim=head_dim, context_dim=32,
                      downsample=1, tome=jcfg, use_pallas=True,
                      sublayer_mode=mode,
                      dtype=jnp.bfloat16 if bf16 else jnp.float32)
        tblk = TBlock(32, heads, head_dim, 32, 1)
        if bf16:
            tblk = tblk.to(torch.bfloat16)
        tcfg = ToMeConfig(frames=4, merge_crossattn=ca, merge_ff=ff)
        assert tblk._fused_sublayer_ok(mode, tcfg, do_merge) == \
            jblk._fused_sublayer_ok(jcfg, do_merge), (mode, bf16, full_width,
                                                      do_merge, ca, ff)


def test_int8_ldm_call_matches_jax(bundles):
    """JAX's int8 table on both sides (``from_jax_qparams``).  The dense
    layers alone agree to 1e-5 of max |ref| (``tests/test_torch_quant.py``),
    but an activation within fp32 noise of an int8 rounding boundary lands
    a whole step apart, and the UNet's quantized layers and its merge
    matchings carry such flips to the output: JAX's own int8 call moves by
    8-9% of max |ref| when its input moves by 1e-6.  So the port is held to
    1.5 times that spread, which this test measures, and the table must
    move the call by more than it."""
    jb, tb = bundles
    res, qp = jq.quantize_params(jb.unet_params)
    qt = t_convert.from_jax_qparams(jax.tree.map(np.asarray, qp), tb.unet)
    jcfg = JConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                   share_match=True, merge_crossattn=True, merge_ff=True)
    xs, ctx = _inputs(3)
    rng = np.random.default_rng(9)
    moved = [x + 1e-6 * rng.normal(size=x.shape).astype(np.float32)
             for x in xs]
    outs = _calls(jb, tb, jcfg, xs, ctx, qparams=(res, qp), qt=qt)
    spread = _calls(jb, tb, jcfg, moved, ctx, qparams=(res, qp), qt=qt)
    fp = _port_calls(tb, port_tome(jcfg), xs, ctx)
    for (got, want), (_, want_moved), want_fp in zip(outs, spread, fp):
        noise = _rel(want_moved, want)
        assert _rel(got, want) <= 1.5 * noise
        assert _rel(want_fp, want) > 1.5 * noise


def test_int8_ldm_blocks_take_the_table(bundles):
    """The int8 call's tolerance above cannot see one layer run without the
    table, so the wiring is pinned on the port: in each merging block
    (both chunks), every attn2 and ff layer that JAX's table holds is
    called with the table, attn2's queries and output projection and ff's
    two layers on fewer rows than the block was given (the locally merged
    tokens), attn2's keys and values on one context row per joined row."""
    jb, tb = bundles
    _, qp = jq.quantize_params(jb.unet_params)
    qt = t_convert.from_jax_qparams(jax.tree.map(np.asarray, qp), tb.unet)
    tcfg = port_tome(JConfig(frames=4, local_merge_ratio=0.9,
                             merge_global=True, share_match=True,
                             merge_crossattn=True, merge_ff=True))
    seen, rows, hooks = [], {}, []

    def block_pre(blk, args):
        rows[blk] = args[0].shape[:2]  # B, N

    def layer_pre(blk, name, mod, args, kwargs):
        given = args[1] if len(args) > 1 else kwargs.get("qt")
        seen.append((blk, name, args[0].shape[:-1].numel(), given is qt))

    blocks = [b for b in tb.unet.modules() if isinstance(b, TBlock)
              and b.downsample <= tcfg.max_downsample]
    for blk in blocks:
        hooks.append(blk.register_forward_pre_hook(block_pre))
        for part in ("attn2", "ff"):
            for name, mod in getattr(blk, part).named_modules(prefix=part):
                if isinstance(mod, TLinear) and qt.get(mod) is not None:
                    hooks.append(mod.register_forward_pre_hook(
                        lambda m, a, k, blk=blk, name=name:
                        layer_pre(blk, name, m, a, k), with_kwargs=True))
    try:
        _port_calls(tb, tcfg, *_inputs(3), qt=qt)
    finally:
        for h in hooks:
            h.remove()
    assert blocks and all(given for *_, given in seen)
    for blk in blocks:
        names = {name for b, name, _, _ in seen if b is blk}
        assert {"attn2.to_q", "attn2.to_out.0"} <= names
        assert any(n.startswith("ff.") for n in names)
        B, N = rows[blk]
        for b, name, n, _ in seen:
            if b is blk and name in ("attn2.to_k", "attn2.to_v"):
                assert n == B // 4 * 16  # context[::frames], 16 tokens
            elif b is blk:
                assert n < B * N, (name, n, B * N)
