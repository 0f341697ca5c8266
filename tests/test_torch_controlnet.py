"""The port's ControlNet vs the JAX package at tiny size, fp32, same weights.

The JAX tiny ControlNet (``ControlNetModel`` on ``TINY_UNET``, the
registry's init) with its zero convs and the hint encoder's ``conv_out``
moved off zero (``tests/torch_parity.perturb_zero_convs``) is carried into
the port by ``convert.from_jax_params(..., "controlnet")``; inputs come
from numpy with a seed.  Held to ``tests/test_torch_models.py``'s TOL
(rtol = atol = 1e-4): the residuals, the hint encoder alone, and the UNet
fed them in a full and a shallow (deep-cache) call.  Also: the diffusers
names load with ``strict=True``, the int8 policy quantizes the JAX
package's layers with its scales, an int8 ControlNet call, and the random
fallback is a no-op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import perturb_zero_convs, to_np
from vidtome_torch.models import convert as t_convert
from vidtome_torch.models.controlnet import ControlNetModel as TControlNet
from vidtome_torch.models.registry import init_model
from vidtome_torch.models.unet import TINY_UNET as T_TINY
from vidtome_torch.ops import quant as tq
from vidtome_tpu.models.controlnet import ControlNetModel
from vidtome_tpu.models.registry import _jit_init
from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel
from vidtome_tpu.ops import quant as jq

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
T = 421


def _jax_controlnet(seed: int = 7):
    model = ControlNetModel(config=TINY_UNET, dtype=jnp.float32,
                            use_pallas=False)
    params = _jit_init(model, jnp.zeros((1, 8, 8, 4)), jnp.asarray(0),
                       jnp.zeros((1, 8, 32)), jnp.zeros((1, 64, 64, 3)),
                       seed=seed)
    params = jax.tree.map(np.asarray, jax.device_get(params))
    return model, perturb_zero_convs(params, seed)


def _port_controlnet(params) -> TControlNet:
    port = TControlNet(T_TINY)
    port.load_state_dict(t_convert.from_jax_params(params, "controlnet"),
                         strict=True)
    return port.eval()


def _inputs(seed: int = 0, batch: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(batch, 16, 32)).astype(np.float32)
    cond = rng.random(size=(batch, 64, 64, 3)).astype(np.float32)
    return x, ctx, cond


@pytest.fixture(scope="module")
def nets():
    from tests.helpers import make_tiny_bundle
    from tests.torch_parity import port_bundle_from_jax

    model, params = _jax_controlnet()
    jb = make_tiny_bundle()
    return model, params, _port_controlnet(params), jb, \
        port_bundle_from_jax(jb)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_controlnet_residuals_match_jax(nets, scale):
    model, params, port, _, _ = nets
    x, ctx, cond = _inputs()
    down_j, mid_j = model.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(T), jnp.asarray(ctx),
                                jnp.asarray(cond), conditioning_scale=scale)
    with torch.no_grad():
        down_t, mid_t = port(torch.from_numpy(x), T, torch.from_numpy(ctx),
                             torch.from_numpy(cond), conditioning_scale=scale)
    assert len(down_t) == len(down_j) == 4
    for got, want in zip(down_t, down_j):
        assert float(np.abs(np.asarray(want)).max()) > 0.1  # not a no-op
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(mid_t), np.asarray(mid_j), **TOL)


def test_conditioning_embedding_matches_jax(nets):
    from vidtome_tpu.models.controlnet import \
        ControlNetConditioningEmbedding

    _, params, port, _, _ = nets
    cond = _inputs()[2]
    want = ControlNetConditioningEmbedding(32, dtype=jnp.float32).apply(
        {"params": params["cond_embedding"]}, jnp.asarray(cond))
    with torch.no_grad():
        got = port.controlnet_cond_embedding(torch.from_numpy(cond))
    assert got.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _unet_pair(jb, tb, x, ctx, down_j, mid_j, down_t, mid_t, shallow):
    unet = UNet2DConditionModel(config=TINY_UNET, dtype=jnp.float32,
                                use_pallas=False)
    v = {"params": jb.unet_params}
    args = (jnp.asarray(x), jnp.asarray(T), jnp.asarray(ctx))
    targs = (torch.from_numpy(x), T, torch.from_numpy(ctx))
    if not shallow:
        want = unet.apply(v, *args, down_residuals=down_j,
                          mid_residual=mid_j)
        with torch.no_grad():
            got = tb.unet(*targs, down_residuals=down_t, mid_residual=mid_t)
        return got, want
    # the deep cache of a full call at the same t (no residuals), then the
    # shallow call with the level-0 residuals
    _, deep_j = unet.apply(v, *args, cache_mode="full")
    want = unet.apply(v, *args, cache_mode="shallow", deep_cache=deep_j,
                      down_residuals=down_j, mid_residual=mid_j)
    with torch.no_grad():
        _, deep_t = tb.unet(*targs, cache_mode="full")
        got = tb.unet(*targs, cache_mode="shallow", deep_cache=deep_t,
                      down_residuals=down_t, mid_residual=mid_t)
    return got, want


@pytest.mark.parametrize("shallow", [False, True])
def test_unet_with_residuals_matches_jax(nets, shallow):
    model, params, port, jb, tb = nets
    x, ctx, cond = _inputs(1)
    down_j, mid_j = model.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(T), jnp.asarray(ctx),
                                jnp.asarray(cond), conditioning_scale=0.7)
    with torch.no_grad():
        down_t, mid_t = port(torch.from_numpy(x), T, torch.from_numpy(ctx),
                             torch.from_numpy(cond), conditioning_scale=0.7)
    got, want = _unet_pair(jb, tb, x, ctx, down_j, mid_j, down_t, mid_t,
                           shallow)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # the residuals reach the output
    with torch.no_grad():
        if shallow:
            _, deep_t = tb.unet(torch.from_numpy(x), T,
                                torch.from_numpy(ctx), cache_mode="full")
            bare = tb.unet(torch.from_numpy(x), T, torch.from_numpy(ctx),
                           cache_mode="shallow", deep_cache=deep_t)
        else:
            bare = tb.unet(torch.from_numpy(x), T, torch.from_numpy(ctx))
    assert float((bare - got).abs().max()) > 1e-2


def test_unet_refuses_a_wrong_residual_count(nets):
    _, _, port, _, tb = nets
    x, ctx, cond = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        down, mid = port(x, T, ctx, cond)
        with pytest.raises(ValueError, match="down residuals"):
            tb.unet(x, T, ctx, down_residuals=down[:-1], mid_residual=mid)


def _diffusers_controlnet_state():
    """A diffusers-named tiny ControlNet state dict: the golden tiny UNet's
    encoder and mid block, the hint encoder and the zero convs."""
    from tests import test_convert_golden as golden

    unet = golden.build_tiny_unet_state()
    s = golden.State({k: v for k, v in unet.items()
                      if not k.startswith(("up_blocks", "conv_norm_out",
                                           "conv_out"))})
    chans = (16, 32, 96, 256)
    s.conv("controlnet_cond_embedding.conv_in", 3, chans[0])
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        s.conv(f"controlnet_cond_embedding.blocks.{2 * i}", a, a)
        s.conv(f"controlnet_cond_embedding.blocks.{2 * i + 1}", a, b)
    s.conv("controlnet_cond_embedding.conv_out", chans[-1], 32)
    for i, c in enumerate((32, 32, 32, 64)):
        s.conv(f"controlnet_down_blocks.{i}", c, c, k=1)
    s.conv("controlnet_mid_block", 64, 64, k=1)
    return s


def test_diffusers_state_loads_strictly():
    """A diffusers ControlNet state dict: from_diffusers loads it into the
    port with strict=True, and equals the JAX converter's tree carried back
    by from_jax_params."""
    from vidtome_tpu.models import convert as j_convert

    state = _diffusers_controlnet_state()
    direct = t_convert.from_diffusers(state, "controlnet")
    via_jax = t_convert.from_jax_params(
        j_convert.convert_controlnet(dict(state)), "controlnet")
    assert sorted(via_jax) == sorted(direct)
    for k in direct:
        np.testing.assert_array_equal(via_jax[k].numpy(), direct[k].numpy(),
                                      err_msg=k)
    port = TControlNet(T_TINY)
    port.load_state_dict(direct, strict=True)
    np.testing.assert_array_equal(
        port.controlnet_cond_embedding.blocks[3].weight.detach().numpy(),
        state["controlnet_cond_embedding.blocks.3.weight"])


def test_controlnet_checkpoint_dir_loads(tmp_path, capsys):
    """init_model(control=...) loads <controlnet_root>/<name> safetensors."""
    from safetensors.numpy import save_file

    state = _diffusers_controlnet_state()
    cn_dir = tmp_path / "control_v11p_sd15_canny"
    cn_dir.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              str(cn_dir / "diffusion_pytorch_model.safetensors"))
    b = init_model("tiny", weight_dtype="fp32", device="cpu",
                   control="canny", controlnet_root=str(tmp_path))
    assert "loading controlnet from" in capsys.readouterr().out
    np.testing.assert_array_equal(
        b.controlnet.controlnet_mid_block.weight.detach().numpy(),
        state["controlnet_mid_block.weight"])


def _jax_quantized(qp, prefix=""):
    out = []
    for k, v in qp.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "kernel_q" in v:
            out.append(path)
        elif isinstance(v, dict):
            out += _jax_quantized(v, path)
    return out


def test_int8_table_matches_jax_policy(nets):
    """quantize_unet under CONTROLNET_EXCLUDE holds the modules, int8
    weights and scales of JAX quantize_params under DEFAULT_EXCLUDE +
    "|zero_conv|cond_embedding", carried by from_jax_qparams."""
    _, params, port, _, _ = nets
    _, qp = jq.quantize_params(
        params, exclude=jq.DEFAULT_EXCLUDE + r"|zero_conv|cond_embedding")
    qp = jax.tree.map(np.asarray, jax.device_get(qp))
    carried = t_convert.from_jax_qparams(qp, port, "controlnet")
    own = tq.quantize_unet(port, exclude=tq.CONTROLNET_EXCLUDE)
    assert sorted(carried.entries) == sorted(own.entries)
    assert len(own) == jq.count_quantized(qp) == len(_jax_quantized(qp))
    assert not any(n.startswith(("controlnet_", "conv_in", "time_embedding"))
                   for n in own.entries)
    assert any(n.endswith("conv1") for n in own.entries)
    for name, e in own.entries.items():
        c = carried.entries[name]
        assert torch.equal(c.weight, e.weight), name
        torch.testing.assert_close(c.scale, e.scale, rtol=1e-6, atol=0)
        assert (c.act_scale is None) == (e.act_scale is None), name
        if e.act_scale is not None:
            torch.testing.assert_close(c.act_scale, e.act_scale, rtol=1e-6,
                                       atol=0)


def test_int8_controlnet_call_matches_jax(nets):
    """One int8 ControlNet call (JAX's table on both sides) against JAX, to
    TOL; the table moves the deeper residuals by 2-5% of their max."""
    model, params, port, _, _ = nets
    res, qp = jq.quantize_params(
        params, exclude=jq.DEFAULT_EXCLUDE + r"|zero_conv|cond_embedding")
    x, ctx, cond = _inputs(2)
    down_j, mid_j = model.apply({"params": res, "qparams": qp},
                                jnp.asarray(x), jnp.asarray(T),
                                jnp.asarray(ctx), jnp.asarray(cond),
                                conditioning_scale=0.7)
    qt = t_convert.from_jax_qparams(jax.tree.map(np.asarray, qp), port,
                                    "controlnet")
    with torch.no_grad():
        down_t, mid_t = port(torch.from_numpy(x), T, torch.from_numpy(ctx),
                             torch.from_numpy(cond), conditioning_scale=0.7,
                             qt=qt)
        down_f, _ = port(torch.from_numpy(x), T, torch.from_numpy(ctx),
                         torch.from_numpy(cond), conditioning_scale=0.7)
    for got, want in zip(down_t + [mid_t], list(down_j) + [mid_j]):
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # the int8 table changes the residuals the deeper levels produce
    assert float((down_f[-1] - down_t[-1]).abs().max()) > 1e-3


def test_random_controlnet_is_a_no_op():
    """Without a checkpoint the ControlNet starts with its zero convs and
    the hint encoder's conv_out at zero (as the JAX package): every
    residual is exactly zero, so the UNet's output is unchanged."""
    b = init_model("tiny", weight_dtype="fp32", device="cpu", control="canny")
    x, ctx, cond = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        down, mid = b.controlnet(x, T, ctx, cond)
        assert all(torch.count_nonzero(r) == 0 for r in down + [mid])
        assert torch.equal(b.unet(x, T, ctx, down_residuals=down,
                                  mid_residual=mid), b.unet(x, T, ctx))
    zeroed = list(b.controlnet.zero_init_modules())
    assert len(zeroed) == 1 + 4 + 1
    assert all(torch.count_nonzero(m.weight) == 0 for m in zeroed)
    assert torch.count_nonzero(b.controlnet.conv_in.weight) > 0


def test_controlnet_follows_the_bundle_dtype():
    b = init_model("tiny", weight_dtype="bf16", device="cpu", control="tile")
    assert b.controlnet.conv_in.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="control type"):
        init_model("tiny", device="cpu", control="sketch")
    assert init_model("tiny", device="cpu", control="pnp").controlnet is None
