"""The port's int8 (W8A8) quantization against the JAX package's, on the CPU.

``vidtome_torch.ops.quant`` restates ``vidtome_tpu.ops.quant`` with the
output channel first (dense [N, K], conv OIHW).  Same weights and inputs
(numpy, seeded) go through both:

* per-channel int8 weights are bit-equal, their scales within rtol 1e-6;
* quantized activations (dynamic per row / per sample, and static) differ
  in at most 0.1% of their entries, by one step at most (fp32 division in
  two libraries), and the int8 products agree to 1e-5 of max |ref|;
* the static post-norm scale is equal;
* the layers the policy quantizes are the same, under the module-name map,
  in the tiny UNet and in the SD1.5 topology (SD1.5's blocks, layers and
  names at narrow widths: the names do not depend on the widths), and
  ``from_jax_qparams`` carries the JAX tables into the port's.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import port_bundle_from_jax
from vidtome_torch.models import convert
from vidtome_torch.models import unet as t_unet
from vidtome_torch.ops import quant as tq
from vidtome_tpu.models import unet as j_unet
from vidtome_tpu.ops import quant as jq

torch.set_num_threads(2)

_RULES = convert._UNET_RULES


def _port_name(jax_path: str) -> str:
    """A JAX module path (``down_0_attentions_0/.../to_q``) -> the port's
    module name, by the converter's map."""
    path = jax_path + "/"
    for pattern, repl in _RULES:
        path = re.sub(pattern, repl, path)
    return path.rstrip("/").replace("/", ".")


def _jax_quantized(qtree, prefix="") -> list[str]:
    names = []
    for k, v in qtree.items():
        path = f"{prefix}/{k}" if prefix else k
        if "kernel_q" in v:
            names.append(path)
        else:
            names.extend(_jax_quantized(v, path))
    return names


@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 40, 32), (1, 1, 32, 64)])
def test_quantize_weight_is_bit_equal(shape):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel takes the 1e-8 floor
    jw, js = jq.quantize_weight(jnp.asarray(w))
    port_w = w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)
    tw, ts = tq.quantize_weight(torch.from_numpy(np.ascontiguousarray(port_w)))
    want = np.asarray(jw)
    want = want.T if w.ndim == 2 else want.transpose(3, 2, 0, 1)
    assert tw.dtype == torch.int8
    np.testing.assert_array_equal(tw.numpy(), want)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


def _close_acts(got: torch.Tensor, want) -> None:
    diff = np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("static", [False, True])
def test_int8_dense_matches_jax(static):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 40, 64)) * 1.5).astype(np.float32)
    w = (rng.normal(size=(64, 96)) * 0.1).astype(np.float32)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    act = 0.05 if static else None
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jw, js, jnp.float32,
                                    None if act is None else jnp.float32(act)))
    got = tq.int8_dense(torch.from_numpy(x), tw, ts, torch.float32,
                        None if act is None else torch.tensor(act))
    assert got.shape == (2, 40, 96) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if not static:
        jqa, jsa = jq.quantize_acts(jnp.asarray(x), axes=(2,))
        tqa, tsa = tq.quantize_acts(torch.from_numpy(x), dims=(2,))
        _close_acts(tqa, jqa)
        np.testing.assert_allclose(tsa.numpy(), np.asarray(jsa), rtol=1e-6)


@pytest.mark.parametrize("k,stride,static", [
    (3, 1, False), (3, 1, True), (1, 1, True), (3, 2, False)])
def test_int8_conv_matches_jax(k, stride, static):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(k, k, 32, 40)) * 0.1).astype(np.float32)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    act = 0.04 if static else None
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    want = np.asarray(jq.int8_conv(
        jnp.asarray(x), jw, js, (stride, stride), pad, jnp.float32,
        None if act is None else jnp.float32(act)))
    got = tq.int8_conv(torch.from_numpy(x), tw, ts, torch.float32,
                       None if act is None else torch.tensor(act), stride)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if not static:
        jqa, _ = jq.quantize_acts(jnp.asarray(x), axes=(1, 2, 3))
        tqa, _ = tq.quantize_acts(torch.from_numpy(x), dims=(1, 2, 3))
        _close_acts(tqa, jqa)


def test_int8_products_refuse_small_or_ragged_shapes():
    w = torch.zeros(16, 24, dtype=torch.int8)
    s = torch.ones(16)
    with pytest.raises(ValueError, match="16 rows"):
        tq.int8_dense(torch.ones(16, 24), w, s, torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_dense(torch.ones(32, 20), w[:, :20], s, torch.float32)


def test_static_act_scale_matches_jax():
    rng = np.random.default_rng(3)
    g = (rng.normal(size=320) * 0.2 + 1).astype(np.float32)
    b = (rng.normal(size=320) * 0.1).astype(np.float32)
    want = np.asarray(jq.static_act_scale(jnp.asarray(g), jnp.asarray(b)))
    got = tq.static_act_scale(torch.from_numpy(g), torch.from_numpy(b))
    assert got.item() == pytest.approx(float(want), rel=1e-7)
    tiny = tq.static_act_scale(torch.zeros(8), torch.zeros(8))  # the floor
    assert tiny.item() == pytest.approx(0.3 / 127, rel=1e-7)


_NARROW = dict(block_out_channels=(32, 32, 64, 64), cross_attention_dim=32,
               num_heads=2)


@pytest.mark.parametrize("topology", ["tiny", "sd15"])
def test_policy_quantizes_the_same_layers(topology):
    """quantize_unet's layer set is quantize_params's under the name map."""
    if topology == "tiny":
        jcfg, tcfg = j_unet.TINY_UNET, t_unet.TINY_UNET
    else:
        jcfg = dataclasses.replace(j_unet.SD15_UNET, **_NARROW)
        tcfg = dataclasses.replace(t_unet.SD15_UNET, **_NARROW)
    model = j_unet.UNet2DConditionModel(config=jcfg, dtype=jnp.float32)
    params = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.asarray(0),
        jnp.zeros((1, 8, jcfg.cross_attention_dim)))["params"],
        jax.random.key(0))
    _, qp = jax.eval_shape(jq.quantize_params, params)
    want = sorted(_port_name(p) for p in _jax_quantized(qp))
    with torch.device("meta"):
        port = t_unet.UNet2DConditionModel(tcfg)
    got = sorted(tq.quantizable(port))
    assert got == want
    assert jq.count_quantized(qp) == len(got)
    # what the policy leaves in the serving dtype, in the port's names
    kept = {n for n, m in port.named_modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))} - set(got)
    assert {"conv_in", "conv_out", "time_embedding.linear_1"} <= kept
    assert any(n.endswith("ff.net.2") for n in kept)
    assert not any(n.endswith(("conv1", "conv2", "to_q", "proj_in"))
                   for n in kept)
    statics = {n for n in got if n.endswith(("conv1", "conv2", "proj_in"))}
    jax_statics = set()
    for p in _jax_quantized(qp):
        node = qp
        for k in p.split("/"):
            node = node[k]
        if "act_scale" in node:
            jax_statics.add(_port_name(p))
    assert jax_statics == statics


def test_from_jax_qparams_matches_quantize_unet():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    tb = port_bundle_from_jax(jb)
    _, qp = jq.quantize_params(jb.unet_params)
    qp = jax.tree.map(np.asarray, jax.device_get(qp))
    carried = convert.from_jax_qparams(qp, tb.unet)
    own = tq.quantize_unet(tb.unet)
    assert sorted(carried.entries) == sorted(own.entries)
    assert tq.count_quantized(own) == jq.count_quantized(qp)
    for name, e in own.entries.items():
        c = carried.entries[name]
        assert torch.equal(c.weight, e.weight), name
        assert c.weight.stride() == e.weight.stride(), name  # packed alike
        torch.testing.assert_close(c.scale, e.scale, rtol=1e-6, atol=0)
        assert (c.act_scale is None) == (e.act_scale is None), name
        if e.act_scale is not None:
            torch.testing.assert_close(c.act_scale, e.act_scale, rtol=1e-6,
                                       atol=0)
    module = tb.unet.get_submodule(next(iter(own.entries)))
    assert own.get(module) is own.entries[next(iter(own.entries))]
    assert module.weight.dtype == torch.float32  # the weights stay
